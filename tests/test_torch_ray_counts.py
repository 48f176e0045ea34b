"""The raytraced kernel's draws and traces (``zoic.raytraced.draws``,
``zoic.raytraced.traces``) on the CPU, where the entries run the plain
version.

``raytraced_plain`` adds to a ``counts`` buffer the aperture draws the
rays made and those that went on to the element trace.  Here they are
held to a count made ray by ray from the same hash draws and the same
bound, on the fisheye (the harmonic pre-check, lerped per key); without
the pre-check every draw is traced.  The entries hand the plain version
the profiler's totals only while a profiler records
(``utils.profiling.counter_totals``), and ``take_counters`` reads and
resets them.  The card holds the kernel to these counts
(``tests/test_torch_raytraced_fold_cuda.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import trace_kernel as tk
from zoic_tpu_torch.utils import profiling
from _torch_threads import one_thread  # noqa: F401

SEED = 2718
MAX_TRIES = 25
N = 2_000


@pytest.fixture(scope="module")
def fisheye():
    cam = zpt.data.CAMERAS["raytraced_fisheye"]
    st = zpt.load_state(zpt.data.state_path(cam.file), device="cpu")
    rng = np.random.default_rng(11)
    cols = [rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
            rng.uniform(0, 1, N), rng.uniform(0, 1, N)]
    return st, [torch.from_numpy(c.astype(np.float32)) for c in cols]


def _plain_counts(st, args, use_profile):
    counts = torch.zeros(2, dtype=torch.int64)
    out = tk.raytraced_plain(st.lens, *args, st.sensor_width, SEED,
                             max_tries=MAX_TRIES, use_profile=use_profile,
                             counts=counts)
    return out, counts.tolist()


def _per_ray(st, args, tries, use_profile):
    """Draws and traces counted ray by ray: a live ray draws the caller's
    sample and then one hash draw a try it consumed, keyed by (ray, seed,
    try); a draw that passes the bound is traced; a dead key draws
    nothing."""
    sx, sy, u1, u2 = args
    v = tk.variant(st.lens, True, use_profile, False)
    _, table, prof, scal = tk._prepare(st.lens, st.sensor_width, SEED, N, v)
    *_, spacing, _, half, inv_dmax = scal.tolist()
    *_, pcs = tk._shaping(sx * half, sy * half, table, spacing,
                          prof.tolist(), inv_dmax, v)

    def passes(lx, ly):
        if not use_profile:
            return torch.ones_like(lx, dtype=torch.bool)
        return tk._bound_pass(lx, ly, pcs, v.circles)

    dead = (tk._bound_dead(pcs, v.circles) if use_profile
            else torch.zeros(N, dtype=torch.bool))
    live = ~dead
    tries = tries.to(torch.int64)
    draws = torch.where(live, tries + 1, 0)
    traces = (live & passes(*tk.concentric(u1, u2))).to(torch.int64)
    ids = torch.arange(N, dtype=torch.int64)
    for c in range(int(tries.max()) + 1):
        ctr = torch.full((N,), c, dtype=torch.int32)
        lx, ly = tk.concentric(tk.hash_uniform(ids, SEED, ctr, tk.SALT_U1),
                               tk.hash_uniform(ids, SEED, ctr, tk.SALT_U2))
        traces += (live & (c < tries) & passes(lx, ly)).to(torch.int64)
    return int(draws.sum()), int(traces.sum()), int(dead.sum())


def test_plain_counts_equal_a_count_ray_by_ray(fisheye):
    st, args = fisheye
    (_, _, tries, _), (draws, traces) = _plain_counts(st, args, True)
    want_draws, want_traces, dead = _per_ray(st, args, tries, True)
    assert (draws, traces) == (want_draws, want_traces)
    # the fisheye's film has dead keys, and its bound rejects draws
    assert 0 < dead < N and traces < draws
    assert traces >= int((tries <= MAX_TRIES).sum())


def test_without_the_precheck_every_draw_is_traced(fisheye):
    st, args = fisheye
    (_, _, tries, _), (draws, traces) = _plain_counts(st, args, False)
    assert draws == traces == int(tries.sum()) + N
    assert (draws, traces) == _per_ray(st, args, tries, False)[:2]


def test_counted_only_while_a_profiler_records(fisheye):
    st, args = fisheye
    n = 256
    part = [a[:n] for a in args]
    call = dict(max_tries=MAX_TRIES)
    profiling.take_counters()
    tk.raytraced_rays(st.lens, *part, st.sensor_width, SEED,
                      st.exposure_control, **call)
    assert profiling.counter_totals("cpu") is None
    assert set(profiling.take_counters().values()) == {0}
    want = torch.zeros(2, dtype=torch.int64)
    tk.raytraced_rays_plain(st.lens, *part, st.sensor_width, SEED,
                            st.exposure_control, counts=want, **call)
    with profile(activities=[ProfilerActivity.CPU]):
        tk.raytraced_rays(st.lens, *part, st.sensor_width, SEED,
                          st.exposure_control, **call)
        tk.raytraced_fused(st.lens, *part, st.sensor_width, SEED, **call)
    got = profiling.take_counters()
    assert [got[k] for k in profiling.COUNTERS] == (2 * want).tolist()
    assert want[0] > 0 and set(profiling.take_counters().values()) == {0}
