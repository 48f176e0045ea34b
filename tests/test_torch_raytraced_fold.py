"""The raytraced model's finished rays in one launch
(``zoic_tpu_torch.ops.trace_kernel.raytraced_rays``), on the CPU.

On CPU tensors the entry runs its plain version, ``raytraced_plain`` and
then ``epilogue_plain``; the card runs ``csrc/raytraced.cu`` writing the
finished rays (``tests/test_torch_raytraced_fold_cuda.py``).  Here: the
plain route against the plain composition bit for bit (signed zeros
included), the argument checks, ``create_rays`` on a raytraced camera
against the camera kernel and the epilogue called in turn as the model
called them before, the library's argument list against the source, and
the kernel's store of a dead tile written out.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import _build
from zoic_tpu_torch.ops import epilogue_kernel as ek
from zoic_tpu_torch.ops import trace_kernel as tk
from _torch_threads import one_thread  # noqa: F401

SEED = 4321
CAMERAS = ("headline", "raytraced_petzval_f1.25_focus1000")
FIELDS = ("origin", "dir", "weight", "d_ody", "d_ddy", "stats")


def _state(name):
    cam = zpt.data.CAMERAS[name]
    return zpt.load_state(zpt.data.state_path(cam.file), device="cpu")


def _args(n, seed=3):
    rng = np.random.default_rng(seed + n)
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(0, 1, n), rng.uniform(0, 1, n)]
    return [torch.from_numpy(c.astype(np.float32)) for c in cols]


def _bits_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.parametrize("max_tries", [0, 25])
@pytest.mark.parametrize("exposure", [-0.5, 0.0, 1.5])
@pytest.mark.parametrize("camera", CAMERAS)
def test_plain_route_equals_the_plain_composition(camera, exposure,
                                                  max_tries):
    """CPU tensors: every output of the entry bit-equal to
    ``raytraced_plain`` then ``epilogue_plain`` (with tir), and no launch
    counted; rays that never traced keep -0.0 and their derivatives the
    sign that their tries give."""
    st = _state(camera)
    n = 16 * 128 + 77
    args = _args(n)
    ex = torch.tensor(exposure, dtype=torch.float32)
    before = tk.raytraced_rays_launches, tk.launches
    got = tk.raytraced_rays(st.lens, *args, st.sensor_width, SEED, ex,
                            max_tries=max_tries)
    assert (tk.raytraced_rays_launches, tk.launches) == before
    origin, direction, tries, tir = tk.raytraced_plain(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    want = (origin, direction) + ek.epilogue_plain(
        tries, tir, origin, direction, ex, max_tries)
    for name, g, w in zip(FIELDS, got, want):
        assert _bits_equal(g, w), name
    stats = got[5]
    assert int(stats[0]) + int(stats[1]) == n
    assert int(stats[2]) == int(tir.sum())
    assert int(stats[3]) == int(tries.sum())
    # a ray that never traced: a -0.0 payload, and derivatives of the
    # payload's sign where it was retried (every such ray here)
    never = (origin == 0).all(1) & (direction == 0).all(1)
    assert bool(never.any()) == (camera != "headline" or max_tries == 0)
    assert bool((tries[never] > 0).all())
    for out in (got[0], got[1], got[3], got[4]):
        assert bool(torch.signbit(out[never]).all())


CHECKS = {
    "exposure-1d": (lambda e: e.reshape(1),
                    r"exposure must be 0-d, got \(1,\)"),
    "exposure-2": (lambda e: torch.zeros(2),
                   r"exposure must be 0-d, got \(2,\)"),
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_exposure_must_be_0d(case):
    """The entry holds the exposure to a 0-d tensor on every device, so a
    CPU run refuses what a launch would."""
    change, message = CHECKS[case]
    st = _state("headline")
    args = _args(64)
    ex = torch.tensor(0.0)
    assert len(tk.raytraced_rays(st.lens, *args, st.sensor_width, SEED, ex,
                                 max_tries=3)) == 6
    with pytest.raises(ValueError, match=message):
        tk.raytraced_rays(st.lens, *args, st.sensor_width, SEED, change(ex),
                          max_tries=3)


@pytest.mark.parametrize("camera", ["headline", "raytraced_bokeh_image"])
def test_create_rays_on_a_raytraced_camera_as_before(camera):
    """``create_rays`` on a raytraced camera (the image-bokeh one with its
    retry planes) gives the rays and the counters that the camera kernel
    and the epilogue gave in turn, each through its plain version, on the
    inputs the model makes."""
    cam = zpt.data.CAMERAS[camera]
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED, lens_data_path=cam.lens,
        max_tries=4, bokeh_path="disk64.npy" if cam.use_image else "",
        **cam.config_kwargs())
    st = dataclasses.replace(
        _state(camera),
        exposure_control=torch.tensor(0.75, dtype=torch.float32))
    sx, sy, lx, ly = _args(1_501, seed=5)
    rays, stats = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=77)
    u1, u2, flags = rt_model.kernel_inputs(st, cfg, lx, ly, 77)
    origin, direction, tries, tir = tk.raytraced_plain(
        st.lens, sx, sy, u1, u2, st.sensor_width, 77, **flags)
    want = (origin, direction) + ek.epilogue_plain(
        tries, tir, origin, direction, st.exposure_control, cfg.max_tries)
    for name, w in zip(FIELDS[:5], want):
        assert _bits_equal(getattr(rays, name), w), name
    assert [int(getattr(stats, f)) for f in (
        "success", "vignetted", "tir", "tries_total")] == want[5].tolist()


def test_launch_arguments_agree_with_the_source():
    """The wrapper's argument types match ``zoic_raytraced_launch``'s
    parameters, pointer for pointer and int for int."""
    with open(os.path.join(_build.CSRC, "raytraced.cu")) as f:
        src = f.read()
    sig = re.search(r'extern "C" int zoic_raytraced_launch\((.*?)\)\s*\{',
                    src, re.S).group(1)
    kinds = ["p" if "*" in a else "i" for a in sig.split(",")]
    want = ["p" if t is tk.ctypes.c_void_p else "i"
            for t in tk._RAYTRACED_ARGTYPES]
    assert kinds == want


def _dead_tile_store(t):
    """The kernel's store of dead tile ``t`` written out: lane ``l`` stores
    float4 ``u = l + 32 q`` (q = 0..3, u < 104) of the tile's 104, the 24
    float4 of origin, dir, dOdy and dDdy in turn and then the weight's 8.
    Returns ``{output: [float4 offsets]}``."""
    out = {k: [] for k in ("origin", "dir", "d_ody", "d_ddy", "weight")}
    names = ("origin", "dir", "d_ody", "d_ddy")
    for q in range(4):
        for lane in range(32):
            u = 32 * q + lane
            if u < 96:
                a = u // 24
                out[names[a]].append(24 * t + (u - 24 * a))
            elif u < 104:
                out["weight"].append(8 * t + (u - 96))
    return out


@pytest.mark.parametrize("t", [0, 1, 583_199])
def test_dead_tile_store_written_out(t):
    """Every float of the tile's 32 rays in each output is stored once:
    96 floats of each [B, 3] output and 32 of the weight, at the tile's
    own rays."""
    stored = _dead_tile_store(t)
    for name, offs in stored.items():
        floats = sorted(4 * o + k for o in offs for k in range(4))
        width = 1 if name == "weight" else 3
        first = 32 * width * t
        assert floats == list(range(first, first + 32 * width)), name


def _tile_derivatives(dead):
    """The tile pass's store of a whole tile's derivatives written out:
    lane ``l < 24`` stores float4 ``l`` of the tile's 24 of each
    derivative, its float ``k`` -0.0 where the float's ray ``(4l + k) //
    3`` is dead (its bit of the tile's ballot), else 0.  Returns the
    ``[32, 3]`` floats."""
    ballot = sum(1 << r for r in range(32) if bool(dead[r]))
    out = torch.full((96,), float("nan"))
    for lane in range(24):
        for k in range(4):
            r = (4 * lane + k) // 3
            out[4 * lane + k] = -0.0 if (ballot >> r) & 1 else 0.0
    return out.reshape(32, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_derivatives_written_out(seed):
    """Every derivative float of the tile is stored once, zero, with the
    sign of its own ray: -0.0 for a dead ray (retried, no payload), +0.0
    for a live one until a trace of a retried ray overwrites it."""
    g = torch.Generator().manual_seed(seed)
    dead = torch.rand(32, generator=g) < 0.5
    d = _tile_derivatives(dead)
    assert not bool(d.isnan().any()) and bool((d == 0).all())
    assert torch.equal(torch.signbit(d), dead[:, None].expand(32, 3))
