"""The thin lens's whole kernel path in one launch
(``zoic_tpu_torch.ops.trace_kernel.thinlens_rays``), on the CPU.

On CPU tensors the entry runs its plain version, ``thinlens_plain`` and
then ``epilogue_plain``; the card runs ``csrc/thinlens.cu``
(``tests/test_torch_thinlens_fold_cuda.py``).
Here: the plain route against the plain composition bit for bit, the
argument checks, ``create_rays`` on a thin lens against the camera kernel
and the epilogue called in turn as the model called them before, the
grid's size, and the kernel's tile store written out.
"""

import os
import re

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.models import thinlens as thin_model
from zoic_tpu_torch.ops import _build
from zoic_tpu_torch.ops import epilogue_kernel as ek
from zoic_tpu_torch.ops import trace_kernel as tk
from _torch_threads import one_thread  # noqa: F401

SEED = 4321
SCALARS = (0.36, 1.7857143, 100.0, 6.0, 0.35)  # strong vignetting
BRANCHES = {
    "pinhole": dict(use_dof=False, has_ov=False),
    "dof": dict(use_dof=True, has_ov=False),
    "dof-vignette": dict(use_dof=True, has_ov=True),
    "dof-bokeh": dict(use_dof=True, has_ov=False, presampled=True),
    "dof-bokeh-vignette": dict(use_dof=True, has_ov=True, presampled=True),
}
FIELDS = ("origin", "dir", "weight", "d_ody", "d_ddy", "stats")


def _args(n, presampled, seed=3):
    rng = np.random.default_rng(seed + n)
    lo = -1.0 if presampled else 0.0
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(lo, 1, n), rng.uniform(lo, 1, n)]
    return [torch.from_numpy(c.astype(np.float32)) for c in cols]


def _planes(flags, bp, seed=9):
    if not (flags.get("presampled") and flags["has_ov"]):
        return {}
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(-1, 1, (4, bp)).astype(
        np.float32)) for k in ("retry_u1", "retry_u2")}


def _bits_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.parametrize("max_tries", [0, 6])
@pytest.mark.parametrize("exposure", [-0.5, 0.0, 1.5])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_route_equals_the_plain_composition(branch, exposure,
                                                  max_tries):
    """CPU tensors: every output of the entry bit-equal to
    ``thinlens_plain`` then ``epilogue_plain`` (no tir, the weight counted
    with depth of field), and no launch counted."""
    flags = dict(BRANCHES[branch], max_tries=max_tries)
    n = 16 * 128 + 77
    args = _args(n, flags.get("presampled", False))
    planes = _planes(flags, 512)
    ex = torch.tensor(exposure, dtype=torch.float32)
    before = tk.thinlens_rays_launches
    got = tk.thinlens_rays(*args, *SCALARS, SEED, ex, **flags, **planes)
    assert tk.thinlens_rays_launches == before
    origin, direction, tries = tk.thinlens_plain(*args, *SCALARS, SEED,
                                                 **flags, **planes)
    want = (origin, direction) + ek.epilogue_plain(
        tries, None, origin, direction, ex, max_tries,
        count_weight=flags["use_dof"])
    for name, g, w in zip(FIELDS, got, want):
        assert _bits_equal(g, w), name
    stats = got[5]
    assert int(stats[2]) == 0 and int(stats[3]) == int(tries.sum())
    if flags["use_dof"]:
        assert int(stats[0]) + int(stats[1]) == n
    else:
        assert int(stats[0]) == int(stats[1]) == 0


CHECKS = {
    "non-contiguous": (
        lambda a, e: ([a[0], torch.zeros(2 * a[1].shape[0])[::2], *a[2:]], e),
        r"sy must be contiguous"),
    "dtype": (lambda a, e: ([a[0], a[1], a[2].double(), a[3]], e),
              r"u1 must be float32 of shape"),
    "shape": (lambda a, e: ([*a[:3], a[3][:-1].clone()], e),
              r"u2 must be float32 of shape"),
    "exposure-1d": (lambda a, e: (a, e.reshape(1)),
                    r"exposure must be 0-d, got \(1,\)"),
    "exposure-2": (lambda a, e: (a, torch.zeros(2)),
                   r"exposure must be 0-d, got \(2,\)"),
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_argument_checks_raise(case):
    """The entry holds its inputs to the kernel's rules on every device,
    so a CPU run refuses what a launch would."""
    change, message = CHECKS[case]
    args = _args(64, False)
    ex = torch.tensor(0.0)
    assert len(tk.thinlens_rays(*args, *SCALARS, SEED, ex, use_dof=True,
                                has_ov=True, max_tries=3)) == 6
    bad, bad_ex = change(args, ex)
    with pytest.raises(ValueError, match=message):
        tk.thinlens_rays(*bad, *SCALARS, SEED, bad_ex, use_dof=True,
                         has_ov=True, max_tries=3)


def _disk(path, n=32):
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    np.save(path, np.stack([img, img, img], -1))
    return str(path)


CAMERAS = {
    "pinhole": dict(use_dof=False, exposure_control=0.5),
    "dof": dict(use_dof=True, exposure_control=-1.25),
    "dof-vignette": dict(use_dof=True, optical_vignetting_distance=4.0,
                         optical_vignetting_radius=0.6, max_tries=3),
    "bokeh-vignette": dict(use_dof=True, use_image=True,
                           optical_vignetting_distance=1.0,
                           optical_vignetting_radius=1.0, max_tries=4,
                           exposure_control=2.0),
}


def _before(state, cfg, sx, sy, lx, ly, seed):
    """The model's kernel path as it was: the camera kernel, then the
    epilogue, each through its plain version, on the inputs the model
    makes."""
    has_ov = cfg.optical_vignetting_distance > 0.0
    planes = {}
    if cfg.use_image:
        lx, ly = zpt.bokeh.sample(state.bokeh, lx, ly)
        if has_ov and cfg.max_tries > 0 and cfg.use_dof:
            ru1, ru2 = thin_model.retry_planes(
                state, cfg, sx.shape[0], torch.Generator().manual_seed(seed))
            planes = dict(retry_u1=ru1, retry_u2=ru2)
    origin, direction, tries = tk.thinlens_plain(
        sx, sy, lx, ly, state.tan_fov, state.aperture_radius,
        state.focal_distance, state.ov_distance, state.ov_radius, seed,
        use_dof=cfg.use_dof, has_ov=has_ov, max_tries=cfg.max_tries,
        presampled=bool(cfg.use_image), **planes)
    return (origin, direction) + ek.epilogue_plain(
        tries, None, origin, direction, state.exposure_control,
        cfg.max_tries, count_weight=cfg.use_dof)


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_create_rays_on_a_thin_lens_as_before(camera, tmp_path):
    """``Camera.create_rays`` on a thin lens gives the rays and the
    counters that the camera kernel and the epilogue gave in turn."""
    kw = dict(CAMERAS[camera])
    if kw.get("use_image"):
        kw["bokeh_path"] = _disk(tmp_path / "disk.npy")
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS,
                           focal_length=5.0, fstop=1.4, focal_distance=100.0,
                           **kw)
    cam = zpt.Camera(cfg, "cpu")
    sx, sy, lx, ly = _args(3_001, False, seed=cfg.max_tries)
    rays, stats = cam.create_rays(sx, sy, lx, ly, seed=77)
    want = _before(cam.state, cfg, sx, sy, lx, ly, 77)
    for name, w in zip(FIELDS[:5], want):
        assert _bits_equal(getattr(rays, name), w), name
    assert [int(getattr(stats, f)) for f in (
        "success", "vignetted", "tir", "tries_total")] == want[5].tolist()


@pytest.mark.parametrize("b", [0, 1, 1_023, 1_024, 1_025, 135_167, 135_168,
                               135_169, 18_662_400])
@pytest.mark.parametrize("per_sm", [1, 6, 8])
def test_thinlens_grid_fits_the_work(b, per_sm):
    """At least one block, never more than the card holds at once, and
    never a block whose first warp has no tile of rays to start on."""
    sms = 132
    step = tk.THINLENS_BLOCK // 32 * tk.THINLENS_TILE
    grid = tk.thinlens_grid(b, sms, per_sm)
    assert 1 <= grid <= sms * per_sm
    assert b == 0 or (grid - 1) * step < b
    if b >= sms * per_sm * step:
        assert grid == sms * per_sm


def test_thinlens_block_agrees_with_the_source():
    with open(os.path.join(_build.CSRC, "thinlens.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kBlock = (\d+);", src).group(1)) == (
        tk.THINLENS_BLOCK)
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == (
        tk.THINLENS_TILE)


def _tile_store(origin, direction, retried):
    """The kernel's store of one tile of 128 rays written out: lane ``l``
    stages the 12 floats of origin and of dir of its rays ``4l..4l+3``,
    then stores float4 ``u = l + 32 q`` (q = 0, 1, 2) of the tile's 96 of
    each array, its derivatives masked by the ballots' retried bits (bit
    ``l`` of ballot ``k``: ray ``4l + k``).  Returns the four ``[128, 3]``
    arrays."""
    staged = [torch.full((384,), float("nan")) for _ in range(2)]
    for lane in range(32):
        rays = range(4 * lane, 4 * lane + 4)
        staged[0][12 * lane:12 * lane + 12] = origin[list(rays)].reshape(-1)
        staged[1][12 * lane:12 * lane + 12] = direction[list(rays)].reshape(
            -1)
    ballots = [sum(1 << lane for lane in range(32) if bool(retried[4 * lane
                                                                   + k]))
               for k in range(4)]
    out = [torch.full((384,), float("nan")) for _ in range(4)]
    for q in range(3):
        for lane in range(32):
            u = 32 * q + lane
            for a in range(2):
                f = staged[a][4 * u:4 * u + 4]
                out[a][4 * u:4 * u + 4] = f
                for k in range(4):
                    r = (4 * u + k) // 3
                    on = (ballots[r & 3] >> (r >> 2)) & 1
                    out[2 + a][4 * u + k] = f[k] if on else 0.0
    return [a.reshape(128, 3) for a in out]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_store_written_out(seed):
    """Every float of the four arrays is stored once, and the derivatives
    are the origin and dir of a retried ray, else 0."""
    g = torch.Generator().manual_seed(seed)
    origin = torch.randn((128, 3), generator=g)
    origin[:, 2] = 0.0
    direction = torch.randn((128, 3), generator=g)
    retried = torch.rand(128, generator=g) < 0.3
    o, d, dody, dddy = _tile_store(origin, direction, retried)
    assert torch.equal(o, origin) and torch.equal(d, direction)
    zero = torch.zeros(())
    assert torch.equal(dody, torch.where(retried[:, None], origin, zero))
    assert torch.equal(dddy, torch.where(retried[:, None], direction, zero))
