"""The thin lens's whole kernel path on a card: ``csrc/thinlens.cu``
(``trace_kernel.thinlens_rays``) against its plain version,
``thinlens_plain`` then ``epilogue_plain``, bit for bit.

Imports no jax; on a machine without JAX leave out ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_thinlens_fold_cuda.py -q

Every output is compared by its bits: origin, dir, weight, both
derivatives and the four counters, on every branch the kernel takes from
its flags (depth of field, vignetting, presampled draws), at exposures
below, at and above 0, at budgets of 0 and 6 retries, at sizes that leave
a ragged last tile, on inputs off the 16-byte alignment and with outputs
off it (the one-ray path, through the library's entry).  Without a card
each test skips: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import _launch
from zoic_tpu_torch.ops import epilogue_kernel as ek
from zoic_tpu_torch.ops import trace_kernel as tk

SEED = 2024
SCALARS = (0.36, 1.7857143, 100.0, 6.0, 0.35)  # strong vignetting
BRANCHES = {
    "pinhole": dict(use_dof=False, has_ov=False),
    "pinhole-ov-flag": dict(use_dof=False, has_ov=True),
    "dof": dict(use_dof=True, has_ov=False),
    "dof-vignette": dict(use_dof=True, has_ov=True),
    "dof-bokeh": dict(use_dof=True, has_ov=False, presampled=True),
    "dof-bokeh-vignette": dict(use_dof=True, has_ov=True, presampled=True),
}
EXPOSURES = (-0.5, 0.0, 2.0)
FIELDS = ("origin", "dir", "weight", "d_ody", "d_ddy", "stats")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, flags, dev, offset=0):
    """The kernel's four flat inputs (``offset`` floats into a larger
    buffer when asked) and its retry planes, made with numpy."""
    rng = np.random.default_rng(n + 7 * offset)
    lo = -1.0 if flags.get("presampled") else 0.0
    cols = [rng.uniform(-1, 1, n + offset), rng.uniform(-1, 1, n + offset),
            rng.uniform(lo, 1, n + offset), rng.uniform(lo, 1, n + offset)]
    args = [torch.from_numpy(c.astype(np.float32)).to(dev)[offset:]
            for c in cols]
    planes = {}
    if flags.get("presampled") and flags["has_ov"]:
        bp = max(128, n // 4)
        planes = {k: torch.from_numpy(rng.uniform(-1, 1, (4, bp)).astype(
            np.float32)).to(dev) for k in ("retry_u1", "retry_u2")}
    return args, planes


def _assert_bits_equal(got, want):
    for name, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("max_tries", [0, 6])
@pytest.mark.parametrize("n,offset", [(1, 0), (31, 0), (33, 1), (4_096, 0),
                                      (16 * 128 + 77, 1), (100_003, 0),
                                      (300_000, 1)])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_thinlens_rays_match_plain_bit_for_bit(cuda_dev, branch, n, offset,
                                               max_tries):
    """Each output and the four counters equal the plain composition's on
    the card; one launch a call; a second launch gives the same bits."""
    flags = dict(BRANCHES[branch], max_tries=max_tries)
    args, planes = _inputs(n, flags, cuda_dev, offset)
    scal = [torch.tensor(v, device=cuda_dev) for v in SCALARS]
    for e in EXPOSURES:
        ex = torch.tensor(e, dtype=torch.float32, device=cuda_dev)
        before = tk.thinlens_rays_launches
        got = tk.thinlens_rays(*args, *scal, SEED, ex, **flags, **planes)
        assert tk.thinlens_rays_launches == before + 1
        want = tk.thinlens_rays_plain(*args, *scal, SEED, ex, **flags,
                                      **planes)
        again = tk.thinlens_rays(*args, *scal, SEED, ex, **flags, **planes)
        torch.cuda.synchronize()
        assert all(t.is_cuda for t in got)
        _assert_bits_equal(got, want)
        _assert_bits_equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16 * 128 + 77, 100_003])
@pytest.mark.parametrize("branch", ["pinhole", "dof-vignette",
                                    "dof-bokeh-vignette"])
def test_unaligned_outputs_take_the_one_ray_path(cuda_dev, branch, n):
    """The library's entry given outputs 4 bytes off the 16-byte alignment
    writes every ray through its one-ray loop, bit-equal to the plain
    composition."""
    flags = dict(BRANCHES[branch], max_tries=6)
    args, planes = _inputs(n, flags, cuda_dev)
    ex = torch.tensor(-0.5, dtype=torch.float32, device=cuda_dev)
    want = tk.thinlens_rays_plain(*args, *SCALARS, SEED, ex, **flags,
                                  **planes)
    (bu1, bu2, *layout), _ = tk._plane_args(
        n, args[0].device, flags.get("presampled", False), flags["has_ov"],
        planes.get("retry_u1"), planes.get("retry_u2"))
    sizes = (3 * n, 3 * n, n, 3 * n, 3 * n)
    bufs = [torch.full((s + 1,), float("nan"), device=cuda_dev)
            for s in sizes]
    stats = torch.full((4,), -1, dtype=torch.int32, device=cuda_dev)
    fn = _launch.bind("thinlens", "zoic_thinlens_rays_launch",
                      tk._THINLENS_RAYS_ARGTYPES)
    _launch.launch(
        fn, "thinlens", cuda_dev, *(a.data_ptr() for a in args), bu1, bu2,
        *tk.thinlens_scalars(*SCALARS), ex.data_ptr(),
        *(b.data_ptr() + 4 for b in bufs), stats.data_ptr(), n,
        int(flags["use_dof"]), int(flags["has_ov"]),
        int(flags.get("presampled", False)), flags["max_tries"] + 1, SEED,
        *layout, tk.thinlens_grid(n, *_launch.blocks_per_sm(
            "thinlens", "zoic_thinlens_rays_blocks_per_sm", [], cuda_dev)))
    torch.cuda.synchronize()
    got = [b[1:].reshape(w.shape) for b, w in zip(bufs, want)] + [stats]
    _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_the_entry_refuses_bad_arguments(cuda_dev):
    """A wrong exposure or input raises before a launch; the library
    refuses a grid of no block and image-bokeh retries without planes."""
    args, _ = _inputs(64, {"has_ov": True}, cuda_dev)
    with pytest.raises(ValueError, match="exposure must be 0-d"):
        tk.thinlens_rays(*args, *SCALARS, SEED, torch.zeros(2),
                         use_dof=True, has_ov=True, max_tries=3)
    with pytest.raises(ValueError, match="u1 must be float32"):
        tk.thinlens_rays(args[0], args[1], args[2].double(), args[3],
                         *SCALARS, SEED, 0.0, use_dof=True, has_ov=True,
                         max_tries=3)
    fn = _launch.bind("thinlens", "zoic_thinlens_rays_launch",
                      tk._THINLENS_RAYS_ARGTYPES)
    out = torch.empty(4 * 64 * 3, device=cuda_dev)
    ex = torch.zeros((), device=cuda_dev)
    stats = torch.empty(4, dtype=torch.int32, device=cuda_dev)
    common = [*(a.data_ptr() for a in args), None, None,
              *tk.thinlens_scalars(*SCALARS), ex.data_ptr(),
              *(out.data_ptr() for _ in range(5)), stats.data_ptr(), 64, 1,
              1]
    for presampled, grid in ((0, 0), (1, 4)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _launch.launch(fn, "thinlens", cuda_dev, *common, presampled, 7,
                           SEED, 0, 0, 0, 0, 0, grid)


def _disk(n=64):
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    return np.stack([img, img, img], -1)


THIN_CAMERAS = {
    "pinhole": dict(use_dof=False),
    "dof": dict(use_dof=True, exposure_control=-1.0),
    "dof-vignette": dict(use_dof=True, optical_vignetting_distance=6.0,
                         optical_vignetting_radius=0.35),
    "bokeh-vignette": dict(use_dof=True, use_image=True,
                           optical_vignetting_distance=1.0,
                           optical_vignetting_radius=1.0,
                           exposure_control=0.75),
}


@pytest.mark.cuda
@pytest.mark.parametrize("camera", [*THIN_CAMERAS, "raytraced"])
def test_create_rays_launches(cuda_dev, tmp_path, camera):
    """A thin lens's ``create_rays`` launches its one camera kernel and no
    epilogue; the raytraced model still launches the epilogue once a call.
    The thin lens's rays and counters equal the plain composition's on the
    model's inputs."""
    if camera == "raytraced":
        cfg = zpt.CameraConfig(
            lens_model=zpt.LensModel.RAYTRACED,
            lens_data_path=zpt.data.lens_path("double_gauss_f2.0"),
            focal_length=5.0, fstop=2.0, focal_distance=100.0)
        st = zpt.load_state(zpt.data.state_path(), device="cuda")
    else:
        kw = dict(THIN_CAMERAS[camera])
        if kw.get("use_image"):
            path = str(tmp_path / "disk.npy")
            np.save(path, _disk())
            kw["bokeh_path"] = path
        cfg = zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS,
                               focal_length=5.0, fstop=1.4,
                               focal_distance=100.0, **kw)
        st = zpt.compile_camera(cfg, cuda_dev)
    args, _ = _inputs(65_536 + 13, {}, cuda_dev)
    counts = (tk.launches, tk.thinlens_rays_launches, ek.launches)
    rays, stats = zpt.create_rays(st, cfg, *args, seed=91)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(
        (tk.launches, tk.thinlens_rays_launches, ek.launches), counts)]
    if camera == "raytraced":
        assert moved == [1, 0, 1]
        return
    assert moved == [0, 1, 0]
    sx, sy, lx, ly = args
    planes = {}
    has_ov = cfg.optical_vignetting_distance > 0.0
    if cfg.use_image:
        lx, ly = zpt.bokeh.sample(st.bokeh, lx, ly)
        if has_ov:
            from zoic_tpu_torch.models import thinlens as thin_model

            g = torch.Generator(device=cuda_dev).manual_seed(91)
            ru1, ru2 = thin_model.retry_planes(st, cfg, sx.shape[0], g)
            planes = dict(retry_u1=ru1, retry_u2=ru2)
    want = tk.thinlens_rays_plain(
        sx, sy, lx, ly, st.tan_fov, st.aperture_radius, st.focal_distance,
        st.ov_distance, st.ov_radius, 91, st.exposure_control,
        use_dof=cfg.use_dof, has_ov=has_ov, max_tries=cfg.max_tries,
        presampled=bool(cfg.use_image), **planes)
    got = [getattr(rays, f) for f in FIELDS[:5]] + [torch.stack(
        [stats.success, stats.vignetted, stats.tir, stats.tries_total])]
    _assert_bits_equal(got, want)
