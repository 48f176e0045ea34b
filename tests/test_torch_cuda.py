"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax, so it runs on a machine that has PyTorch for CUDA and no
JAX; there ``tests/conftest.py`` (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card each test skips: the kernels have no CPU mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import bokeh_kernel as bk
from zoic_tpu_torch.ops import trace_kernel as tk

SEED = 12345


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(0, 1, n), rng.uniform(0, 1, n)]
    return [torch.from_numpy(c.astype(np.float32)).cuda() for c in cols]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture
def cuda_state():
    _need_cuda()
    return zpt.load_state(zpt.data.state_path(), device="cuda")


@pytest.fixture
def cuda_dev():
    _need_cuda()
    return torch.device("cuda")


def _disk(n=64):
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    return np.stack([img, img, img], -1)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,max_tries",
    [(1, 25), (31, 25), (33, 25), (255, 0), (2_125, 25), (16 * 128 + 77, 6),
     (16_867, 25), (100_000, 25), (100_000, 0)]
)
def test_raytraced_kernel_matches_plain(cuda_state, n, max_tries):
    """tries/tir equal but for at most 1 ray in 10,000 (a borderline
    compare under another build of a math function); payloads of rays
    whose tries agree and are within the budget to 1e-5.  Batches that do
    not fill a warp, a block or the kernel's persistent grid, and a budget
    of no retries; a second launch gives the first one's bits, whatever
    order the warps took the rays in."""
    st = cuda_state
    args = _inputs(n, seed=n)
    before = tk.launches
    ko, kd, kt, ktir = tk.raytraced_fused(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    assert tk.launches == before + 1
    po, pd, pt, ptir = tk.raytraced_plain(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    torch.cuda.synchronize()
    assert ko.is_cuda and kt.dtype == torch.int32
    limit = max(1, n // 10_000)
    assert int((kt != pt).sum()) <= limit
    assert int((ktir != ptir).sum()) <= limit
    same = (kt == pt) & (kt <= max_tries)
    assert float((ko - po)[same].abs().max()) <= 1e-5
    assert float((kd - pd)[same].abs().max()) <= 1e-5
    again = tk.raytraced_fused(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    for a, k in zip(again, (ko, kd, kt, ktir)):
        assert torch.equal(a.view(torch.int32), k.view(torch.int32))


@pytest.mark.cuda
def test_raytraced_all_dead_bound_on_cuda(cuda_state):
    """A bound that rejects the whole disk (q1 = -1 everywhere): every ray
    takes its whole budget without a draw or a trace and keeps a zero
    payload, as in the plain version."""
    st = cuda_state
    poly = st.lens.profile.poly.clone()
    poly[1] = 0.0
    poly[1, 0] = -1.0
    lens = dataclasses.replace(st.lens, profile=dataclasses.replace(
        st.lens.profile, poly=poly))
    args = _inputs(4_133, seed=8)
    ko, kd, kt, ktir = tk.raytraced_fused(lens, *args, st.sensor_width, SEED,
                                          max_tries=4)
    po, pd, pt, ptir = tk.raytraced_plain(lens, *args, st.sensor_width, SEED,
                                          max_tries=4)
    torch.cuda.synchronize()
    assert bool((kt == 5).all()) and bool((ktir == 0).all())
    assert torch.equal(kt, pt) and torch.equal(ktir, ptir)
    assert not bool(ko.any()) and not bool(kd.any())
    assert torch.equal(ko, po) and torch.equal(kd, pd)


@pytest.mark.cuda
def test_create_rays_on_cuda(cuda_state):
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED, lens_data_path="double_gauss_f2.0",
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
    )
    sx, sy, lx, ly = _inputs(65_536, seed=1)
    g = torch.Generator(device="cuda").manual_seed(3)
    before = tk.launches
    rays, stats = zpt.create_rays(cuda_state, cfg, sx, sy, lx, ly,
                                  generator=g)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    assert int(stats.success) + int(stats.vignetted) == 65_536
    assert bool(torch.isfinite(rays.origin).all())
    assert rays.weight.is_cuda and rays.weight.shape == (65_536,)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["raytraced", "thinlens"])
def test_create_rays_takes_columns_of_a_sample_tensor(cuda_state, model):
    """``uv[:, 0]`` of a ``[B, 2]`` sample tensor is strided: the entry point
    copies it once and gives the rays of the contiguous columns, bit for
    bit.  The kernel wrappers themselves refuse a strided input."""
    if model == "raytraced":
        st = cuda_state
        cfg = zpt.CameraConfig(
            lens_model=zpt.LensModel.RAYTRACED,
            lens_data_path="double_gauss_f2.0", focal_length=5.0, fstop=2.0,
            focal_distance=100.0)
    else:
        cfg = zpt.CameraConfig(
            lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
            focal_distance=100.0, use_dof=True,
            optical_vignetting_distance=6.0, optical_vignetting_radius=0.35)
        st = zpt.compile_camera(cfg, "cuda")
    sx, sy, lx, ly = _inputs(4_133, seed=2)
    uv, lens = torch.stack([sx, sy], 1), torch.stack([lx, ly], 1)
    assert not uv[:, 0].is_contiguous()
    before = tk.launches + tk.thinlens_launches
    got, gs = zpt.create_rays(st, cfg, uv[:, 0], uv[:, 1], lens[:, 0],
                              lens[:, 1], seed=77)
    want, ws = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=77)
    torch.cuda.synchronize()
    assert tk.launches + tk.thinlens_launches == before + 2
    assert torch.equal(got.origin, want.origin)
    assert torch.equal(got.dir, want.dir)
    assert torch.equal(got.weight, want.weight)
    assert int(gs.tries_total) == int(ws.tries_total)
    with pytest.raises(ValueError, match="must be contiguous"):
        tk.thinlens_fused(uv[:, 0], uv[:, 1], lens[:, 0], lens[:, 1],
                          0.36, 1.8, 100.0, 6.0, 0.35, 9, use_dof=True,
                          has_ov=True, max_tries=6)


@pytest.mark.cuda
def test_raytraced_bokeh_create_rays_on_cuda(cuda_dev):
    """The image-bokeh camera end to end: one bokeh launch for the
    attempt-0 offsets, one for the retry planes, one raytraced launch."""
    cam = zpt.data.CAMERAS["raytraced_bokeh_image"]
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path=cam.lens, bokeh_path="disk64.npy",
                           **cam.config_kwargs())
    st = zpt.load_state(zpt.data.state_path(cam.file), device=cuda_dev)
    sx, sy, lx, ly = _inputs(65_536, seed=4)
    t0, b0 = tk.launches, bk.launches
    rays, stats = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=77)
    torch.cuda.synchronize()
    assert tk.launches == t0 + 1 and bk.launches == b0 + 2
    assert int(stats.success) + int(stats.vignetted) == 65_536
    assert int(stats.tries_total) > 0
    assert bool(torch.isfinite(rays.dir).all()) and rays.dir.is_cuda


# raytraced variants: (shipped camera, raytraced_fused flags, lens changes)
RT_VARIANTS = {
    "harmonic-chain": ("raytraced_fisheye", {}, {}),
    "harmonic-poly": ("raytraced_fisheye", {}, dict(profile_poly=True)),
    "circles-chain": ("raytraced_petzval_f1.25_focus30", {}, {}),
    "no-iris": ("raytraced_telephoto_f5.0_focus30", {}, {}),
    "naive": ("raytraced_naive", dict(use_lut=False), {}),
    "naive-no-precheck": ("raytraced_naive",
                          dict(use_lut=False, use_profile=False), {}),
    "no-precheck": ("headline", dict(use_profile=False), {}),
    "dynamic-flags": ("headline", {}, dict(elem_flags=())),
    "bokeh-precheck": ("raytraced_bokeh_image", dict(presampled=True), {}),
    "bokeh-no-precheck": ("raytraced_bokeh_image",
                          dict(presampled=True, use_profile=False), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 16 * 128 + 77, 300_000])
@pytest.mark.parametrize("name", list(RT_VARIANTS))
def test_raytraced_variant_matches_plain(cuda_dev, name, n):
    """Every variant of the raytraced kernel against its plain version:
    tries/tir equal but for at most 1 ray in 10,000, payloads of agreeing
    live rays within 1e-5, and a second launch bit-equal to the first.
    Presampled variants read retry planes of an eighth of the batch, so
    tiles share plane blocks at 300,000 rays."""
    camera, flags, lens_kw = RT_VARIANTS[name]
    st = zpt.load_state(zpt.data.state_path(camera), device=cuda_dev)
    lens = dataclasses.replace(st.lens, **lens_kw)
    rng = np.random.default_rng(n)
    lo = -1.0 if flags.get("presampled") else 0.0
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(lo, 1, n), rng.uniform(lo, 1, n)]
    args = [torch.from_numpy(c.astype(np.float32)).to(cuda_dev)
            for c in cols]
    kw = dict(flags, max_tries=25)
    if flags.get("presampled"):
        bp = max(1 << 12, n // 8)
        kw.update({k: torch.from_numpy(rng.uniform(-1, 1, (4, bp)).astype(
            np.float32)).to(cuda_dev) for k in ("retry_u1", "retry_u2")})
    before = tk.launches
    ko, kd, kt, ktir = tk.raytraced_fused(lens, *args, st.sensor_width,
                                          SEED, **kw)
    assert tk.launches == before + 1
    po, pd, pt, ptir = tk.raytraced_plain(lens, *args, st.sensor_width,
                                          SEED, **kw)
    torch.cuda.synchronize()
    limit = max(1, n // 10_000)
    assert int((kt != pt).sum()) <= limit
    assert int((ktir != ptir).sum()) <= limit
    same = (kt == pt) & (ktir == ptir) & (kt <= 25)
    assert int(same.sum()) > 0
    assert float((ko - po)[same].abs().max()) <= 1e-5
    assert float((kd - pd)[same].abs().max()) <= 1e-5
    again = tk.raytraced_fused(lens, *args, st.sensor_width, SEED, **kw)
    for a, k in zip(again, (ko, kd, kt, ktir)):
        assert torch.equal(a.view(torch.int32), k.view(torch.int32))


THIN_BRANCHES = {
    "pinhole": dict(use_dof=False, has_ov=False),
    "dof": dict(use_dof=True, has_ov=False),
    "dof-vignette": dict(use_dof=True, has_ov=True),
    "dof-bokeh": dict(use_dof=True, has_ov=False, presampled=True),
    "dof-bokeh-vignette": dict(use_dof=True, has_ov=True, presampled=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16 * 128 + 77, 300_000])
@pytest.mark.parametrize("branch", list(THIN_BRANCHES))
def test_thinlens_kernel_matches_plain(cuda_dev, branch, n):
    """tries equal but for at most 1 ray in 10,000 and payloads within
    1e-5 (the kernel is built to round as the plain version does, so both
    are in practice equal); strong vignetting, so retries run to the
    budget, and retry planes of a quarter batch."""
    flags = THIN_BRANCHES[branch]
    rng = np.random.default_rng(n)
    lo = -1.0 if flags.get("presampled") else 0.0
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(lo, 1, n), rng.uniform(lo, 1, n)]
    args = [torch.from_numpy(c.astype(np.float32)).to(cuda_dev) for c in cols]
    bp = max(128, n // 4)
    planes = {}
    if flags.get("presampled") and flags["has_ov"]:
        planes = {k: torch.from_numpy(rng.uniform(-1, 1, (4, bp)).astype(
            np.float32)).to(cuda_dev) for k in ("retry_u1", "retry_u2")}
    scal = [torch.tensor(v, device=cuda_dev)
            for v in (0.36, 1.7857143, 100.0, 6.0, 0.35)]
    before = tk.thinlens_launches
    ko, kd, kt = tk.thinlens_fused(*args, *scal, SEED, max_tries=25,
                                   **flags, **planes)
    assert tk.thinlens_launches == before + 1
    po, pd, pt = tk.thinlens_plain(*args, *scal, SEED, max_tries=25,
                                   **flags, **planes)
    torch.cuda.synchronize()
    assert ko.is_cuda and kt.dtype == torch.int32
    assert int((kt != pt).sum()) <= max(1, n // 10_000)
    same = kt == pt
    assert float((ko - po)[same].abs().max()) <= 1e-5
    assert float((kd - pd)[same].abs().max()) <= 1e-5
    if flags["has_ov"]:
        assert int(kt.max()) == 26


@pytest.mark.cuda
@pytest.mark.parametrize("as_numbers", [False, True])
def test_thinlens_scalars_by_value_on_cuda(cuda_dev, as_numbers):
    """The camera scalars reach the kernel by value: a compiled state's
    0-d tensors (read once, kept beside the state) and plain numbers give
    the plain version's bits, and a state whose field is written in place
    is read again."""
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_dof=True,
        optical_vignetting_distance=6.0, optical_vignetting_radius=0.35)
    st = zpt.compile_camera(cfg, cuda_dev)
    fields = [st.tan_fov, st.aperture_radius, st.focal_distance,
              st.ov_distance, st.ov_radius]
    if as_numbers:
        fields = [float(f) for f in fields]
    args = _inputs(50_000, seed=9)
    kw = dict(use_dof=True, has_ov=True, max_tries=25)
    for focus in (None, 40.0):
        if focus is not None:
            if as_numbers:
                fields[2] = focus
            else:
                st.focal_distance.fill_(focus)
        got = tk.thinlens_fused(*args, *fields, SEED, **kw)
        want = tk.thinlens_plain(*args, *fields, SEED, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tk.thinlens_fused(args[0], args[1], args[2],
                          torch.zeros(100_000, device=cuda_dev)[::2],
                          *fields, SEED, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,n",
    [((64, 64), 1), ((64, 64), 77), ((48, 80), 100_000), ((40, 36), 4096),
     ((256, 8), 65_536), ((300, 200), 65_536)],
)
def test_bokeh_kernel_matches_plain_bit_for_bit(cuda_dev, shape, n):
    """Every image size the host build makes, beyond the TPU kernel's
    128-pixel gate, with draws on the CDF entries themselves."""
    h, w = shape
    rng = np.random.default_rng(h * w + n)
    pixels = _disk(64) if shape == (64, 64) else rng.random(
        (h, w, 3), dtype=np.float32)
    if shape == (40, 36):
        pixels[::3] = 0.0
    image = zpt.bokeh.build(pixels).to(cuda_dev)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    k = min(n, h)
    u1[:k] = image.cdf_row.cpu().numpy()[:k]
    u2[:k] = image.cdf_col.cpu().numpy()[:k, min(3, w - 1)]
    u1, u2 = (torch.from_numpy(u).to(cuda_dev) for u in (u1, u2))
    before = bk.launches
    kdx, kdy = bk.sample_fused(image, u1, u2)
    assert bk.launches == before + 1
    pdx, pdy = bk.sample_plain(image, u1, u2)
    torch.cuda.synchronize()
    assert torch.equal(kdx.view(torch.int32), pdx.view(torch.int32))
    assert torch.equal(kdy.view(torch.int32), pdy.view(torch.int32))


@pytest.mark.cuda
def test_thinlens_create_rays_on_cuda(cuda_dev, tmp_path):
    path = str(tmp_path / "disk.npy")
    np.save(path, _disk())
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_image=True, bokeh_path=path,
        optical_vignetting_distance=2.0, optical_vignetting_radius=0.8,
    )
    state = zpt.compile_camera(cfg, cuda_dev)
    sx, sy, lx, ly = _inputs(65_536, seed=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    t0, b0 = tk.thinlens_launches, bk.launches
    rays, stats = zpt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    assert tk.thinlens_launches == t0 + 1 and bk.launches == b0 + 2
    assert int(stats.success) + int(stats.vignetted) == 65_536
    assert int(stats.tries_total) > 0
    assert bool(torch.isfinite(rays.dir).all()) and rays.dir.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [1, 4, 8])
@pytest.mark.parametrize("name", [
    "fma", "mul", "add", "sqrt", "rsqrt", "div", "recip", "abs", "select",
    "min", "floor", "i32mix", "f2i"])
def test_roofline_kernel_matches_plain_bit_for_bit(cuda_dev, name, n_streams):
    """Each op chain of the microbenchmark kernel, built with
    ``--fmad=false``, against its plain version on random inputs: the
    kernel runs the plain version's ops in its order, so every bit
    agrees."""
    from zoic_tpu_torch.ops import roofline_kernel as rk

    rng = np.random.default_rng(n_streams)
    shape = (n_streams, 16, 128)
    if name == "i32mix":
        x = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int32))
    else:
        x = torch.from_numpy(rng.uniform(0.1, 4.0, shape).astype(np.float32))
    x = x.to(cuda_dev)
    before = rk.launches
    k = rk.roofline_fused(name, x, 3, 37)
    assert rk.launches == before + 1
    p = rk.roofline_plain(name, x, 3, 37)
    torch.cuda.synchronize()
    assert k.shape == (48, 128) and k.dtype == x.dtype
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.cuda
def test_roofline_contracted_fma_and_refusals(cuda_dev):
    """The build with contraction on launches and stays within a few ulp
    of the plain chain; the wrapper refuses shapes and stream counts the
    kernel has no instance for."""
    from zoic_tpu_torch.ops import roofline_kernel as rk

    x = torch.full((4, 8, 128), 1.234, device=cuda_dev)
    k = rk.roofline_fused("fma", x, 2, 64, contract=True)
    p = rk.roofline_plain("fma", x, 2, 64)
    torch.cuda.synchronize()
    assert float((k - p).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="n_streams"):
        rk.roofline_fused("fma", torch.ones((3, 8, 128), device=cuda_dev), 1, 1)
    with pytest.raises(ValueError, match="shape"):
        rk.roofline_fused("fma", torch.ones((4, 8, 64), device=cuda_dev), 1, 1)
    with pytest.raises(ValueError, match="int32"):
        rk.roofline_fused("i32mix", x, 1, 1)


@pytest.mark.cuda
def test_compile_camera_on_cuda(cuda_dev):
    """The naive camera compiled on the card (the default device): the
    state lives on the card, its lens-decided statics equal the shipped
    state's, and create_rays runs the raytraced kernel on it."""
    cam = zpt.data.CAMERAS["raytraced_naive"]
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path=zpt.data.lens_path(cam.lens),
                           **cam.config_kwargs())
    st = zpt.compile_camera(cfg)
    ref = zpt.load_state(zpt.data.state_path("raytraced_naive"))
    assert st.device.type == "cuda" and st.lens.profile.c0.is_cuda
    for f in ("aperture_element", "iris_identity", "elem_flags",
              "profile_domain"):
        assert getattr(st.lens, f) == getattr(ref.lens, f), f
    sx, sy, lx, ly = _inputs(65_536, seed=5)
    before = tk.launches
    _, stats = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=11)
    _, ref_stats = zpt.create_rays(ref, cfg, sx, sy, lx, ly, seed=11)
    torch.cuda.synchronize()
    assert tk.launches == before + 2
    att = [1 + int(s.tries_total) / 65_536 for s in (stats, ref_stats)]
    assert abs(att[0] - att[1]) <= 0.02 * att[1]


@pytest.mark.cuda
def test_profiling_trace_records_the_card(cuda_dev, tmp_path):
    """``utils.profiling.trace`` records device time of the raytraced
    kernel (CUPTI on the card), and ``time_fn`` times it with CUDA events."""
    from zoic_tpu_torch.utils import profiling

    st = zpt.load_state(zpt.data.state_path())
    args = _inputs(65_536, seed=6)

    def call():
        tk.raytraced_fused(st.lens, *args, st.sensor_width, SEED,
                           max_tries=25)

    t = profiling.time_fn(lambda: call(), lambda: (), iters=3)
    assert 0 < t["median"] < 1.0
    with profiling.trace(str(tmp_path)) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0]
    assert any("raytraced" in n for n in names), names
