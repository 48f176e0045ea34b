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
from zoic_tpu_torch.ops import epilogue_kernel as ek
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
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 77, 16 * 128 + 77, 1_000_003])
def test_epilogue_kernel_matches_plain(cuda_dev, n, offset):
    """The epilogue kernel against its plain version bit for bit: weights,
    both derivatives and the four counters, at exposures of both signs and
    0; batches that do not fill a group of four rays, a block or the grid,
    and inputs off the 16-byte alignment (the one-ray path); two launches
    equal."""
    rng = np.random.default_rng(n)
    m = n + offset
    tries = torch.from_numpy(rng.integers(0, 27, m).astype(np.int32))
    tir = torch.from_numpy(rng.integers(0, 3, m).astype(np.int32))
    vecs = torch.from_numpy(rng.normal(size=(2, m, 3)).astype(np.float32))
    t, r, o, d = (x.to(cuda_dev)[offset:] for x in (tries, tir, *vecs))
    for e in (-0.5, 0.0, 2.0):
        ex = torch.tensor(e, dtype=torch.float32, device=cuda_dev)
        args = (t, r, o, d, ex, 25)
        before = ek.launches
        k = ek.epilogue_fused(*args)
        assert ek.launches == before + (n > 0)
        p = ek.epilogue_plain(*args)
        again = ek.epilogue_fused(*args)
        torch.cuda.synchronize()
        for a, b, c in zip(k, p, again):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))


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
    before = tk.raytraced_rays_launches
    rays, stats = zpt.create_rays(cuda_state, cfg, sx, sy, lx, ly,
                                  generator=g)
    torch.cuda.synchronize()
    assert tk.raytraced_rays_launches == before + 1
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
    before = tk.raytraced_rays_launches + tk.thinlens_rays_launches
    got, gs = zpt.create_rays(st, cfg, uv[:, 0], uv[:, 1], lens[:, 0],
                              lens[:, 1], seed=77)
    want, ws = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=77)
    torch.cuda.synchronize()
    assert tk.raytraced_rays_launches + tk.thinlens_rays_launches == (
        before + 2)
    assert torch.equal(got.origin, want.origin)
    assert torch.equal(got.dir, want.dir)
    assert torch.equal(got.weight, want.weight)
    assert int(gs.tries_total) == int(ws.tries_total)
    with pytest.raises(ValueError, match="must be contiguous"):
        tk.thinlens_rays(uv[:, 0], uv[:, 1], lens[:, 0], lens[:, 1],
                         0.36, 1.8, 100.0, 6.0, 0.35, 9, 0.0, use_dof=True,
                         has_ov=True, max_tries=6)


@pytest.mark.cuda
def test_raytraced_bokeh_create_rays_on_cuda(cuda_dev):
    """The image-bokeh camera end to end: one bokeh launch for the
    attempt-0 offsets, one launch of the plane entry for the retry planes
    (no eager hash), one raytraced launch that writes the finished rays."""
    cam = zpt.data.CAMERAS["raytraced_bokeh_image"]
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path=cam.lens, bokeh_path="disk64.npy",
                           **cam.config_kwargs())
    st = zpt.load_state(zpt.data.state_path(cam.file), device=cuda_dev)
    sx, sy, lx, ly = _inputs(65_536, seed=4)
    t0, b0, p0 = tk.raytraced_rays_launches, bk.launches, bk.plane_launches
    rays, stats = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=77)
    torch.cuda.synchronize()
    assert tk.raytraced_rays_launches == t0 + 1 and bk.launches == b0 + 1
    assert bk.plane_launches == p0 + 1
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
    ex = st.exposure_control
    for focus in (None, 40.0):
        if focus is not None:
            if as_numbers:
                fields[2] = focus
            else:
                st.focal_distance.fill_(focus)
        got = tk.thinlens_rays(*args, *fields, SEED, ex, **kw)
        want = tk.thinlens_rays_plain(*args, *fields, SEED, ex, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tk.thinlens_rays(args[0], args[1], args[2],
                         torch.zeros(100_000, device=cuda_dev)[::2],
                         *fields, SEED, ex, **kw)


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


def _bokeh_image(shape):
    """The 64x64 disk, a 128x128 or 512x512 disk, or random pixels (every
    fifth row dark when there are more than five)."""
    if shape in ((64, 64), (128, 128), (512, 512)):
        return zpt.bokeh.build(_disk(shape[0]))
    pixels = np.random.default_rng(shape[0] * 1000 + shape[1]).random(
        (*shape, 3), dtype=np.float32)
    if shape[0] > 5:
        pixels[::5] = 0.0
    return zpt.bokeh.build(pixels)


def _edge_draws(image, n, seed):
    """Uniforms led by 0.0, 1 - 2**-24 and the CDF entries themselves."""
    rng = np.random.default_rng(seed)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    edges = [0.0, 1.0 - 2.0**-24]
    e1 = np.concatenate([edges, image.cdf_row.numpy()]).astype(np.float32)
    e2 = np.concatenate([edges, image.cdf_col.numpy().reshape(-1)[::7]])
    k1, k2 = min(n, len(e1)), min(n, len(e2))
    u1[:k1], u2[:k2] = e1[:k1], e2[:k2].astype(np.float32)
    return torch.from_numpy(u1), torch.from_numpy(u2)


# draws outside [0, 1), where the global instance's guides do not hold
OUTSIDE = np.array([-0.0, -2.0**-149, -1.0, 1.0, 1.0 + 2.0**-23, 2.0,
                    np.inf, -np.inf], np.float32)


def _outside_draws(image, u1, u2):
    """``u1``, ``u2`` followed by draws with one uniform outside [0, 1)
    (``OUTSIDE`` and every CDF entry at or above 1.0) and the other from
    ``u1`` or ``u2``, and by every pair of ``OUTSIDE``; zeros pad what is
    added to a multiple of 4."""
    cdf_row = image.cdf_row.numpy()
    cdf_col = image.cdf_col.numpy().reshape(-1)
    out1 = np.concatenate([OUTSIDE, cdf_row[cdf_row >= 1]])
    out2 = np.concatenate([OUTSIDE, cdf_col[cdf_col >= 1]])
    pairs = np.stack(np.meshgrid(OUTSIDE, OUTSIDE)).reshape(2, -1)
    a = np.concatenate([out1, np.resize(u1.numpy(), len(out2)), pairs[0]])
    b = np.concatenate([np.resize(u2.numpy(), len(out1)), out2, pairs[1]])
    pad = np.zeros(-len(a) % 4, np.float32)
    return (torch.cat([u, torch.from_numpy(np.concatenate([x, pad]))])
            for u, x in ((u1, a), (u2, b)))


BOKEH_SHAPES = [(1, 1), (1, 64), (64, 1), (64, 64), (128, 128), (300, 200),
                (512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 77, 4097])
@pytest.mark.parametrize("shape", BOKEH_SHAPES)
def test_bokeh_kernel_both_paths_match_plain(cuda_dev, shape, n):
    """The shared-memory path (up to 128x128 on an H100) and the global
    one, which searches the plane tables through their guides (300x200
    and the benchmark's 512x512 disk), at batches that are not multiples
    of 4, with draws on the CDF entries, 0.0 and 1 - 2**-24 and draws
    outside [0, 1) (signed zeros, a subnormal, 1.0 and above, infinities,
    the CDF entries at or above 1.0); then again with inputs one float off
    16-byte alignment (the scalar loads)."""
    image = _bokeh_image(shape)
    u1, u2 = _outside_draws(image, *_edge_draws(image, n,
                                                seed=shape[0] + n))
    image = image.to(cuda_dev)
    _, shared, _ = bk._plan(image, n, False, cuda_dev)
    assert shared == (shape not in ((300, 200), (512, 512)))
    pad = torch.zeros(1)
    for off in (0, 1):
        a, b = (torch.cat([pad[:off], u]).to(cuda_dev)[off:]
                for u in (u1, u2))
        before = bk.launches
        kdx, kdy = bk.sample_fused(image, a, b)
        assert bk.launches == before + 1
        pdx, pdy = bk.sample_plain(image, a, b)
        torch.cuda.synchronize()
        assert torch.equal(kdx.view(torch.int32), pdx.view(torch.int32))
        assert torch.equal(kdy.view(torch.int32), pdy.view(torch.int32))


def _spike_image():
    """A 64x64 image dark but for one pixel."""
    pixels = np.zeros((64, 64, 3), np.float32)
    pixels[20, 30] = 1.0
    return zpt.bokeh.build(pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (128, 128), (300, 200),
                                   "spike"])
@pytest.mark.parametrize("n_cells", [4, 124, 132, 8500, 67_468, 2_097_152])
def test_bokeh_planes_match_plain(cuda_dev, n_cells, shape):
    """The plane entry against the eager hash and sampler, bit for bit, at
    the cell counts of ragged batches and of the bench, with a plane seed
    past 2**31 (masked to 32 bits as the eager hash masks it): its guide
    tables in shared memory (the disks, the one-pixel spike) and in global
    memory (300x200)."""
    from zoic_tpu_torch.models import raytraced as rt_model

    image = (_spike_image() if shape == "spike"
             else _bokeh_image(shape)).to(cuda_dev)
    _, shared, _ = bk._plan(image, n_cells, True, cuda_dev)
    assert shared == (shape != (300, 200))
    salts = (rt_model.SALT_P1, rt_model.SALT_P2)
    for pseed in (77 + rt_model.PLANE_SEED_OFFSET, (1 << 31) + 12_345):
        before = bk.plane_launches
        k = bk.planes_fused(image, n_cells, pseed, *salts)
        assert bk.plane_launches == before + 1
        p = bk.planes_plain(image, n_cells, pseed, *salts)
        torch.cuda.synchronize()
        for kt, pt in zip(k, p):
            assert kt.shape == (n_cells,) and kt.is_cuda
            assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))


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
    t0, b0 = tk.thinlens_rays_launches, bk.launches
    rays, stats = zpt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    assert tk.thinlens_rays_launches == t0 + 1 and bk.launches == b0 + 2
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
    ``--fmad=false``, against its plain version on random inputs, 37 steps
    (four blocks of 8 and a tail for the written-out sqrt, div and recip):
    the kernel runs the plain version's ops in its order, its one FFMA for
    ``x * 0.5 + 1.25`` rounding as the exact product's sum does, so every
    bit agrees."""
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
    """The fma chain, one FFMA a step in the one build (the contracted
    build it once needed is gone), equals the plain two-rounding chain bit
    for bit at the tool's value over 512 steps; the wrapper refuses shapes
    and stream counts the kernel has no instance for, and ``contract``."""
    from zoic_tpu_torch.ops import roofline_kernel as rk

    x = torch.full((4, 8, 128), 1.234, device=cuda_dev)
    k = rk.roofline_fused("fma", x, 2, 512)
    p = rk.roofline_plain("fma", x, 2, 512)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    with pytest.raises(ValueError, match="n_streams"):
        rk.roofline_fused("fma", torch.ones((3, 8, 128), device=cuda_dev), 1, 1)
    with pytest.raises(ValueError, match="shape"):
        rk.roofline_fused("fma", torch.ones((4, 8, 64), device=cuda_dev), 1, 1)
    with pytest.raises(ValueError, match="int32"):
        rk.roofline_fused("i32mix", x, 1, 1)
    with pytest.raises(TypeError):
        rk.roofline_fused("fma", x, 1, 1, contract=True)


@pytest.mark.cuda
def test_roofline_ieee_sweep(cuda_dev):
    """The kernel's written-out sqrt, div and recip equal PyTorch's on the
    card over every pattern of [1, 4), 2^23 patterns across all exponents
    and the specials, div over 142 dividends, at 1 and 9 steps (NaN as
    NaN)."""
    from zoic_tpu_torch.tools import roofline

    res = roofline.ieee_sweep(cuda_dev)
    assert set(res) == {"sqrt", "div", "recip"}
    for name, r in res.items():
        assert r["operands"] >= 2 * 25_165_824, name
        assert r["mismatches"] == 0, (name, r["first"])


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
    before = tk.raytraced_rays_launches
    _, stats = zpt.create_rays(st, cfg, sx, sy, lx, ly, seed=11)
    _, ref_stats = zpt.create_rays(ref, cfg, sx, sy, lx, ly, seed=11)
    torch.cuda.synchronize()
    assert tk.raytraced_rays_launches == before + 2
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
    # the wrapper's span, on the profiler's clock beside the kernel
    assert "zoic.raytraced" in {e.key for e in prof.key_averages()}


@pytest.mark.cuda
def test_cache_miss_spans_on_a_miss_only(cuda_dev):
    """``zoic.tables.build`` and ``zoic.kernel.load`` open when a wrapper
    builds its tables, binds its library function or asks the occupancy,
    and not on the next call, which finds all three cached."""
    from torch.profiler import ProfilerActivity, profile

    from zoic_tpu_torch.ops import _launch

    st = zpt.load_state(zpt.data.state_path(), device="cuda")
    args = _inputs(4_096, seed=9)
    image = zpt.bokeh.build(_disk()).to(cuda_dev)

    def spans():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tk.raytraced_fused(st.lens, *args, st.sensor_width, SEED,
                               max_tries=25)
            bk.sample_fused(image, args[2], args[3])
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.name.startswith("zoic."))

    for cache in (tk._TABLES, bk._TABLES, bk._CARD, _launch._PER_SM,
                  _launch._BOUND):
        cache.clear()
    missed = spans()
    assert missed.count("zoic.tables.build") == 2, missed
    assert "zoic.kernel.load" in missed, missed
    assert spans() == ["zoic.bokeh.sample", "zoic.raytraced"]


def _headline_cfg(**kw):
    return zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0, **kw)


@pytest.mark.cuda
def test_eager_path_matches_kernel_on_card(cuda_state):
    """``impl="jnp"`` runs the eager path on the card: its first attempt
    (``max_tries=0``) agrees with the kernel's on 99.99% of the ok mask and
    within 1e-5 on rays alive in both; no kernel launches."""
    cfg = _headline_cfg(max_tries=0)
    s = _inputs(100_000, seed=21)
    before = tk.launches, tk.raytraced_rays_launches
    er, _ = zpt.create_rays(cuda_state, dataclasses.replace(cfg, impl="jnp"),
                            *s, seed=3)
    torch.cuda.synchronize()
    assert (tk.launches, tk.raytraced_rays_launches) == before
    kr, _ = zpt.create_rays(cuda_state, cfg, *s, seed=3)
    eok, kok = er.weight > 0, kr.weight > 0
    assert int((eok != kok).sum()) <= 10
    both = eok & kok
    assert float((er.dir - kr.dir)[both].abs().max()) <= 1e-5
    assert float((er.origin - kr.origin)[both].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_grid_batch_runs_the_kernel_on_card(cuda_state):
    """An [H, W] batch on the card is one raytraced launch on the
    flattened samples, and gives the flat call's bits in its shape."""
    cfg = _headline_cfg(max_tries=25)
    s = _inputs(256 * 384, seed=22)
    flat, fstats = zpt.create_rays(cuda_state, cfg, *s, seed=5)
    before = tk.raytraced_rays_launches
    grid, gstats = zpt.create_rays(cuda_state, cfg,
                                   *(a.reshape(256, 384) for a in s), seed=5)
    torch.cuda.synchronize()
    assert tk.raytraced_rays_launches == before + 1
    assert grid.dir.shape == (256, 384, 3) and grid.weight.shape == (256, 384)
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(grid, f).reshape(getattr(flat, f).shape),
                           getattr(flat, f))
    assert int(gstats.tries_total) == int(fstats.tries_total)


@pytest.mark.cuda
def test_camera_render_and_state_io_on_card(cuda_dev, tmp_path):
    """``Camera`` compiles on the card; ``render_rays`` is ``create_rays``
    on ``frame_samples`` from one generator, bit for bit; a saved and
    reloaded state gives the same bits; the stats totals stay on the card
    and sum the calls' stats."""
    cfg = _headline_cfg(pupil_precheck=False)
    cam = zpt.Camera(cfg)
    assert cam.state.device.type == "cuda" and cam.stats_totals.is_cuda
    spec = zpt.FrameSpec(256, 128, spp=2)
    g = torch.Generator(device=cuda_dev).manual_seed(4)
    rays, stats = zpt.render.render_rays(cam.state, cfg, spec, g)
    g = torch.Generator(device=cuda_dev).manual_seed(4)
    s = zpt.render.frame_samples(spec, g)
    again, _ = cam.create_rays(*s, generator=g)
    for f in ("origin", "dir", "weight"):
        assert torch.equal(getattr(rays, f), getattr(again, f))
    assert zpt.render.weight_image(spec, rays).shape == (128, 256)
    path = str(tmp_path / "cam.npz")
    zpt.io.state.save(path, cam.state)
    back = zpt.io.state.load(path)
    r2, _ = zpt.create_rays(back, cfg, *s, seed=9)
    r1, _ = zpt.create_rays(cam.state, cfg, *s, seed=9)
    assert torch.equal(r1.dir, r2.dir) and torch.equal(r1.weight, r2.weight)
    assert cam.stats_totals.tolist()[:2] == [int(stats.success),
                                             int(stats.vignetted)]


@pytest.mark.cuda
def test_mesh_on_card(cuda_state):
    """A mesh of one card equals the plain call bit for bit at the full
    budget; two shards on one card equal it at ``max_tries=0`` and give
    the same bits twice."""
    from zoic_tpu_torch.parallel import sharding

    cfg = _headline_cfg()
    s = _inputs(65_536, seed=22)
    rays, stats = zpt.create_rays(cuda_state, cfg, *s, seed=7)
    srays, sstats = sharding.create_rays_sharded(sharding.make_mesh(),
                                                 cuda_state, cfg, *s, seed=7)
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(rays, f), getattr(srays, f))
    assert int(stats.tries_total) == int(sstats.tries_total)
    cfg0 = _headline_cfg(max_tries=0)
    mesh2 = sharding.make_mesh(["cuda:0", "cuda:0"])
    one, _ = zpt.create_rays(cuda_state, cfg0, *s, seed=7)
    two, tstats = sharding.create_rays_sharded(mesh2, cuda_state, cfg0, *s,
                                               seed=7)
    two_again, _ = sharding.create_rays_sharded(mesh2, cuda_state, cfg0, *s,
                                                seed=7)
    ok = one.weight > 0
    assert torch.equal(ok, two.weight > 0)
    assert torch.equal(one.dir[ok], two.dir[ok])
    assert torch.equal(two.dir, two_again.dir)
    assert int(tstats.success) + int(tstats.vignetted) == 65_536


def _spot_rms(lens, curvature, u):
    """RMS radius of the on-axis spot at the focus distance, as a function
    of the curvatures (``tests/test_torch_differentiable.py``)."""
    from zoic_tpu_torch import sampling, trace
    from zoic_tpu_torch.optics import V3

    lens = dataclasses.replace(
        lens, curvature=curvature,
        center=torch.cumsum(lens.thickness, 0) - curvature)
    lx, ly = sampling.concentric_disk_sample(u[0], u[1])
    z = torch.zeros_like(u[0])
    res = trace.trace_stack(
        lens, V3(z, z, z + lens.origin_shift),
        V3(lx * lens.user_aperture_radius * 2.0,
           ly * lens.user_aperture_radius * 2.0, z - lens.thickness[0]))
    t = (lens.focal_distance - res.origin.z) / res.direction.z
    hx = res.origin.x + res.direction.x * t
    hy = res.origin.y + res.direction.y * t
    w = res.ok.to(torch.float32)
    return torch.sqrt(((hx * hx + hy * hy) * w).sum()
                      / torch.clamp_min(w.sum(), 1.0))


@pytest.mark.cuda
def test_autograd_on_card(cuda_dev):
    """The spot RMS's gradient by ``torch.autograd`` through the eager
    trace on the card: finite, non-zero, within 1e-3 of the CPU's."""
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("tessar_f2.8"),
        focal_length=5.0, fstop=2.8, focal_distance=100.0,
        kolb_sampling_lut=False, pupil_precheck=False)
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, 1024)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_dev):
        lens = zpt.compile_camera(cfg, dev).lens
        c = lens.curvature.detach().clone().requires_grad_(True)
        loss = _spot_rms(lens, c, u.to(dev))
        (g,) = torch.autograd.grad(loss, c)
        grads.append(g.cpu())
    assert torch.isfinite(grads[1]).all() and float(grads[1].abs().max()) > 0
    assert float(torch.linalg.norm(grads[1] - grads[0])) <= (
        1e-3 * float(torch.linalg.norm(grads[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("lut", [True, False], ids=["lut", "naive"])
def test_tape_on_card_matches_cpu(cuda_state, lut):
    """The ray tape traced on the card and on the CPU from the same
    samples and state: the same segments, hit points within 1e-5, exit
    endpoints (x 10,000) within 1e-5 relative."""
    from zoic_tpu_torch.diag import tape

    cfg = _headline_cfg(kolb_sampling_lut=lut)
    s = _inputs(4_096, seed=23)
    got = tape.raytraced_tape(cuda_state, cfg, *s, stride=8)
    want = tape.raytraced_tape(cuda_state.to("cpu"), cfg,
                               *(a.cpu() for a in s), stride=8)
    assert len(want) > 512
    hit_err, exit_rel = tape.segment_errors(got, want)
    assert hit_err <= 1e-5 and exit_rel <= 1e-5


@pytest.mark.cuda
def test_camera_draw_on_card_keeps_the_rays(cuda_dev, tmp_path):
    """``Camera`` in draw mode on the card returns the draw-off call's
    rays bit for bit, raytraced and thin lens, and keeps one tape a
    call, written by ``session.write_dump``."""
    from zoic_tpu_torch.diag import dump, session

    s = _inputs(100_000, seed=24)
    for cfg in (_headline_cfg(pupil_precheck=False),
                zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS,
                                 focal_length=5.0, fstop=1.4,
                                 focal_distance=100.0, use_dof=True)):
        drawn = cfg.replace(debug=zpt.DebugOptions(draw=True,
                                                   draw_stride=1_000))
        cam = zpt.Camera(drawn)
        got, _ = cam.create_rays(*s, seed=11)
        want, _ = zpt.create_rays(cam.state, cfg, *s, seed=11)
        for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert len(cam._draw_segments) == 1
        path = session.write_dump(cam.state, cam.config, cam._draw_segments,
                                  str(tmp_path))
        rays = dump.parse_file(path)["RAYS"]
        assert rays.shape == cam._draw_segments[0].shape and len(rays) >= 100
