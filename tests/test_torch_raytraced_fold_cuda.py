"""The raytraced model's finished rays on a card: ``csrc/raytraced.cu``
writing weight, exposure, derivatives and counters at its own store site
(``trace_kernel.raytraced_rays``), against its plain composition.

Imports no jax; on a machine without JAX leave out ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_raytraced_fold_cuda.py -q

On every one of the kernel's 20 variant words, at sizes that leave a
partly filled last tile, at exposures below, at and above 0: every
output of ``raytraced_rays`` bit-equal (signed zeros included) to
``epilogue_plain`` on ``raytraced_fused``'s rays, and within the
kernel-against-plain contract of ``tests/test_torch_cuda.py`` of
``raytraced_rays_plain`` (``raytraced_plain`` then ``epilogue_plain``,
computed on the card).  A Petzval batch in raster order, rich in tiles
of 32 dead keys, and outputs off the 16-byte alignment (which must take
the per-ray store); the counting build's ``whole_tiles`` against the
wholly dead tiles counted from the plain prologue; ``raytraced_fused``'s
outputs against the digests of the bits it gave before the finished-ray
mode existed; the launch counter; the kernel's draws and traces against
the plain version's count, with and without a profiler recording.
Without a card each test skips: the kernel has no CPU mode.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import _launch
from zoic_tpu_torch.ops import epilogue_kernel as ek
from zoic_tpu_torch.ops import trace_kernel as tk
from zoic_tpu_torch.utils import profiling

SEED = 99
MAX_TRIES = 25
EXPOSURES = (-0.5, 0.0, 2.0)
FIELDS = ("origin", "dir", "weight", "d_ody", "d_ddy", "stats")
# every word of bits the kernel has an instance for (ZOIC_RAYTRACED_INSTANCES)
WORDS = (0, 1, 2, 3, 6, 7, 10, 11, 14, 15, 16, 17, 18, 19, 22, 23, 26, 27,
         30, 31)
PETZVAL = "raytraced_petzval_f1.25_focus1000"


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


_STATES = {}


def _state(name, dev):
    if name not in _STATES:
        cam = zpt.data.CAMERAS[name]
        _STATES[name] = zpt.load_state(zpt.data.state_path(cam.file),
                                       device=dev)
    return _STATES[name]


def _realise(word, dev):
    """A shipped state and the flags whose variant is ``word``: the
    headline for the circle bound (and no pre-check), the fisheye for the
    harmonic one, the image-bokeh camera for the presampled circle bound;
    the profile's polynomial switched by ``profile_poly``, and the
    fisheye's profile taken as fitted over the square where the draws are
    presampled."""
    lut, prof = bool(word & 1), bool(word & 2)
    poly, circles, pre = bool(word & 4), bool(word & 8), bool(word & 16)
    if not prof:
        name = "headline"
    elif circles:
        name = "raytraced_bokeh_image" if pre else "headline"
    else:
        name = "raytraced_fisheye"
    st = _state(name, dev)
    lens = st.lens
    if prof:
        lens = dataclasses.replace(lens, profile_poly=poly)
        if pre:
            lens = dataclasses.replace(lens, profile_domain="square")
    flags = dict(use_lut=lut, use_profile=prof, presampled=pre)
    assert tk.variant_word(tk.variant(lens, lut, prof, pre), pre) == word
    return st, lens, flags


def _inputs(word, n, flags, dev):
    """Uniform samples made with numpy from the word and the size, and
    retry planes where the draws are presampled."""
    rng = np.random.default_rng(word)
    lo = -1.0 if flags["presampled"] else 0.0
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(lo, 1, n), rng.uniform(lo, 1, n)]
    args = [torch.from_numpy(c.astype(np.float32)).to(dev) for c in cols]
    kw = dict(flags, max_tries=MAX_TRIES)
    if flags["presampled"]:
        kw.update({k: torch.from_numpy(rng.uniform(-1, 1, (4, 8192)).astype(
            np.float32)).to(dev) for k in ("retry_u1", "retry_u2")})
    return args, kw


def _raster(width, rows, dev, seed=5):
    """Camera samples in a frame's raster order: 9 jittered samples a
    pixel (AA 3) over ``rows`` rows of a ``width``-pixel frame of aspect
    16:9, its middle rows, and uniform lens samples."""
    g = torch.Generator(device=dev).manual_seed(seed)
    height = width * 9 // 16
    y0 = (height - rows) // 2
    y, x = torch.meshgrid(torch.arange(rows, device=dev) + y0,
                          torch.arange(width, device=dev), indexing="ij")
    j = torch.arange(9, device=dev)
    px = x.reshape(-1, 1) + ((j % 3) + torch.rand(
        (rows * width, 9), generator=g, device=dev)) / 3
    py = y.reshape(-1, 1) + ((j // 3) + torch.rand(
        (rows * width, 9), generator=g, device=dev)) / 3
    sx = (px / width * 2 - 1).reshape(-1)
    sy = ((1 - py / height * 2) * height / width).reshape(-1)
    n = sx.shape[0]
    return [sx, sy, torch.rand(n, generator=g, device=dev),
            torch.rand(n, generator=g, device=dev)]


def _composition(fused, exposure):
    """``epilogue_plain`` on the kernel's own rays."""
    origin, direction, tries, tir = fused
    return (origin, direction) + ek.epilogue_plain(
        tries, tir, origin, direction, exposure, MAX_TRIES)


def _assert_bits_equal(got, want):
    for name, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


def _dead_keys(lens, sx, sy, sensor_width, flags):
    """Whether the pre-check bound rejects each ray's whole domain, from
    the plain prologue (``raytraced_plain``'s first step)."""
    v = tk.variant(lens, flags["use_lut"], flags["use_profile"],
                   flags["presampled"])
    if not v.use_profile:
        return torch.zeros_like(sx, dtype=torch.bool)
    _, table, prof, scal = tk._prepare(lens, sensor_width, SEED,
                                       sx.shape[0], v)
    *_, spacing, _, half, inv_dmax = scal.tolist()
    *_, pcs = tk._shaping(sx * half, sy * half, table, spacing,
                          prof.tolist(), inv_dmax, v)
    return tk._bound_dead(pcs, v.circles)


def _whole_dead_tiles(dead):
    tiles = dead.shape[0] // 32
    return int(dead[:32 * tiles].reshape(tiles, 32).all(1).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 16 * 128 + 77, 100_003])
@pytest.mark.parametrize("word", WORDS)
def test_raytraced_rays_match_the_plain_composition(cuda_dev, word, n):
    """Every output and the four counters bit-equal to ``epilogue_plain``
    on ``raytraced_fused``'s rays at three exposures; against
    ``raytraced_rays_plain`` at most 1 ray in 10,000 parts in any bit of
    any output (the camera kernel's contract with its plain version); one
    launch a call, and a second launch gives the same bits."""
    st, lens, flags = _realise(word, cuda_dev)
    args, kw = _inputs(word, n, flags, cuda_dev)
    fused = tk.raytraced_fused(lens, *args, st.sensor_width, SEED, **kw)
    for e in EXPOSURES:
        ex = torch.tensor(e, dtype=torch.float32, device=cuda_dev)
        before = tk.raytraced_rays_launches
        got = tk.raytraced_rays(lens, *args, st.sensor_width, SEED, ex, **kw)
        assert tk.raytraced_rays_launches == before + 1
        _assert_bits_equal(got, _composition(fused, ex))
    plain = tk.raytraced_rays_plain(lens, *args, st.sensor_width, SEED, ex,
                                    **kw)
    differ = torch.zeros(n, dtype=torch.bool, device=cuda_dev)
    for g, p in zip(got[:5], plain[:5]):
        ne = g.view(torch.int32) != p.view(torch.int32)
        differ |= ne if ne.dim() == 1 else ne.any(1)
    assert int(differ.sum()) <= max(1, n // 10_000)
    assert int(got[5][:2].sum()) == int(plain[5][:2].sum()) == n
    again = tk.raytraced_rays(lens, *args, st.sensor_width, SEED, ex, **kw)
    _assert_bits_equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 64])
def test_dead_tiles_stored_whole(cuda_dev, rows):
    """The Petzval f/1.25 at 10 m in a frame's raster order: most tiles of
    32 rays are wholly dead.  The counting build stores as many tiles
    whole as the plain prologue finds wholly dead, its outputs equal the
    main build's and the plain composition's bit for bit."""
    st = _state(PETZVAL, cuda_dev)
    flags = dict(use_lut=True, use_profile=True, presampled=False)
    args = _raster(1920, rows, cuda_dev)
    kw = dict(flags, max_tries=MAX_TRIES)
    ex = st.exposure_control
    got = tk.raytraced_rays(st.lens, *args, st.sensor_width, SEED, ex, **kw)
    fused = tk.raytraced_fused(st.lens, *args, st.sensor_width, SEED, **kw)
    _assert_bits_equal(got, _composition(fused, ex))
    counted, n = tk.raytraced_lane_use(st.lens, *args, st.sensor_width, SEED,
                                       ex, **kw)
    _assert_bits_equal(counted, got)
    dead = _dead_keys(st.lens, args[0], args[1], st.sensor_width, flags)
    whole = _whole_dead_tiles(dead)
    assert n["whole_tiles"] == whole
    assert whole > 0.5 * (args[0].shape[0] // 32)


def _entry_launch(st, lens, args, kw, outs, stats, ex, count=False):
    """``zoic_raytraced_launch`` called directly with the finished-ray
    outputs ``outs`` (origin, dir, weight, d_ody, d_ddy pointers)."""
    v = tk.variant(lens, kw["use_lut"], kw["use_profile"], kw["presampled"])
    elems, shap, prof, _, pointers = tk._kernel_tables(
        lens, st.sensor_width, args[0].device, v)
    word = tk.variant_word(v, kw["presampled"])
    defines = (_launch.COUNT_DEFINE,) if count else ()
    n = args[0].shape[0]
    fn = _launch.bind("raytraced", "zoic_raytraced_launch",
                      tk._RAYTRACED_ARGTYPES, defines=defines)
    _launch.launch(
        fn, "raytraced", args[0].device, *(a.data_ptr() for a in args),
        None, None, *pointers, outs[0], outs[1], None, None, ex.data_ptr(),
        *outs[2:], stats.data_ptr(), None, n, elems.shape[0], shap.shape[0],
        prof.shape[1], v.iris_idx, kw["max_tries"] + 1, SEED, word,
        tk.PRECHECK_DRAWS, 0, 0, 0, 0, 0,
        tk.persistent_grid(n, *_launch.blocks_per_sm(
            "raytraced", "zoic_raytraced_blocks_per_sm", [tk.ctypes.c_int],
            args[0].device, word, defines=defines)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [77, 16 * 128 + 77, 100_003])
def test_unaligned_outputs_take_the_per_ray_store(cuda_dev, n):
    """The library's entry given outputs 4 bytes off the 16-byte alignment
    stores every ray by itself, no tile whole, bit-equal to the plain
    composition, on the Petzval's dead tiles."""
    st = _state(PETZVAL, cuda_dev)
    kw = dict(use_lut=True, use_profile=True, presampled=False,
              max_tries=MAX_TRIES)
    args = [a[:n].contiguous() for a in _raster(1920, 8, cuda_dev)]
    ex = torch.tensor(-0.5, dtype=torch.float32, device=cuda_dev)
    want = _composition(
        tk.raytraced_fused(st.lens, *args, st.sensor_width, SEED, **kw), ex)
    sizes = (3 * n, 3 * n, n, 3 * n, 3 * n)
    bufs = [torch.full((s + 1,), float("nan"), device=cuda_dev)
            for s in sizes]
    stats = torch.full((4,), -1, dtype=torch.int32, device=cuda_dev)
    _launch.reset_counts("raytraced")
    _entry_launch(st, st.lens, args, kw, [b.data_ptr() + 4 for b in bufs],
                  stats, ex, count=True)
    whole = _launch.read_counts("raytraced", 3)[2]
    got = [b[1:].reshape(w.shape) for b, w in zip(bufs, want)] + [stats]
    _assert_bits_equal(got, want)
    assert whole == 0


@pytest.mark.cuda
def test_the_entry_refuses_bad_pointers(cuda_dev):
    """Finished rays without a counter buffer, and tries without tir, are
    refused before a launch; a batch of no ray still zeroes the
    counters."""
    st = _state("headline", cuda_dev)
    kw = dict(use_lut=True, use_profile=True, presampled=False,
              max_tries=MAX_TRIES)
    args, _ = _inputs(1, 64, kw, cuda_dev)
    out = torch.empty(64 * 3, device=cuda_dev)
    ex = torch.zeros((), device=cuda_dev)
    stats = torch.full((4,), 7, dtype=torch.int32, device=cuda_dev)
    v = tk.variant(st.lens, True, True, False)
    elems, shap, prof, _, pointers = tk._kernel_tables(
        st.lens, st.sensor_width, cuda_dev, v)
    fn = _launch.bind("raytraced", "zoic_raytraced_launch",
                      tk._RAYTRACED_ARGTYPES)
    head = [*(a.data_ptr() for a in args), None, None, *pointers,
            out.data_ptr(), out.data_ptr()]
    tail = [elems.shape[0], shap.shape[0], prof.shape[1], v.iris_idx,
            MAX_TRIES + 1, SEED, tk.variant_word(v, False),
            tk.PRECHECK_DRAWS, 0, 0, 0, 0, 0, 4]
    p = out.data_ptr()
    for mid in ((None, None, ex.data_ptr(), p, p, p, None, None),
                (p, None, None, None, None, None, None, None)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _launch.launch(fn, "raytraced", cuda_dev, *head, *mid, 64, *tail)
    _launch.launch(fn, "raytraced", cuda_dev, *head, None, None,
                   ex.data_ptr(), p, p, p, stats.data_ptr(), None, 0, *tail)
    torch.cuda.synchronize()
    assert stats.tolist() == [0, 0, 0, 0]
    before = tk.raytraced_rays_launches
    empty = [a[:0] for a in args]
    got = tk.raytraced_rays(st.lens, *empty, st.sensor_width, SEED, ex, **kw)
    assert tk.raytraced_rays_launches == before
    assert got[5].tolist() == [0, 0, 0, 0] and got[2].shape == (0,)


def _digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:20]


# sha256 prefixes of raytraced_fused's (origin, dir, tries, tir) on
# _inputs(word, 100_003) before the kernel wrote finished rays (an NVIDIA
# H100 80GB HBM3, the kernels built by nvcc with --fmad=false)
FUSED_DIGESTS = {
    0: "44fab1ed7d4be5b11858", 1: "590bcf8876c4155a3bd9",
    2: "65c910431ba12d69adfb", 3: "636858b0eda7da11b987",
    6: "e43a460da8a682df2db2", 7: "d59cc1b47476a9759328",
    10: "046b3544913dea7157dd", 11: "da42f098fe651175bdc0",
    14: "8659fdea96e31143a185", 15: "a500d4bc84e097f68357",
    16: "d5c8d1e6d2cccc118c86", 17: "bf5c272b221599547bce",
    18: "a81ec3e74de43c77beb3", 19: "6d2646bf7fdcf4cb2950",
    22: "49c748016fcd119ea0aa", 23: "de856c92fc41f110ead4",
    26: "f76bb328e42057d0cd98", 27: "91a454caff726e552fb6",
    30: "b56053e87945b08661f0", 31: "82b62cae8122984f696e"
}


@pytest.mark.cuda
@pytest.mark.parametrize("word", WORDS)
def test_raytraced_fused_keeps_its_bits(cuda_dev, word):
    """``raytraced_fused`` writes ``tries`` and ``tir`` as it did before
    the kernel could write finished rays: the same bits on every word."""
    st, lens, flags = _realise(word, cuda_dev)
    args, kw = _inputs(word, 100_003, flags, cuda_dev)
    fused = tk.raytraced_fused(lens, *args, st.sensor_width, SEED, **kw)
    assert _digest(fused) == FUSED_DIGESTS[word]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16 * 128 + 77, 100_003])
@pytest.mark.parametrize("word", [3, 11, 15, 31])
def test_draws_and_traces_equal_the_plain_count(cuda_dev, word, n):
    """The kernel handed a totals buffer adds the plain version's draws
    and traces (computed on the card) exactly, and writes the bits of a
    launch without one; under a profiler the entry adds the same counts
    to the device's totals and nothing outside one."""
    st, lens, flags = _realise(word, cuda_dev)
    args, kw = _inputs(word, n, flags, cuda_dev)
    kw = dict(dict(retry_u1=None, retry_u2=None), **kw)
    ex = torch.tensor(-0.5, dtype=torch.float32, device=cuda_dev)
    call = (lens, *args, st.sensor_width, SEED, ex)
    profiling.take_counters()
    bare = tk.raytraced_rays(*call, **kw)
    assert set(profiling.take_counters().values()) == {0}
    counts = torch.zeros(2, dtype=torch.int64, device=cuda_dev)
    _assert_bits_equal(tk._raytraced_launch(*call, counts=counts, **kw),
                       bare)
    want = torch.zeros(2, dtype=torch.int64, device=cuda_dev)
    tk.raytraced_rays_plain(*call, counts=want, **kw)
    assert counts.tolist() == want.tolist()
    draws, traces = want.tolist()
    assert 0 < traces <= draws and draws >= int((bare[2] != 0).sum())
    with profile(activities=[ProfilerActivity.CPU]):
        _assert_bits_equal(tk.raytraced_rays(*call, **kw), bare)
    got = profiling.take_counters()
    assert [got[k] for k in profiling.COUNTERS] == [draws, traces]
