"""Camera-ray generation kernels: the CUDA kernels' wrappers and their plain
PyTorch versions, for the raytraced model and for the thin-lens model.

Port of ``zoic_tpu/ops/trace_kernel.py:raytraced_fused`` for the main
path's flags: exit-pupil LUT shaping, the pupil pre-check with the
2-circle bound evaluated from its polynomial fit, the static per-element
flags and the iris refract-identity skip.  Each ray walks its own draws in
order: draw 0 is the caller's ``(u1, u2)`` and consumes no try; retry ``c``
draws from a stateless counter hash keyed by ``(ray id, seed, c)``.  A ray
whose per-ray bound rejects the whole aperture disk takes its whole budget
at once; a draw outside the bound consumes a try without a trace.  Because
the draws are keyed by the ray's own try count, a ray's result does not
depend on how retries are scheduled, which is why a GPU thread per ray
gives the same result as the TPU's compacted tiles.

:func:`raytraced_fused` launches ``csrc/raytraced.cu`` for CUDA tensors
and runs :func:`raytraced_plain` for CPU tensors.  :func:`raytraced_plain`
runs the same per-ray walk over the whole batch as masked tensor ops, one
step per draw index, in the kernel's order of operations.

Port of ``zoic_tpu/ops/trace_kernel.py:thinlens_fused``: the pinhole
direction, the depth-of-field refocus and the empirical-vignetting retry
rounds.  Round 0 takes the caller's draws; round ``rnd`` (1-based) draws a
pending ray's aperture point from the counter hash keyed by (ray id, seed,
``rnd``), or, with image bokeh, reads it from the presampled retry planes
through :func:`retry_plane_index`, the TPU kernel's tile-position map
written out.  :func:`thinlens_fused` launches ``csrc/thinlens.cu`` for
CUDA tensors and runs :func:`thinlens_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..system import LensSystem
from . import _build

Tensor = torch.Tensor

# launches of the CUDA kernel by raytraced_fused (plain CPU runs not counted)
launches = 0
# launches of the CUDA kernel by thinlens_fused (plain CPU runs not counted)
thinlens_launches = 0

# shared-memory table capacities of csrc/raytraced.cu
MAX_ELEMS, MAX_KEYS, MAX_COEF = 64, 128, 32

SALT_U1, SALT_U2 = 0x11111111, 0x22222222

# the TPU thin-lens kernel's lane width and default tile rows: they decide
# which retry-plane cell a ray reads in each round (retry_plane_index)
LANES = 128
DEF_TILE_ROWS = 64


def _f32(x: float) -> float:
    """A Python constant rounded to float32, as JAX's weak typing rounds it."""
    return float(np.float32(x))


PI_D = 3.14159265358979323  # zoic_tpu.optics.PI
PI = _f32(PI_D)
TWO_PI = _f32(2 * PI_D)
HALF_PI = _f32(PI_D * 0.5)          # == PI_OVER_2 = PI / 2.0
PI_OVER_4 = _f32(0.78539816339)     # the reference's literal (zoic.cpp:695)
SIN_B = _f32(4.0 / PI_D)
SIN_C = _f32(-4.0 / (PI_D * PI_D))
SIN_P = _f32(0.225)
SAMPLING_ERROR_CORRECTION = _f32(1.05)  # zoic_tpu.pupil, zoic.cpp:1463
TINY = _f32(1e-35)
BIG = _f32(1e9)
TWO_M24 = 2.0 ** -24

# ------------------------------------------------------------- host tables


def pack_elements(lens: LensSystem) -> Tensor:
    """f32[E, 8] per-element constants ``[center_z, eta^2, 1/R, R^2,
    cull_r^2, eta, tir_thr, sign_r]`` (``_pack_elements``); the iris cull
    is clamped to the user aperture radius."""
    ones = torch.ones(1, dtype=torch.float32, device=lens.ior.device)
    ior_next = torch.cat([lens.ior[1:], ones])
    half_ap = lens.aperture * 0.5
    cull_r_sq = half_ap * half_ap
    ae = lens.aperture_element
    if ae >= 0:
        ua_sq = lens.user_aperture_radius * lens.user_aperture_radius
        cull_r_sq = cull_r_sq.clone()
        cull_r_sq[ae] = torch.minimum(cull_r_sq[ae], ua_sq)
    eta = lens.ior / ior_next
    tir_thr = torch.where(
        lens.ior > ior_next, 1.0, float("inf")
    ).to(torch.float32)
    sign_r = torch.where(lens.curvature < 0.0, -1.0, 1.0).to(torch.float32)
    return torch.stack(
        [
            lens.center,
            eta * eta,
            1.0 / lens.curvature,
            lens.curvature * lens.curvature,
            cull_r_sq,
            eta,
            tir_thr,
            sign_r,
        ],
        dim=1,
    )


def shaping_table(lens: LensSystem) -> Tuple[Tensor, Tensor]:
    """f32[n_keys, 6] ``[max_scale*1.05, centroid_x, c0, c1, c2, c4]`` per
    film-radius key and the uniform key spacing (``_shaping_table`` with
    the LUT and the profile on).  The 1.05 margin is folded into the
    table in float32 before the lerp."""
    lut, prof = lens.lut, lens.profile
    ms = lut.max_scale * SAMPLING_ERROR_CORRECTION
    table = torch.stack(
        [ms, lut.centroid_x, prof.c0, prof.c1, prof.c2, prof.c4], dim=1
    )
    spacing = lut.keys[1] - lut.keys[0]
    return table, spacing


def kernel_scalars(lens: LensSystem, sensor_width: Tensor, spacing: Tensor,
                   seed: int, batch: int) -> Tensor:
    """f32[8] ``[origin_shift, -thickness[0], seed, aperture[0], spacing,
    batch, sensor_width/2, 1/poly_scale]``, the scalars
    ``raytraced_fused`` packs."""
    dev = lens.ior.device
    f = torch.float32
    sw = torch.as_tensor(sensor_width, dtype=f, device=dev)
    inv_dmax = 1.0 / lens.profile.poly_scale.to(f)
    return torch.stack(
        [
            lens.origin_shift.to(f),
            -lens.thickness[0],
            torch.tensor(float(seed), dtype=f, device=dev),
            lens.aperture[0],
            spacing.to(f),
            torch.tensor(float(batch), dtype=f, device=dev),
            sw * 0.5,
            inv_dmax,
        ]
    )


def check_supported(lens: LensSystem) -> None:
    """Raise for lens states outside this kernel's variant."""
    if lens.lut is None:
        raise NotImplementedError(
            "raytraced kernel without the exit-pupil LUT: ROADMAP Queue 1 "
            "item 1 (raytraced variants)"
        )
    prof = lens.profile
    if prof is None:
        raise NotImplementedError(
            "raytraced kernel without the pupil pre-check: ROADMAP Queue 1 "
            "item 1 (raytraced variants)"
        )
    if prof.kind != "circles":
        raise NotImplementedError(
            f"pre-check bound kind {prof.kind!r}: only 'circles' is ported "
            "(harmonic bound: ROADMAP Queue 1 item 1, raytraced variants)"
        )
    if not lens.profile_poly or prof.poly is None:
        raise NotImplementedError(
            "pre-check from the per-key select chain (profile_poly=False): "
            "ROADMAP Queue 1 item 1 (raytraced variants)"
        )
    if len(lens.elem_flags) != lens.count:
        raise NotImplementedError(
            "lens state without static element flags: ROADMAP Queue 1 "
            "item 1 (raytraced variants)"
        )


# ------------------------------------------------------- per-ray functions


def _mul32(h: Tensor, k: int) -> Tensor:
    """(h * k) mod 2^32 on int64 tensors holding uint32 values, split in
    16-bit halves of ``k`` so that no product overflows int64."""
    lo = h * (k & 0xFFFF)
    hi = ((h * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def hash_uniform(ids: Tensor, seed: int, ctr: Tensor, salt: int) -> Tensor:
    """Counter-hash U[0, 1) (``_hash_uniform``): murmur3-style mix of
    (ray id, seed, try counter, salt) in uint32 arithmetic, done in int64
    with a 32-bit mask after every add and multiply; 24 bits to float."""
    m = 0xFFFFFFFF
    h = _mul32(ids.to(torch.int64) & m, 2654435761)
    h = (h + (seed & m)) & m
    h = (h + _mul32(ctr.to(torch.int64) & m, 0x9E3779B9)) & m
    h = (h + salt) & m
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.int32).to(torch.float32) * TWO_M24


def _sin_poly(x: Tensor) -> Tensor:
    y = SIN_B * x + SIN_C * x * torch.abs(x)
    return SIN_P * (y * torch.abs(y) - y) + y


def fast_sin(x: Tensor) -> Tensor:
    x = x - torch.floor((x + PI) / TWO_PI) * TWO_PI
    return _sin_poly(x)


def fast_cos(x: Tensor) -> Tensor:
    return fast_sin(x + HALF_PI)


def concentric(u1: Tensor, u2: Tensor) -> Tuple[Tensor, Tensor]:
    """Concentric disk map with one divide and the conditional 2 pi shift
    (``_concentric``)."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    use_a = (a * a) > (b * b)
    r = torch.where(use_a, a, b)
    num = torch.where(use_a, b, a)
    den = torch.where(use_a, a, b)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    q = PI_OVER_4 * (num / den)
    phi = torch.where(use_a, q, HALF_PI - q)
    xc = phi + HALF_PI
    xc = torch.where(xc > PI, xc - TWO_PI, xc)
    return r * _sin_poly(xc), r * _sin_poly(phi)


def _fast_sqrt(x: Tensor) -> Tensor:
    return x * torch.rsqrt(torch.clamp_min(x, TINY))


def _shaping(fx, fy, table, spacing, prof, inv_dmax):
    """Per-ray LUT lerp, fastSin rotation and pre-check circle coefficients
    (``_shaping_from_table`` with the LUT, the polynomial profile and the
    circle bound)."""
    n_keys = table.shape[0]
    dist = torch.sqrt(fx * fx + fy * fy)
    i_lb = torch.clamp(torch.ceil(dist / spacing).to(torch.int32), 0, n_keys - 1)
    i_prev = torch.clamp_min(i_lb - 1, 0)
    lower = i_lb.to(torch.float32) * spacing
    prev = i_prev.to(torch.float32) * spacing
    denom = prev - lower
    perc = torch.where(denom != 0.0, (dist - lower) / denom,
                       torch.zeros_like(dist))
    perc = torch.where(dist == 0.0, torch.zeros_like(perc), perc)
    lb = table[i_lb.long()]
    pr = table[i_prev.long()]
    ms = lb[:, 0] + perc * (pr[:, 0] - lb[:, 0])
    trn = lb[:, 1] + perc * (pr[:, 1] - lb[:, 1])
    theta = torch.atan2(fy, fx)
    sn = fast_sin(theta)
    cs = fast_cos(theta)

    t_raw = dist * inv_dmax
    t = torch.clamp_max(t_raw, 1.0)
    deg = len(prof[0]) - 1
    pcs = []
    for j in range(4):
        acc = torch.zeros_like(t) + prof[j][deg]
        for k in range(deg - 1, -1, -1):
            acc = acc * t + prof[j][k]
        pcs.append(acc)
    a1, q1, a2, q2 = pcs
    off = t_raw > 1.0
    q1 = torch.where(off, torch.full_like(q1, BIG), q1)
    q2 = torch.where(off, torch.full_like(q2, BIG), q2)
    # pre-doubled circle centers
    a1d = a1 * 2.0
    a2d = a2 * 2.0
    return ms, trn, sn, cs, (a1d, q1, a2d, q2)


def _bound_pass(lx, ly, pcs):
    a1d, q1, a2d, q2 = pcs
    rr = lx * lx + ly * ly
    return ((rr - a1d * lx) <= q1) & ((rr - a2d * lx) <= q2)


def _bound_dead(pcs):
    a1d, q1, a2d, q2 = pcs

    def mn(a):
        aa = torch.abs(a)
        return torch.where(aa <= 2.0, -0.25 * a * a, 1.0 - aa)

    return (mn(a1d) > q1) | (mn(a2d) > q2)


def _trace(elems: List[List[float]], flags, iris_idx, ox, oy, oz, dx, dy, dz):
    """Element-stack trace with a latched ``fail`` that freezes a ray at
    its last reached hit (``_trace_block`` with static flags)."""
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    fail = torch.zeros_like(ox, dtype=torch.bool)
    tir_any = torch.zeros_like(fail)
    for i, (cz, eta_sq, inv_r, r_sq, cull_r_sq, eta, _thr, _sign) in enumerate(
        elems
    ):
        lz = cz - oz
        tca = lz * dz - (ox * dx + oy * dy)
        px = ox + tca * dx
        py = oy + tca * dy
        pz = lz - tca * dz
        d2 = px * px + py * py + pz * pz
        thc = _fast_sqrt(torch.abs(r_sq - d2))
        t = tca - thc if flags[i] & 2 else tca + thc
        hx = ox + dx * t
        hy = oy + dy * t
        h2 = hx * hx + hy * hy
        fail = fail | (d2 > r_sq) | (h2 > cull_r_sq)
        ox = torch.where(fail, ox, hx)
        oy = torch.where(fail, oy, hy)
        oz = torch.where(fail, oz, oz + dz * t)
        if i == iris_idx:
            continue  # eta == 1 at the iris: refraction is the identity
        wz = cz - oz
        c1 = ((ox * dx + oy * dy) - wz * dz) * inv_r
        cs2 = eta_sq * (1.0 - c1 * c1)
        if flags[i] & 1:
            tir = (cs2 > 1.0) & ~fail
            tir_any = tir_any | tir
            fail = fail | tir
        k = eta * c1 - _fast_sqrt(torch.abs(1.0 - cs2))
        kk = (k * inv_r).masked_fill(fail, 0.0)
        ee = torch.full_like(k, eta).masked_fill(fail, 1.0)
        dx = dx * ee - ox * kk
        dy = dy * ee - oy * kk
        dz = dz * ee + wz * kk
    return ox, oy, oz, dx, dy, dz, ~fail, tir_any


# ----------------------------------------------------------- entry points


def _prepare(lens, sensor_width, seed, batch):
    check_supported(lens)
    elems = pack_elements(lens)
    table, spacing = shaping_table(lens)
    prof = lens.profile.poly.to(torch.float32).contiguous()
    scal = kernel_scalars(lens, sensor_width, spacing, seed, batch)
    iris_idx = lens.aperture_element if lens.iris_identity else -1
    return elems, table, prof, scal, iris_idx


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < (1 << 22):
        raise ValueError(f"seed must be in [0, 2**22), got {seed}")
    return seed


def raytraced_plain(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, *, max_tries: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel on any device: returns
    ``(origin[B,3], dir[B,3], tries[B] i32, tir[B] i32)``."""
    seed = _check_seed(seed)
    b = sx.shape[0]
    elems_t, table, prof, scal, iris_idx = _prepare(lens, sensor_width, seed, b)
    elems = elems_t.tolist()
    flags = lens.elem_flags
    origin_shift, dz0, _, _, spacing, _, sensor_half, inv_dmax = scal.tolist()
    max_total = max_tries + 1
    dev = sx.device

    fx = sx * sensor_half
    fy = sy * sensor_half
    ms, trn, sn, cs, pcs = _shaping(
        fx, fy, table, spacing, prof.tolist(), inv_dmax
    )
    sa, sb = ms * cs, ms * sn
    kx, ky = trn * cs - fx, trn * sn - fy

    dead = _bound_dead(pcs)
    tries = torch.where(dead, max_total, 0).to(torch.int32)
    ok = torch.zeros(b, dtype=torch.bool, device=dev)
    tir = torch.zeros(b, dtype=torch.int32, device=dev)
    payload = [torch.zeros(b, dtype=torch.float32, device=dev)
               for _ in range(6)]
    ids = torch.arange(b, dtype=torch.int64, device=dev)

    for step in range(max_total + 1):
        if step == 0:
            active = ~dead  # draw 0 is the caller's and consumes no try
            lx, ly = concentric(u1, u2)
        else:
            active = ~ok & (tries < max_total)
            if not bool(active.any()):
                break
            h1 = hash_uniform(ids, seed, tries, SALT_U1)
            h2 = hash_uniform(ids, seed, tries, SALT_U2)
            lx, ly = concentric(h1, h2)
            tries = tries + active.to(torch.int32)
        take = (active & _bound_pass(lx, ly, pcs)).nonzero().squeeze(1)
        if take.numel() == 0:
            continue
        g_lx, g_ly = lx[take], ly[take]
        g_sa, g_sb = sa[take], sb[take]
        dx = g_lx * g_sa - g_ly * g_sb + kx[take]
        dy = g_lx * g_sb + g_ly * g_sa + ky[take]
        g_fx = fx[take]
        fz = torch.full_like(g_fx, origin_shift)
        dz = torch.full_like(g_fx, dz0)
        *res, nok, ntir = _trace(
            elems, flags, iris_idx, g_fx, fy[take], fz, dx, dy, dz
        )
        for p, r in zip(payload, res):
            p[take] = r
        ok[take] = nok
        tir[take] += ntir.to(torch.int32)

    origin = -torch.stack(payload[:3], dim=-1)
    direction = -torch.stack(payload[3:], dim=-1)
    return origin, direction, tries, tir


def _kernel_lib():
    lib = _build.load("raytraced")
    fn = lib.zoic_raytraced_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_input(name: str, t: Tensor, b: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.shape != (b,):
        raise ValueError(
            f"{name} must be float32 of shape ({b},) on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


# (id(lens), id(sensor_width), device) -> (weakref(lens),
# weakref(sensor_width), tables): the kernel's tables are constants of a
# compiled state, so they are packed once per state, not once per call
_TABLES: dict = {}


def _kernel_tables(lens: LensSystem, sensor_width, dev):
    """``(elems, flags, shap, prof, scal, iris_idx)`` on ``dev`` for the
    kernel.  The seed and batch slots of ``scal`` hold 0: the kernel takes
    both as int arguments."""
    key = (id(lens), id(sensor_width), str(dev))
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is lens and hit[1]() is sensor_width:
        return hit[2]
    elems, shap, prof, scal, iris_idx = _prepare(lens, sensor_width, 0, 0)
    n_elems, n_keys, n_coef = elems.shape[0], shap.shape[0], prof.shape[1]
    if n_elems > MAX_ELEMS or n_keys > MAX_KEYS or n_coef > MAX_COEF:
        raise ValueError(
            f"lens tables ({n_elems} elements, {n_keys} keys, {n_coef} "
            f"coefficients) exceed the kernel's ({MAX_ELEMS}, {MAX_KEYS}, "
            f"{MAX_COEF})"
        )
    flags = torch.tensor(lens.elem_flags, dtype=torch.int32, device=dev)
    elems, shap, prof, scal = (t.to(dev, torch.float32).contiguous()
                               for t in (elems, shap, prof, scal))
    tables = (elems, flags, shap, prof, scal, iris_idx)
    if isinstance(sensor_width, Tensor):
        for k in [k for k, v in _TABLES.items()
                  if v[0]() is None or v[1]() is None]:
            del _TABLES[k]
        _TABLES[key] = (weakref.ref(lens), weakref.ref(sensor_width), tables)
    return tables


def raytraced_fused(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, *, max_tries: int, use_lut: bool = True,
    use_profile: bool = True,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused raytraced camera-ray generation over flat ``[B]`` inputs.

    Returns ``(origin[B,3], dir[B,3], tries[B] i32, tir[B] i32)``, where
    ``tries`` counts the retry draws a ray consumed and ``tir`` its
    attempts that failed by total internal reflection.  CUDA tensors
    launch ``csrc/raytraced.cu``; CPU tensors run :func:`raytraced_plain`.
    """
    global launches
    if not (use_lut and use_profile):
        raise NotImplementedError(
            "raytraced kernel variants without the LUT or the pre-check: "
            "ROADMAP Queue 1 item 1 (raytraced variants)"
        )
    if sx.device.type == "cpu":
        return raytraced_plain(lens, sx, sy, u1, u2, sensor_width, seed,
                               max_tries=max_tries)
    if sx.device.type != "cuda":
        raise ValueError(f"unsupported device {sx.device}")
    seed = _check_seed(seed)
    b = sx.shape[0]
    dev = sx.device
    for name, t in (("sx", sx), ("sy", sy), ("u1", u1), ("u2", u2)):
        _check_input(name, t, b, dev)
    elems, flags, shap, prof, scal, iris_idx = _kernel_tables(
        lens, sensor_width, dev
    )
    ins = [t.contiguous() for t in (sx, sy, u1, u2)]
    origin = torch.empty((b, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((b, 3), dtype=torch.float32, device=dev)
    tries = torch.empty((b,), dtype=torch.int32, device=dev)
    tir = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return origin, direction, tries, tir
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ins),
            elems.data_ptr(), flags.data_ptr(), shap.data_ptr(),
            prof.data_ptr(), scal.data_ptr(),
            origin.data_ptr(), direction.data_ptr(), tries.data_ptr(),
            tir.data_ptr(),
            b, elems.shape[0], shap.shape[0], prof.shape[1], iris_idx,
            max_tries + 1, seed, stream,
        )
    if err != 0:
        raise RuntimeError(f"raytraced kernel launch failed: CUDA error {err}")
    launches += 1
    return origin, direction, tries, tir


# -------------------------------------------------------------- thin lens


def retry_plane_layout(b: int, bp: int) -> Tuple[int, int, bool]:
    """``(tile_rows, plane_tiles, reuse)`` of the TPU thin-lens kernel for
    ``b`` rays and retry planes of ``bp`` draws.

    ``tile_rows`` starts at ``DEF_TILE_ROWS`` and is halved while the batch
    fits in half a tile (``thinlens_fused``); planes shorter than a tile
    wrap to ``plane_tiles`` whole tiles (``_prep_retry_planes``);
    ``reuse`` says whether grid tiles share plane blocks, which adds the
    per-reuse rotation."""
    rows = -(-b // LANES)
    tile_rows = DEF_TILE_ROWS
    while tile_rows >= 32 and rows <= tile_rows // 2:
        tile_rows //= 2
    grid = -(-rows // tile_rows)
    plane_tiles = -(-bp // (tile_rows * LANES))
    return tile_rows, plane_tiles, plane_tiles < grid


def retry_plane_index(ids: Tensor, rnd: int, n_planes: int, bp: int,
                      tile_rows: int, plane_tiles: int,
                      reuse: bool) -> Tuple[int, Tensor]:
    """``(plane, position)`` of round ``rnd``'s presampled retry draw for
    the rays at flat indices ``ids``.

    The TPU kernel lays ray ``i`` at row ``R = i // 128``, lane
    ``l = i % 128`` of tile ``t = R // tile_rows``, row ``r`` in it; tile
    ``t`` reads plane block ``t % plane_tiles``.  Round ``rnd`` reads plane
    ``(rnd-1) % P`` rolled down by ``shift`` rows and right by ``lsh``
    lanes (a roll moves element ``j`` to ``j + s``), where the reuse cycle
    ``(rnd-1) // P`` and, when tiles share blocks, the reuse index
    ``t // plane_tiles`` set the shifts."""
    rr, lane = ids // LANES, ids % LANES
    t, r = rr // tile_rows, rr % tile_rows
    pidx, cyc = (rnd - 1) % n_planes, (rnd - 1) // n_planes
    t_reuse = t // plane_tiles if reuse else torch.zeros_like(t)
    shift = (3 * cyc + 5 * t_reuse) % tile_rows
    lsh = (21 * t_reuse) % LANES
    row = (t % plane_tiles) * tile_rows + (r - shift) % tile_rows
    return pidx, (row * LANES + (lane - lsh) % LANES) % bp


def _retry_planes(retry_u1, retry_u2, dev) -> Tuple[Tensor, Tensor]:
    """The presampled retry planes ``[P, Bp]``; zeros ``[1, 128]`` when the
    caller gave none, as ``thinlens_fused`` does."""
    if retry_u1 is None:
        z = torch.zeros((1, LANES), dtype=torch.float32, device=dev)
        return z, z
    if retry_u1.dim() != 2 or retry_u1.shape != retry_u2.shape:
        raise ValueError(
            f"retry planes must be [P, Bp] of one shape, got "
            f"{tuple(retry_u1.shape)} and {tuple(retry_u2.shape)}"
        )
    return retry_u1, retry_u2


def _f32_scalar(x) -> float:
    return float(np.float32(float(x)))


def _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr, has_ov):
    """One aperture attempt: scale the offset to the aperture, aim through
    the focal-plane point, normalise, and the empirical-vignetting test
    (``_thinlens_kernel.attempt``; the reference's ABS on the sqrt is the
    identity and is dropped)."""
    lx = lx * ap
    ly = ly * ap
    ddx = fx - lx
    ddy = fy - ly
    inv2 = torch.rsqrt(ddx * ddx + ddy * ddy + fz * fz)
    dx, dy, dz = ddx * inv2, ddy * inv2, fz * inv2
    ok = None
    if has_ov:
        vx = dx * ovd - lx
        vy = dy * ovd - ly
        ok = _fast_sqrt(vx * vx + vy * vy) < thr
    return [lx, ly, dx, dy, dz], ok


def thinlens_plain(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov,
    aperture_radius, focal_distance, ov_distance, ov_radius, seed: int, *,
    use_dof: bool, has_ov: bool, max_tries: int, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the thin-lens kernel on any device:
    returns ``(origin[B,3], dir[B,3], tries[B] i32)``."""
    seed = _check_seed(seed)
    b = sx.shape[0]
    dev = sx.device
    tan_fov, ap, focal, ovd, ovr = (_f32_scalar(v) for v in (
        tan_fov, aperture_radius, focal_distance, ov_distance, ov_radius))
    thr = float(np.float32(ap) * np.float32(ovr))

    px = sx * tan_fov
    py = sy * tan_fov
    inv = torch.rsqrt(px * px + py * py + 1.0)
    pdx, pdy, pdz = px * inv, py * inv, inv
    zeros = torch.zeros_like(sx)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    if not use_dof:
        return (torch.stack([zeros, zeros, zeros], -1),
                torch.stack([pdx, pdy, -pdz], -1), tries)

    # true division by the ray's z (a Python scalar numerator would make
    # PyTorch multiply by the reciprocal)
    focal_t = torch.tensor(focal, dtype=torch.float32, device=dev)
    t = torch.abs(focal_t / pdz)
    fx, fy, fz = pdx * t, pdy * t, pdz * t
    lx, ly = (u1, u2) if presampled else concentric(u1, u2)
    pay, ok = _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr, has_ov)

    if has_ov:
        ids = torch.arange(b, dtype=torch.int64, device=dev)
        if presampled:
            bu1, bu2 = _retry_planes(retry_u1, retry_u2, dev)
            n_planes, bp = bu1.shape
            layout = retry_plane_layout(b, bp)
        pending = ~ok
        for rnd in range(1, max_tries + 2):
            if not bool(pending.any()):
                break
            if presampled:
                pidx, pos = retry_plane_index(ids, rnd, n_planes, bp, *layout)
                lx, ly = bu1[pidx][pos], bu2[pidx][pos]
            else:
                ctr = torch.full_like(ids, rnd)
                lx, ly = concentric(hash_uniform(ids, seed, ctr, SALT_U1),
                                    hash_uniform(ids, seed, ctr, SALT_U2))
            new, nok = _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr, True)
            pay = [torch.where(pending, n, o) for n, o in zip(new, pay)]
            tries = torch.where(pending, rnd, tries).to(torch.int32)
            pending = pending & ~nok

    lx, ly, dx, dy, dz = pay
    return (torch.stack([lx, ly, zeros], -1), torch.stack([dx, dy, -dz], -1),
            tries)


def _thinlens_lib():
    lib = _build.load("thinlens")
    fn = lib.zoic_thinlens_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def thinlens_fused(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov,
    aperture_radius, focal_distance, ov_distance, ov_radius, seed: int, *,
    use_dof: bool, has_ov: bool, max_tries: int, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused thin-lens camera-ray generation over flat ``[B]`` inputs.

    Returns ``(origin[B,3], dir[B,3], tries[B] i32)``.  With
    ``presampled`` the ``(u1, u2)`` inputs are [-1, 1] aperture offsets
    (image bokeh) and, with vignetting, retry draws come from the
    ``[P, Bp]`` planes ``retry_u1/retry_u2``.  CUDA tensors launch
    ``csrc/thinlens.cu``; CPU tensors run :func:`thinlens_plain`."""
    global thinlens_launches
    args = (sx, sy, u1, u2, tan_fov, aperture_radius, focal_distance,
            ov_distance, ov_radius, seed)
    flags = dict(use_dof=use_dof, has_ov=has_ov, max_tries=max_tries,
                 presampled=presampled, retry_u1=retry_u1, retry_u2=retry_u2)
    if sx.device.type == "cpu":
        return thinlens_plain(*args, **flags)
    if sx.device.type != "cuda":
        raise ValueError(f"unsupported device {sx.device}")
    seed = _check_seed(seed)
    b = sx.shape[0]
    dev = sx.device
    for name, t in (("sx", sx), ("sy", sy), ("u1", u1), ("u2", u2)):
        _check_input(name, t, b, dev)
    scal = torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
        for v in (tan_fov, aperture_radius, focal_distance, ov_distance,
                  ov_radius)
    ])
    bu1 = bu2 = None
    n_planes = bp = tile_rows = plane_tiles = reuse = 0
    if presampled and has_ov:
        bu1, bu2 = _retry_planes(retry_u1, retry_u2, dev)
        for name, t in (("retry_u1", bu1), ("retry_u2", bu2)):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 on {dev}, got "
                                 f"{t.dtype} on {t.device}")
        bu1, bu2 = bu1.contiguous(), bu2.contiguous()
        n_planes, bp = bu1.shape
        tile_rows, plane_tiles, reuse = retry_plane_layout(b, bp)
    ins = [t.contiguous() for t in (sx, sy, u1, u2)]
    origin = torch.empty((b, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((b, 3), dtype=torch.float32, device=dev)
    tries = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return origin, direction, tries
    fn = _thinlens_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ins),
            bu1.data_ptr() if bu1 is not None else None,
            bu2.data_ptr() if bu2 is not None else None,
            scal.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tries.data_ptr(),
            b, int(use_dof), int(has_ov), int(presampled), max_tries + 1,
            seed, n_planes, bp, tile_rows, plane_tiles, int(reuse), stream,
        )
    if err != 0:
        raise RuntimeError(f"thinlens kernel launch failed: CUDA error {err}")
    thinlens_launches += 1
    return origin, direction, tries
