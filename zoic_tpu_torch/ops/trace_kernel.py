"""Camera-ray generation kernels: the CUDA kernels' wrappers and their plain
PyTorch versions, for the raytraced model and for the thin-lens model.

Port of ``zoic_tpu/ops/trace_kernel.py:raytraced_fused``, every variant
``zoic_tpu.create_rays`` reaches: exit-pupil LUT or naive first-element
shaping; the pupil pre-check or none, its bound the 2-circle cover or the
harmonic cos series, evaluated from its polynomial fit or lerped per key
(the select chain); static or table-read element flags; the iris
refract-identity skip; and the presampled (image bokeh) mode.  Each ray
walks its own draws in rounds: round 0 takes the caller's draw, which
consumes no try, and with the pre-check scans up to ``PRECHECK_DRAWS``
more; each retry round scans ``PRECHECK_DRAWS`` draws (one without the
pre-check) until one passes the bound and traces it.  Every draw after the
caller's consumes a try, and a ray whose bound rejects the whole domain
takes its whole budget at once.  Retry draws come from a stateless counter
hash keyed by ``(ray id, seed, try)``, or, presampled, from the retry
planes at the cell :func:`raytraced_plane_index` gives the ray, the draw
index and the batch: the TPU kernel's tile-position map of its whole-tile
loop (``compact=False``), written out.  Either way a ray's draws are a
function of the ray alone, which is why a GPU kernel may run a ray's draws
and traces on whichever lane is free and still give the TPU's per-ray
result.

:func:`raytraced_fused` launches ``csrc/raytraced.cu`` for CUDA tensors (a
persistent grid of warps that take tiles of 32 rays and keep two rings of
rays, before a draw and before a trace, so that 32 lanes draw or trace
together; :func:`persistent_grid` sizes it) and runs
:func:`raytraced_plain` for CPU tensors.  :func:`raytraced_plain`
runs the same rounds over the pending rays as tensor ops, in the kernel's
order of operations.  :func:`raytraced_rays`, the raytraced model's kernel
path, launches the same kernel writing the finished rays (weight,
exposure, derivatives, counters) at its own store site in place of
``tries`` and ``tir``, for CUDA tensors, and runs
:func:`raytraced_rays_plain` (:func:`raytraced_plain`, then
``epilogue_plain``) for CPU tensors.  While a ``torch.profiler`` records,
both entries add the call's aperture draws and the draws that go on to
the element trace to the device's totals
(``utils.profiling.counter_totals``); the plain versions take such a
buffer as ``counts``.

Port of ``zoic_tpu/ops/trace_kernel.py:_thinlens_kernel``: the pinhole
direction, the depth-of-field refocus and the empirical-vignetting retry
rounds.  Round 0 takes the caller's draws; round ``rnd`` (1-based) draws a
pending ray's aperture point from the counter hash keyed by (ray id, seed,
``rnd``), or, with image bokeh, reads it from the presampled retry planes
through :func:`retry_plane_index`.  :func:`thinlens_plain` is the camera
kernel's plain version.  :func:`thinlens_rays`, the thin-lens model's
kernel path, launches ``csrc/thinlens.cu``, which also computes the
epilogue (weight, exposure, derivatives, counters) in its final store, for
CUDA tensors, and runs :func:`thinlens_rays_plain` (:func:`thinlens_plain`,
then ``epilogue_plain``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..system import LensSystem
from ..utils.profiling import counter_totals, span
from . import _launch
from .epilogue_kernel import epilogue_plain, exposure_on

Tensor = torch.Tensor

# launches of the CUDA kernel by raytraced_fused (plain CPU runs not counted)
launches = 0
# launches of the CUDA kernel by raytraced_rays (plain CPU runs not counted)
raytraced_rays_launches = 0
# launches of the CUDA kernel by thinlens_rays (plain CPU runs not counted)
thinlens_rays_launches = 0

# table capacities of csrc/raytraced.cu (its parameter and shared memory)
MAX_ELEMS, MAX_KEYS, MAX_COEF = 64, 128, 32

SALT_U1, SALT_U2 = 0x11111111, 0x22222222

# candidate draws per pre-checked round (zoic_tpu PRECHECK_DRAWS; round 0
# scans as many after the caller's draw)
PRECHECK_DRAWS = 4
# presampled retry-draw planes per generation (zoic_tpu BOKEH_PLANES)
BOKEH_PLANES = 4

# the TPU kernels' lane width and default tile rows (thin lens, raytraced):
# they decide which retry-plane cell a ray reads (_plane_index)
LANES = 128
DEF_TILE_ROWS = 64
DEF_RT_TILE_ROWS = 128


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
RHO2_MIN = _f32(1e-18)  # harmonic bound's rsqrt guard (_bound_pass)
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


def shaping_table(lens: LensSystem, use_lut: bool = True,
                  use_profile: bool = True) -> Tuple[Tensor, Tensor]:
    """f32[n_keys, 6] ``[max_scale*1.05, centroid_x, c0, c1, c2, c4]`` per
    film-radius key and the uniform key spacing (``_shaping_table``).
    Without the LUT the keys are the profile's and the two LUT columns 0;
    with neither, one zero row and spacing 1.  The 1.05 margin is folded
    into the table in float32 before the lerp."""
    dev = lens.ior.device
    if use_lut:
        keys = lens.lut.keys
        ms = lens.lut.max_scale * SAMPLING_ERROR_CORRECTION
        ce = lens.lut.centroid_x
    elif use_profile:
        keys = lens.profile.keys
        ms = ce = torch.zeros_like(keys)
    else:
        return (torch.zeros((1, 6), dtype=torch.float32, device=dev),
                torch.tensor(1.0, dtype=torch.float32, device=dev))
    if use_profile:
        prof = lens.profile
        cols = [prof.c0, prof.c1, prof.c2, prof.c4]
    else:
        cols = [torch.zeros_like(keys)] * 4
    return torch.stack([ms, ce, *cols], dim=1), keys[1] - keys[0]


def kernel_scalars(lens: LensSystem, sensor_width: Tensor, spacing: Tensor,
                   seed: int, batch: int, use_profile: bool,
                   use_poly: bool) -> Tensor:
    """f32[8] ``[origin_shift, -thickness[0], seed, aperture[0], spacing,
    batch, sensor_width/2, inv_dmax]``, the scalars ``raytraced_fused``
    packs.  ``inv_dmax`` normalises the film radius for the pre-check
    polynomial: ``1/poly_scale`` when the polynomial is used, else
    ``1/keys[-1]`` of the profile, 1 without a pre-check."""
    dev = lens.ior.device
    f = torch.float32
    sw = torch.as_tensor(sensor_width, dtype=f, device=dev)
    prof = lens.profile
    if use_profile and use_poly and prof.poly_scale is not None:
        inv_dmax = 1.0 / prof.poly_scale.to(f)
    elif use_profile:
        inv_dmax = 1.0 / prof.keys[-1].to(f)
    else:
        inv_dmax = torch.tensor(1.0, dtype=f, device=dev)
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


class Variant(NamedTuple):
    """The kernel's static variant, as ``raytraced_fused`` derives it from
    the lens state and the caller's flags."""

    use_lut: bool       # exit-pupil LUT shaping (else naive first element)
    use_profile: bool   # pupil pre-check
    use_poly: bool      # pre-check from the Horner polynomial (else the
    #                     per-key select chain of the shaping table)
    circles: bool       # 2-circle bound (else the harmonic cos series)
    flags: Tuple[int, ...]  # static element flags; () = from the table
    iris_idx: int       # refract-identity element, -1 = none


def variant(lens: LensSystem, use_lut: bool, use_profile: bool,
            presampled: bool) -> Variant:
    """The variant a state and flags select, or ``ValueError`` for a state
    that lacks what the flags ask for."""
    if use_lut and lens.lut is None:
        raise ValueError("use_lut needs a state compiled with the LUT "
                         "(kolb_sampling_lut=True)")
    prof = lens.profile
    if use_profile and prof is None:
        raise ValueError("use_profile needs a state compiled with the "
                         "pupil pre-check")
    if use_profile and presampled and lens.profile_domain != "square":
        # bokeh offsets fill [-1, 1]^2: a disk-fitted bound is unsound at
        # the corners (the JAX kernel asserts the same)
        raise ValueError("a presampled (image bokeh) pre-check needs a "
                         "square-domain profile")
    use_poly = bool(use_profile and lens.profile_poly)
    if use_poly and prof.poly is None:
        raise ValueError("profile_poly is set but the profile has no poly")
    flags = (tuple(lens.elem_flags) if len(lens.elem_flags) == lens.count
             else ())
    return Variant(
        use_lut=bool(use_lut), use_profile=bool(use_profile),
        use_poly=use_poly,
        circles=bool(use_profile and prof.kind == "circles"),
        flags=flags,
        iris_idx=lens.aperture_element if lens.iris_identity else -1,
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


def _shaping(fx, fy, table, spacing, prof, inv_dmax, v: Variant):
    """Per-ray shaping affine and pre-check coefficients
    (``_shaping_from_table``).  Returns ``(sa, sb, kx, ky, pcs)``: with the
    LUT, the lerped scale and centroid rotated by fastSin/fastCos of the
    film angle and folded into ``dx = lx*sa - ly*sb + kx``, ``dy = lx*sb +
    ly*sa + ky``; naive shaping returns ``None`` for all four.  ``pcs`` are
    the bound's four coefficients, lerped per key (select chain) or by
    Horner in ``t = min(dist * inv_dmax, 1)``, the latter switched off
    beyond the fitted domain; circle centres come pre-doubled."""
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

    def lerp(c):
        return lb[:, c] + perc * (pr[:, c] - lb[:, c])

    sa = sb = kx = ky = pcs = None
    if v.use_lut:
        ms, trn = lerp(0), lerp(1)
        theta = torch.atan2(fy, fx)
        sn = fast_sin(theta)
        cs = fast_cos(theta)
        sa, sb = ms * cs, ms * sn
        kx, ky = trn * cs - fx, trn * sn - fy
    if v.use_profile and not v.use_poly:
        pcs = [lerp(c) for c in (2, 3, 4, 5)]
    elif v.use_profile:
        t_raw = dist * inv_dmax
        t = torch.clamp_max(t_raw, 1.0)
        deg = len(prof[0]) - 1
        pcs = []
        for j in range(4):
            acc = torch.zeros_like(t) + prof[j][deg]
            for k in range(deg - 1, -1, -1):
                acc = acc * t + prof[j][k]
            pcs.append(acc)
        off = t_raw > 1.0
        # beyond the fitted domain the bound passes everything: q -> 1e9
        # for circles, c0 -> 1e9 for the harmonic series
        for j in ((1, 3) if v.circles else (0,)):
            pcs[j] = torch.where(off, torch.full_like(pcs[j], BIG), pcs[j])
    if v.circles:
        pcs[0] = pcs[0] * 2.0
        pcs[2] = pcs[2] * 2.0
    return sa, sb, kx, ky, pcs


def _bound_pass(lx, ly, pcs, circles):
    """Whether a candidate offset passes the pre-check bound
    (``_bound_pass``): inside both circles, or inside the polar bound
    ``rho <= c0 + c1 cos + c2 cos2 + c4 cos4``."""
    if circles:
        a1d, q1, a2d, q2 = pcs
        rr = lx * lx + ly * ly
        return ((rr - a1d * lx) <= q1) & ((rr - a2d * lx) <= q2)
    pc0, pc1, pc2, pc4 = pcs
    rho2 = lx * lx + ly * ly
    r_inv = torch.rsqrt(torch.clamp_min(rho2, RHO2_MIN))
    rho = rho2 * r_inv
    cphi = lx * r_inv
    t2 = 2.0 * cphi * cphi - 1.0
    t4 = 2.0 * t2 * t2 - 1.0
    return rho <= pc0 + pc1 * cphi + pc2 * t2 + pc4 * t4


def _bound_dead(pcs, circles):
    """Whether the bound rejects every candidate of the domain
    (``_bound_dead``): such a ray takes its whole budget without a trace."""
    if circles:
        a1d, q1, a2d, q2 = pcs

        def mn(a):
            aa = torch.abs(a)
            return torch.where(aa <= 2.0, -0.25 * a * a, 1.0 - aa)

        return (mn(a1d) > q1) | (mn(a2d) > q2)
    pc0, pc1, pc2, pc4 = pcs
    return (pc0 + torch.abs(pc1) + torch.abs(pc2) + torch.abs(pc4)) < 0.0


def _trace(elems: List[List[float]], flags, iris_idx, ox, oy, oz, dx, dy, dz):
    """Element-stack trace with a latched ``fail`` that freezes a ray at
    its last reached hit (``_trace_block``).  With static ``flags`` bit 1
    picks the hit root and bit 0 gates the TIR test; without them the
    signed root and the packed TIR threshold are read from the table."""
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    fail = torch.zeros_like(ox, dtype=torch.bool)
    tir_any = torch.zeros_like(fail)
    for i, (cz, eta_sq, inv_r, r_sq, cull_r_sq, eta, thr, sign_r) in enumerate(
        elems
    ):
        lz = cz - oz
        tca = lz * dz - (ox * dx + oy * dy)
        px = ox + tca * dx
        py = oy + tca * dy
        pz = lz - tca * dz
        d2 = px * px + py * py + pz * pz
        thc = _fast_sqrt(torch.abs(r_sq - d2))
        if not flags:
            t = tca + thc * sign_r
        else:
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
        if not flags or flags[i] & 1:
            tir = (cs2 > (thr if not flags else 1.0)) & ~fail
            tir_any = tir_any | tir
            fail = fail | tir
        k = eta * c1 - _fast_sqrt(torch.abs(1.0 - cs2))
        kk = (k * inv_r).masked_fill(fail, 0.0)
        ee = torch.full_like(k, eta).masked_fill(fail, 1.0)
        dx = dx * ee - ox * kk
        dy = dy * ee - oy * kk
        dz = dz * ee + wz * kk
    return ox, oy, oz, dx, dy, dz, ~fail, tir_any


# ------------------------------------------------------ retry-plane maps


def retry_plane_layout(b: int, bp: int,
                       tile_rows: int = DEF_TILE_ROWS) -> Tuple[int, int, bool]:
    """``(tile_rows, plane_tiles, reuse)`` of a TPU camera kernel for ``b``
    rays and retry planes of ``bp`` draws; ``tile_rows`` is the kernel's
    default tile (``DEF_TILE_ROWS`` thin lens, ``DEF_RT_TILE_ROWS``
    raytraced).

    The tile is halved while the batch fits in half a tile (the JAX
    package's wrappers of both kernels); planes shorter than a tile
    wrap to ``plane_tiles`` whole tiles (``_prep_retry_planes``); ``reuse``
    says whether grid tiles share plane blocks, which adds the per-reuse
    rotation."""
    rows = -(-b // LANES)
    while tile_rows >= 32 and rows <= tile_rows // 2:
        tile_rows //= 2
    grid = -(-rows // tile_rows)
    plane_tiles = -(-bp // (tile_rows * LANES))
    return tile_rows, plane_tiles, plane_tiles < grid


def _plane_index(ids: Tensor, idx: int, n_planes: int, bp: int,
                 tile_rows: int, plane_tiles: int, reuse: bool,
                 lane_step: int) -> Tuple[int, Tensor]:
    """``(plane, position)`` of presampled draw ``idx`` for the rays at
    flat indices ``ids``.

    The TPU kernel lays ray ``i`` at row ``R = i // 128``, lane
    ``l = i % 128`` of tile ``t = R // tile_rows``, row ``r`` in it; tile
    ``t`` reads plane block ``t % plane_tiles``.  Draw ``idx`` reads plane
    ``idx % P`` rolled down by ``shift`` rows and right by ``lsh`` lanes (a
    roll moves element ``j`` to ``j + s``), where the reuse cycle
    ``cyc = idx // P`` and, when tiles share blocks, the reuse index
    ``t // plane_tiles`` set the shifts; ``lane_step`` lanes more per eight
    cycles."""
    rr, lane = ids // LANES, ids % LANES
    t, r = rr // tile_rows, rr % tile_rows
    pidx, cyc = idx % n_planes, idx // n_planes
    t_reuse = t // plane_tiles if reuse else torch.zeros_like(t)
    shift = (3 * cyc + 5 * t_reuse) % tile_rows
    lsh = (lane_step * (cyc // 8) + 21 * t_reuse) % LANES
    row = (t % plane_tiles) * tile_rows + (r - shift) % tile_rows
    return pidx, (row * LANES + (lane - lsh) % LANES) % bp


def retry_plane_index(ids: Tensor, rnd: int, n_planes: int, bp: int,
                      tile_rows: int, plane_tiles: int,
                      reuse: bool) -> Tuple[int, Tensor]:
    """``(plane, position)`` of thin-lens retry round ``rnd``'s (1-based)
    presampled draw: draw ``rnd - 1`` of :func:`_plane_index`, with no
    per-cycle lane roll (``_thinlens_kernel``)."""
    return _plane_index(ids, rnd - 1, n_planes, bp, tile_rows, plane_tiles,
                        reuse, 0)


def raytraced_plane_index(ids: Tensor, idx: int, n_planes: int, bp: int,
                          tile_rows: int, plane_tiles: int,
                          reuse: bool) -> Tuple[int, Tensor]:
    """``(plane, position)`` of the raytraced kernel's presampled draw
    ``idx`` (``_plane_draws``): the rotations of :func:`_plane_index` plus
    seven lanes per eight reuse cycles.  The whole-tile loop numbers the
    draws: round 0 reads ``0..K-1`` (after the caller's draw), retry round
    ``rnd`` reads ``K*rnd + j`` with the pre-check and ``rnd - 1``
    without it."""
    return _plane_index(ids, idx, n_planes, bp, tile_rows, plane_tiles,
                        reuse, 7)


def _retry_planes(retry_u1, retry_u2, dev) -> Tuple[Tensor, Tensor]:
    """The presampled retry planes ``[P, Bp]``; zeros ``[1, 128]`` when the
    caller gave none, as the TPU kernels do."""
    if retry_u1 is None:
        z = torch.zeros((1, LANES), dtype=torch.float32, device=dev)
        return z, z
    if retry_u1.dim() != 2 or retry_u1.shape != retry_u2.shape:
        raise ValueError(
            f"retry planes must be [P, Bp] of one shape, got "
            f"{tuple(retry_u1.shape)} and {tuple(retry_u2.shape)}"
        )
    return retry_u1, retry_u2


def _device_planes(retry_u1, retry_u2, dev) -> Tuple[Tensor, Tensor]:
    """:func:`_retry_planes`, checked and contiguous for a kernel."""
    bu1, bu2 = _retry_planes(retry_u1, retry_u2, dev)
    for name, t in (("retry_u1", bu1), ("retry_u2", bu2)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    return bu1.contiguous(), bu2.contiguous()


# ----------------------------------------------------------- entry points


def _prepare(lens, sensor_width, seed, batch, v: Variant):
    elems = pack_elements(lens)
    table, spacing = shaping_table(lens, v.use_lut, v.use_profile)
    if v.use_poly:
        prof = lens.profile.poly.to(torch.float32).contiguous()
    else:
        prof = torch.zeros((4, 1), dtype=torch.float32, device=elems.device)
    scal = kernel_scalars(lens, sensor_width, spacing, seed, batch,
                          v.use_profile, v.use_poly)
    return elems, table, prof, scal


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < (1 << 22):
        raise ValueError(f"seed must be in [0, 2**22), got {seed}")
    return seed


def raytraced_plain(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, *, max_tries: int, use_lut: bool = True,
    use_profile: bool = True, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
    counts: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel on any device: returns
    ``(origin[B,3], dir[B,3], tries[B] i32, tir[B] i32)``, and adds to
    ``counts`` (``int64 [2]``, where given) the aperture draws the rays
    made (the caller's included) and those that went on to the element
    trace, as the kernel counts them.

    It runs the TPU kernel's whole-tile loop (``compact=False``) over the
    rays still pending: round 0 and retry rounds ``1..max_tries+1``, each
    scanning its draws (``K = PRECHECK_DRAWS`` with the pre-check, one
    without; round 0 first takes the caller's draw for free) until one
    passes the bound, then tracing that one.  Every draw after the
    caller's consumes a try."""
    seed = _check_seed(seed)
    b = sx.shape[0]
    dev = sx.device
    v = variant(lens, use_lut, use_profile, presampled)
    elems_t, table, prof, scal = _prepare(lens, sensor_width, seed, b, v)
    elems = elems_t.tolist()
    origin_shift, dz0, _, naive_scale, spacing, _, sensor_half, inv_dmax = (
        scal.tolist())
    max_total = max_tries + 1
    k_draws = PRECHECK_DRAWS if v.use_profile else 1

    fx = sx * sensor_half
    fy = sy * sensor_half
    sa, sb, kx, ky, pcs = _shaping(fx, fy, table, spacing, prof.tolist(),
                                   inv_dmax, v)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    if v.use_profile:
        tries = torch.where(_bound_dead(pcs, v.circles), max_total,
                            tries).to(torch.int32)
    ok = torch.zeros(b, dtype=torch.bool, device=dev)
    tir = torch.zeros(b, dtype=torch.int32, device=dev)
    payload = [torch.zeros(b, dtype=torch.float32, device=dev)
               for _ in range(6)]
    ids = torch.arange(b, dtype=torch.int64, device=dev)
    drawn = traced = 0  # the draws and traces ``counts`` takes
    if presampled:
        bu1, bu2 = _retry_planes(retry_u1, retry_u2, dev)
        n_planes, bp = bu1.shape
        layout = retry_plane_layout(b, bp, DEF_RT_TILE_ROWS)

    for rnd in range(max_total + 1):
        act = (~ok & (tries < max_total)).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        a_ids, a_tries = ids[act], tries[act]
        a_pcs = [p[act] for p in pcs] if v.use_profile else None
        found = torch.zeros(act.shape[0], dtype=torch.bool, device=dev)
        cx = torch.zeros(act.shape[0], dtype=torch.float32, device=dev)
        cy = torch.zeros_like(cx)
        n_draws = k_draws + 1 if (rnd == 0 and v.use_profile) else k_draws
        for j in range(n_draws):
            if rnd == 0 and j == 0:
                # the caller's draw: no try consumed
                lx, ly = u1[act], u2[act]
                if not presampled:
                    lx, ly = concentric(lx, ly)
                can = torch.ones_like(found)
            else:
                if presampled:
                    if not v.use_profile:
                        idx = rnd - 1
                    else:
                        idx = j - 1 if rnd == 0 else k_draws * rnd + j
                    pidx, pos = raytraced_plane_index(a_ids, idx, n_planes,
                                                      bp, *layout)
                    lx, ly = bu1[pidx][pos], bu2[pidx][pos]
                else:
                    lx, ly = concentric(
                        hash_uniform(a_ids, seed, a_tries, SALT_U1),
                        hash_uniform(a_ids, seed, a_tries, SALT_U2))
                can = ~found & (a_tries < max_total)
                a_tries = a_tries + can.to(torch.int32)
            take = can
            if v.use_profile:
                take = can & _bound_pass(lx, ly, a_pcs, v.circles)
            if counts is not None:
                drawn += int(can.sum())
            cx = torch.where(take, lx, cx)
            cy = torch.where(take, ly, cy)
            found = found | take
        tries[act] = a_tries
        sel = found.nonzero().squeeze(1)
        traced += sel.numel()
        if sel.numel() == 0:
            continue
        g = act[sel]
        g_lx, g_ly, g_fx, g_fy = cx[sel], cy[sel], fx[g], fy[g]
        if v.use_lut:
            g_sa, g_sb = sa[g], sb[g]
            dx = g_lx * g_sa - g_ly * g_sb + kx[g]
            dy = g_lx * g_sb + g_ly * g_sa + ky[g]
        else:
            dx = g_lx * naive_scale - g_fx
            dy = g_ly * naive_scale - g_fy
        fz = torch.full_like(g_fx, origin_shift)
        dz = torch.full_like(g_fx, dz0)
        *res, nok, ntir = _trace(elems, v.flags, v.iris_idx, g_fx, g_fy, fz,
                                 dx, dy, dz)
        for p, r in zip(payload, res):
            p[g] = r
        ok[g] = nok
        tir[g] += ntir.to(torch.int32)

    if counts is not None:
        counts += torch.tensor([drawn, traced], dtype=counts.dtype,
                               device=counts.device)
    origin = -torch.stack(payload[:3], dim=-1)
    direction = -torch.stack(payload[3:], dim=-1)
    return origin, direction, tries, tir


_RAYTRACED_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])

# (id(lens), id(sensor_width), device, use_lut, use_profile) ->
# (weakref(lens), weakref(sensor_width), tables): the kernel's tables are
# constants of a compiled state, so they are packed (and the four that
# travel in the kernel's parameter read back to the host) once per state
# and variant, not once per call
_TABLES: dict = {}

# bits of the kernel's variant word (csrc/raytraced.cu), one kernel
# instance per word
_V_LUT, _V_PROFILE, _V_POLY, _V_CIRCLES, _V_PRESAMPLED = 1, 2, 4, 8, 16

# threads of a block of csrc/raytraced.cu (kBlock) in warps: each warp
# works through tiles of 32 rays
WARPS_PER_BLOCK = 4


def variant_word(v: Variant, presampled: bool) -> int:
    """The word of bits that selects the kernel's template instance.  The
    element flags are no bit of it: the kernel reads them from its element
    table (:func:`_kernel_tables` writes a state's static flags there)."""
    return ((_V_LUT if v.use_lut else 0) | (_V_PROFILE if v.use_profile else 0)
            | (_V_POLY if v.use_poly else 0)
            | (_V_CIRCLES if v.circles else 0)
            | (_V_PRESAMPLED if presampled else 0))


def persistent_grid(b: int, sm_count: int, blocks_per_sm: int) -> int:
    """Blocks of the raytraced kernel's persistent grid for ``b`` rays: as
    many as the card holds at once (``sm_count * blocks_per_sm``), but no
    more than there are tiles of 32 rays to give each warp one, and at
    least one."""
    tiles = -(-b // 32)
    work = -(-tiles // WARPS_PER_BLOCK)
    return max(1, min(sm_count * blocks_per_sm, work))


def _kernel_tables(lens: LensSystem, sensor_width, dev, v: Variant):
    """``(elems, shap, prof, scal, pointers)`` for the kernel: ``shap`` a
    tensor on ``dev``, the others contiguous numpy arrays on the host, which
    the launch copies into the kernel's parameter; ``pointers`` the four
    addresses in that order.  The seed and batch slots of ``scal`` hold 0:
    the kernel takes both as int arguments.  The kernel reads the root's
    sign and the TIR threshold from the element table, so a state's static
    element flags are written into those two columns: bit 1 as a sign of
    -1, bit 0 as a threshold of 1 (else +inf), which select the same root
    and gate the same test as the flag form of :func:`_trace`."""
    key = (id(lens), id(sensor_width), str(dev), v.use_lut, v.use_profile)
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is lens and hit[1]() is sensor_width:
        return hit[2]
    with span("zoic.tables.build"):
        elems, shap, prof, scal = _prepare(lens, sensor_width, 0, 0, v)
        n_elems, n_keys, n_coef = elems.shape[0], shap.shape[0], prof.shape[1]
        if n_elems > MAX_ELEMS or n_keys > MAX_KEYS or n_coef > MAX_COEF:
            raise ValueError(
                f"lens tables ({n_elems} elements, {n_keys} keys, {n_coef} "
                f"coefficients) exceed the kernel's ({MAX_ELEMS}, {MAX_KEYS}, "
                f"{MAX_COEF})"
            )
        elems, prof, scal = (
            np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)
            for t in (elems, prof, scal))
        if v.flags:
            flags = np.asarray(v.flags)
            elems[:, 6] = np.where(flags & 1, 1.0, np.inf)
            elems[:, 7] = np.where(flags & 2, -1.0, 1.0)
        shap = shap.to(dev, torch.float32).contiguous()
        tables = (elems, shap, prof, scal,
                  (elems.ctypes.data, shap.data_ptr(), prof.ctypes.data,
                   scal.ctypes.data))
        if isinstance(sensor_width, Tensor):
            for k in [k for k, val in _TABLES.items()
                      if val[0]() is None or val[1]() is None]:
                del _TABLES[k]
            _TABLES[key] = (weakref.ref(lens), weakref.ref(sensor_width),
                            tables)
        return tables


def _raytraced_launch(lens, sx, sy, u1, u2, sensor_width, seed, exposure=None,
                      *, max_tries, use_lut, use_profile, presampled,
                      retry_u1, retry_u2, count=False, counts=None):
    """Check, allocate and launch ``csrc/raytraced.cu`` (its lane-counting
    build with ``count``); returns ``(origin, dir, tries, tir)``, or with
    ``exposure`` (a 0-d tensor on the inputs' card) the finished rays
    ``(origin, dir, weight, d_ody, d_ddy, stats)``.  The kernel adds its
    draws and traces to ``counts`` (``int64 [2]`` on the card) where
    given."""
    seed = _check_seed(seed)
    b, dev = _launch.check_flat(
        (("sx", sx), ("sy", sy), ("u1", u1), ("u2", u2)))
    v = variant(lens, use_lut, use_profile, presampled)
    elems, shap, prof, _, pointers = _kernel_tables(lens, sensor_width, dev,
                                                    v)
    word = variant_word(v, presampled)
    bu1 = bu2 = None
    n_planes = bp = tile_rows = plane_tiles = reuse = 0
    if presampled:
        bu1, bu2 = _device_planes(retry_u1, retry_u2, dev)
        n_planes, bp = bu1.shape
        tile_rows, plane_tiles, reuse = retry_plane_layout(
            b, bp, DEF_RT_TILE_ROWS)
    finished = exposure is not None
    if finished:
        out = _launch.empty(
            dev, ((b, 3), torch.float32), ((b, 3), torch.float32),
            ((b,), torch.float32), ((b, 3), torch.float32),
            ((b, 3), torch.float32), ((4,), torch.int32))
        outputs = (None, None, exposure.data_ptr(),
                   *(t.data_ptr() for t in out[2:]))
    else:
        out = _launch.empty(
            dev, ((b, 3), torch.float32), ((b, 3), torch.float32),
            ((b,), torch.int32), ((b,), torch.int32))
        outputs = (out[2].data_ptr(), out[3].data_ptr(), None, None, None,
                   None, None)
    if b == 0:
        if finished:
            out[5].zero_()
        return out
    defines = (_launch.COUNT_DEFINE,) if count else ()
    fn = _launch.bind("raytraced", "zoic_raytraced_launch",
                      _RAYTRACED_ARGTYPES, defines=defines)
    _launch.launch(
        fn, "raytraced", dev,
        sx.data_ptr(), sy.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        bu1.data_ptr() if bu1 is not None else None,
        bu2.data_ptr() if bu2 is not None else None,
        *pointers, out[0].data_ptr(), out[1].data_ptr(), *outputs,
        counts.data_ptr() if counts is not None else None,
        b, elems.shape[0], shap.shape[0], prof.shape[1], v.iris_idx,
        max_tries + 1, seed, word, PRECHECK_DRAWS, n_planes, bp,
        tile_rows, plane_tiles, int(reuse),
        persistent_grid(b, *_launch.blocks_per_sm(
            "raytraced", "zoic_raytraced_blocks_per_sm", [ctypes.c_int], dev,
            word, defines=defines)),
    )
    return out


def raytraced_fused(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, *, max_tries: int, use_lut: bool = True,
    use_profile: bool = True, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused raytraced camera-ray generation over flat ``[B]`` inputs.

    Returns ``(origin[B,3], dir[B,3], tries[B] i32, tir[B] i32)``, where
    ``tries`` counts the retry draws a ray consumed and ``tir`` its
    attempts that failed by total internal reflection.  ``use_lut``
    selects exit-pupil LUT shaping (else naive first-element targeting),
    ``use_profile`` the pupil pre-check.  With ``presampled`` the
    ``(u1, u2)`` inputs are [-1, 1] aperture offsets (image bokeh) and the
    retry draws come from the ``[P, Bp]`` planes ``retry_u1/retry_u2``
    (:func:`raytraced_plane_index`).  CUDA tensors launch
    ``csrc/raytraced.cu``; CPU tensors run :func:`raytraced_plain`."""
    global launches
    with span("zoic.raytraced"):
        if sx.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {sx.device}")
        kw = dict(max_tries=max_tries, use_lut=use_lut,
                  use_profile=use_profile, presampled=presampled,
                  retry_u1=retry_u1, retry_u2=retry_u2,
                  counts=counter_totals(sx.device))
        if sx.device.type == "cpu":
            return raytraced_plain(lens, sx, sy, u1, u2, sensor_width, seed,
                                   **kw)
        out = _raytraced_launch(lens, sx, sy, u1, u2, sensor_width, seed,
                                **kw)
        if sx.shape[0] > 0:
            launches += 1
        return out


def raytraced_rays_plain(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, exposure: Tensor, *, max_tries: int,
    use_lut: bool = True, use_profile: bool = True, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
    counts: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`raytraced_rays` on any device:
    :func:`raytraced_plain` (which adds to ``counts``), then
    ``epilogue_plain`` on its rays.  Returns ``(origin[B,3], dir[B,3],
    weight[B], d_ody[B,3], d_ddy[B,3], stats i32[4])``."""
    origin, direction, tries, tir = raytraced_plain(
        lens, sx, sy, u1, u2, sensor_width, seed, max_tries=max_tries,
        use_lut=use_lut, use_profile=use_profile, presampled=presampled,
        retry_u1=retry_u1, retry_u2=retry_u2, counts=counts)
    return (origin, direction) + epilogue_plain(
        tries, tir, origin, direction, exposure, max_tries)


def raytraced_rays(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, exposure: Tensor, *, max_tries: int,
    use_lut: bool = True, use_profile: bool = True, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The raytraced model's finished rays over flat ``[B]`` inputs: the
    camera kernel's rays (:func:`raytraced_fused`) and their epilogue, in
    one launch.

    Takes :func:`raytraced_fused`'s arguments and the state's 0-d
    ``exposure``; returns ``(origin[B,3], dir[B,3], weight[B], d_ody[B,3],
    d_ddy[B,3], stats i32[4])``, ``stats`` holding success, vignetted, tir
    and tries_total.  CUDA tensors launch ``csrc/raytraced.cu`` (the
    counter buffer zeroed, then the kernel, which writes the weights and
    derivatives with each tile of 32 rays and again where a ray ends
    otherwise, adds the counters once a block and reads the exposure on
    the card: no pass reads the rays back); CPU tensors run
    :func:`raytraced_rays_plain`.  While a profiler records, the call's
    draws and traces go to ``utils.profiling.counter_totals``."""
    global raytraced_rays_launches
    with span("zoic.raytraced"):
        dev = sx.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        kw = dict(max_tries=max_tries, use_lut=use_lut,
                  use_profile=use_profile, presampled=presampled,
                  retry_u1=retry_u1, retry_u2=retry_u2,
                  counts=counter_totals(dev))
        exposure = exposure_on(exposure, dev)
        if dev.type == "cpu":
            return raytraced_rays_plain(lens, sx, sy, u1, u2, sensor_width,
                                        seed, exposure, **kw)
        out = _raytraced_launch(lens, sx, sy, u1, u2, sensor_width, seed,
                                exposure, **kw)
        if sx.shape[0] > 0:
            raytraced_rays_launches += 1
        return out


def raytraced_lane_use(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width, seed: int, exposure: Tensor, **kw,
) -> Tuple[Tuple[Tensor, ...], dict]:
    """:func:`raytraced_rays` through the kernel's lane-counting build, on
    CUDA tensors: its outputs, and how full the warps were.  ``traces`` and
    ``draws`` are the kernel's own counts, the lanes that entered an
    element-stack trace or took an aperture draw (the caller's included);
    ``warp_traces`` and ``warp_draws`` the counting build's converged
    groups of a warp that did: lanes over groups is the mean number of
    active lanes.  ``whole_tiles`` counts the tiles of 32 rays, all dead
    keys, stored whole."""
    kw = dict(dict(use_lut=True, use_profile=True, presampled=False,
                   retry_u1=None, retry_u2=None), **kw)
    totals = torch.zeros(2, dtype=torch.int64, device=sx.device)
    _launch.reset_counts("raytraced")
    out = _raytraced_launch(lens, sx, sy, u1, u2, sensor_width, seed,
                            exposure_on(exposure, sx.device), count=True,
                            counts=totals, **kw)
    warp_traces, warp_draws, whole = _launch.read_counts("raytraced", 3)
    draws, traces = totals.tolist()
    return out, {"traces": traces, "warp_traces": warp_traces,
                 "draws": draws, "warp_draws": warp_draws,
                 "whole_tiles": whole}


# -------------------------------------------------------------- thin lens


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


# id of the tan_fov tensor -> (weak references to the five scalar tensors,
# their versions, the five floats): the thin-lens kernel takes its camera
# scalars by value, and reading a 0-d tensor on the card waits for the card,
# so a state's scalars are read once and kept until the state goes
_THIN_SCALARS: dict = {}


def thinlens_scalars(tan_fov, aperture_radius, focal_distance, ov_distance,
                     ov_radius) -> Tuple[float, ...]:
    """The five camera scalars as Python floats rounded to float32
    (:func:`_f32_scalar`, as :func:`thinlens_plain` rounds them).  Given a
    state's tensors, the floats are kept beside them: later calls read
    nothing from the card, a tensor that was replaced or written in place
    is read again, and the entry goes when the state does."""
    vals = (tan_fov, aperture_radius, focal_distance, ov_distance, ov_radius)
    if not all(isinstance(v, Tensor) for v in vals):
        return tuple(_f32_scalar(v) for v in vals)
    key = id(tan_fov)
    hit = _THIN_SCALARS.get(key)
    if hit is not None and all(
            r() is v and n == v._version
            for r, n, v in zip(hit[0], hit[1], vals)):
        return hit[2]
    floats = tuple(_f32_scalar(v) for v in vals)
    refs = tuple(
        weakref.ref(v, lambda _, k=key: _THIN_SCALARS.pop(k, None))
        for v in vals)
    _THIN_SCALARS[key] = (refs, tuple(v._version for v in vals), floats)
    return floats


def _plane_args(b, dev, presampled, has_ov, retry_u1, retry_u2):
    """The retry planes' arguments of a thin-lens launch: ``(bu1 pointer,
    bu2 pointer, n_planes, bp, tile_rows, plane_tiles, reuse)``, null and
    zeros unless ``presampled`` and ``has_ov``; and the planes themselves,
    to be kept until the launch."""
    if not (presampled and has_ov):
        return (None, None, 0, 0, 0, 0, 0), ()
    bu1, bu2 = _device_planes(retry_u1, retry_u2, dev)
    n_planes, bp = bu1.shape
    tile_rows, plane_tiles, reuse = retry_plane_layout(b, bp)
    return ((bu1.data_ptr(), bu2.data_ptr(), n_planes, bp, tile_rows,
             plane_tiles, int(reuse)), (bu1, bu2))


# threads of a block of csrc/thinlens.cu (kBlock), and the rays a warp
# takes a step (kTile)
THINLENS_BLOCK = 256
THINLENS_TILE = 128

_THINLENS_RAYS_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 5
                           + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                           + [ctypes.c_void_p])


def thinlens_grid(b: int, sm_count: int, blocks_per_sm: int) -> int:
    """Blocks of :func:`thinlens_rays`' grid for ``b`` rays: as many as the
    card holds at once (``sm_count * blocks_per_sm``), so that few blocks
    add to the counters, but no more than give each warp a tile, and at
    least one."""
    step = THINLENS_BLOCK // 32 * THINLENS_TILE
    return max(1, min(sm_count * blocks_per_sm, -(-b // step)))


def thinlens_rays_plain(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov,
    aperture_radius, focal_distance, ov_distance, ov_radius, seed: int,
    exposure: Tensor, *, use_dof: bool, has_ov: bool, max_tries: int,
    presampled: bool = False, retry_u1: Optional[Tensor] = None,
    retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`thinlens_rays` on any device:
    :func:`thinlens_plain`, then ``epilogue_plain`` on its rays (no tir;
    the weight counted with depth of field, the pinhole's kept 1).  Returns
    ``(origin[B,3], dir[B,3], weight[B], d_ody[B,3], d_ddy[B,3], stats
    i32[4])``."""
    origin, direction, tries = thinlens_plain(
        sx, sy, u1, u2, tan_fov, aperture_radius, focal_distance, ov_distance,
        ov_radius, seed, use_dof=use_dof, has_ov=has_ov, max_tries=max_tries,
        presampled=presampled, retry_u1=retry_u1, retry_u2=retry_u2)
    weight, d_ody, d_ddy, stats = epilogue_plain(
        tries, None, origin, direction, exposure, max_tries,
        count_weight=use_dof)
    return origin, direction, weight, d_ody, d_ddy, stats


def _thinlens_rays_launch(sx, sy, u1, u2, scalars, seed, exposure, b, dev,
                          *, use_dof, has_ov, max_tries, presampled,
                          retry_u1, retry_u2, count=False):
    """Allocate and launch ``csrc/thinlens.cu`` (its lane-counting build
    with ``count``) on checked inputs; returns ``(origin, dir, weight,
    d_ody, d_ddy, stats)``."""
    defines = (_launch.COUNT_DEFINE,) if count else ()
    (bu1, bu2, *layout), _planes = _plane_args(
        b, dev, presampled, has_ov, retry_u1, retry_u2)
    out = _launch.empty(
        dev, ((b, 3), torch.float32), ((b, 3), torch.float32),
        ((b,), torch.float32), ((b, 3), torch.float32),
        ((b, 3), torch.float32), ((4,), torch.int32))
    grid = thinlens_grid(b, *_launch.blocks_per_sm(
        "thinlens", "zoic_thinlens_rays_blocks_per_sm", [], dev,
        defines=defines))
    _launch.launch(
        _launch.bind("thinlens", "zoic_thinlens_rays_launch",
                     _THINLENS_RAYS_ARGTYPES, defines=defines),
        "thinlens", dev,
        sx.data_ptr(), sy.data_ptr(), u1.data_ptr(), u2.data_ptr(), bu1,
        bu2, *scalars, exposure.data_ptr(), *(t.data_ptr() for t in out), b,
        int(use_dof), int(has_ov), int(presampled), max_tries + 1, seed,
        *layout, grid,
    )
    return out


def thinlens_rays(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov,
    aperture_radius, focal_distance, ov_distance, ov_radius, seed: int,
    exposure: Tensor, *, use_dof: bool, has_ov: bool, max_tries: int,
    presampled: bool = False, retry_u1: Optional[Tensor] = None,
    retry_u2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The thin lens's finished rays over flat ``[B]`` inputs: the camera
    kernel's rays (:func:`thinlens_plain`) and their epilogue, in one
    launch.

    ``exposure`` is the state's 0-d exposure tensor.  Returns
    ``(origin[B,3], dir[B,3], weight[B], d_ody[B,3], d_ddy[B,3], stats
    i32[4])``, ``stats`` holding success, vignetted, tir (0) and
    tries_total.  The inputs are held to one device, float32, one shape
    and contiguity on every device.  With ``presampled`` the ``(u1, u2)``
    inputs are [-1, 1] aperture offsets (image bokeh) and, with vignetting,
    retry draws come from the ``[P, Bp]`` planes ``retry_u1/retry_u2``.
    CUDA tensors launch ``csrc/thinlens.cu`` (the counter buffer zeroed,
    then the kernel: no pass reads the rays back), which reads the exposure
    on the card; CPU tensors run :func:`thinlens_rays_plain`."""
    global thinlens_rays_launches
    with span("zoic.thinlens"):
        scal = (tan_fov, aperture_radius, focal_distance, ov_distance,
                ov_radius)
        flags = dict(use_dof=use_dof, has_ov=has_ov, max_tries=max_tries,
                     presampled=presampled, retry_u1=retry_u1,
                     retry_u2=retry_u2)
        seed = _check_seed(seed)
        b, dev = _launch.check_flat(
            (("sx", sx), ("sy", sy), ("u1", u1), ("u2", u2)))
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        exposure = exposure_on(exposure, dev)
        if dev.type == "cpu":
            return thinlens_rays_plain(sx, sy, u1, u2, *scal, seed, exposure,
                                       **flags)
        out = _thinlens_rays_launch(sx, sy, u1, u2, thinlens_scalars(*scal),
                                    seed, exposure, b, dev, **flags)
        if b > 0:
            thinlens_rays_launches += 1
        return out


def thinlens_lane_use(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov,
    aperture_radius, focal_distance, ov_distance, ov_radius, seed: int,
    exposure: Tensor, **flags,
) -> Tuple[Tuple[Tensor, ...], dict]:
    """:func:`thinlens_rays` through the kernel's lane-counting build, on
    CUDA tensors: its outputs, and ``attempts`` (lanes that entered an
    aperture attempt) and ``warp_attempts`` (converged groups of a warp
    that did): their ratio is the mean active lanes per attempt."""
    flags = dict(dict(presampled=False, retry_u1=None, retry_u2=None),
                 **flags)
    seed = _check_seed(seed)
    b, dev = _launch.check_flat(
        (("sx", sx), ("sy", sy), ("u1", u1), ("u2", u2)))
    _launch.reset_counts("thinlens")
    out = _thinlens_rays_launch(
        sx, sy, u1, u2,
        thinlens_scalars(tan_fov, aperture_radius, focal_distance,
                         ov_distance, ov_radius), seed,
        exposure_on(exposure, dev), b, dev, count=True, **flags)
    lanes, warps = _launch.read_counts("thinlens", 2)
    return out, {"attempts": lanes, "warp_attempts": warps}
