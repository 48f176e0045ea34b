"""The plain reference's ray generation: ``camera_create_ray`` for whole
calls, as the port's kernel path defines its draws, in plain PyTorch.

A frozen copy of the plain versions of the port's camera kernels
(``zoic_tpu_torch/ops/trace_kernel.py``: the counter hash, the concentric
map, LUT shaping, the pupil pre-check, the element trace, the retry-plane
maps, ``raytraced_plain`` and ``thinlens_plain``), of the bokeh retry
planes (``ops/bokeh_kernel.py:planes_plain``), of the epilogue
(``ops/epilogue_kernel.py:epilogue_plain``) and of the glue of
``models/raytraced.py`` and ``models/thinlens.py`` that decides which
draws a call takes.  Three things are added:

* ``id0`` and ``b_total``: a call is worked out in blocks of rays, each
  keyed by its rays' indices in the whole call;
* the decision margin of every ray (:class:`Margin`): the least relative
  distance, over every comparison that decided the ray's walk (a sphere
  miss, an aperture cull, total internal reflection, the pre-check bound,
  the vignetting test), between the two sides of the comparison.  A ray
  whose margin is tiny can take the other branch under another rounding of
  the same arithmetic, and then walks on with other draws; the comparison
  that decides ``correct`` reads this margin;
* ``dtype``: the per-ray arithmetic in a lower precision (the control).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import bokeh as bokeh_mod
from .system import CameraState, LensSystem

Tensor = torch.Tensor

SALT_U1, SALT_U2 = 0x11111111, 0x22222222
# the raytraced retry planes' seed offset and salts (models/raytraced.py)
PLANE_SEED_OFFSET = 0x5BD1
SALT_P1, SALT_P2 = 0x33333333, 0x44444444
PRECHECK_DRAWS = 4
BOKEH_PLANES = 4
LANES = 128
DEF_TILE_ROWS = 64
DEF_RT_TILE_ROWS = 128


def _f32(x: float) -> float:
    return float(np.float32(x))


PI_D = 3.14159265358979323
PI = _f32(PI_D)
TWO_PI = _f32(2 * PI_D)
HALF_PI = _f32(PI_D * 0.5)
PI_OVER_4 = _f32(0.78539816339)
SIN_B = _f32(4.0 / PI_D)
SIN_C = _f32(-4.0 / (PI_D * PI_D))
SIN_P = _f32(0.225)
SAMPLING_ERROR_CORRECTION = _f32(1.05)
TINY = _f32(1e-35)
BIG = _f32(1e9)
RHO2_MIN = _f32(1e-18)
TWO_M24 = 2.0 ** -24


class Margin:
    """The least decision margin of each ray of a block, kept on the
    block's device (+inf until a comparison decides something)."""

    def __init__(self, b: int, dev):
        self.m = torch.full((b,), float("inf"), dtype=torch.float32,
                            device=dev)

    def note(self, ids: Tensor, a: Tensor, b, live: Tensor,
             scale=None) -> None:
        """Record ``|a - b| / scale`` (``scale`` defaults to ``|b|``, at
        least 1e-30) for the rays at ``ids`` where ``live``."""
        a = a.float()
        b = b.float() if isinstance(b, Tensor) else torch.full_like(a, b)
        if scale is None:
            scale = torch.clamp_min(torch.abs(b), 1e-30)
        rel = torch.abs(a - b) / scale
        rel = torch.where(live, rel, torch.full_like(rel, float("inf")))
        self.m[ids] = torch.minimum(self.m[ids], rel)


# ------------------------------------------------------------- host tables


def pack_elements(lens: LensSystem) -> Tensor:
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
    tir_thr = torch.where(lens.ior > ior_next, 1.0, float("inf")).to(
        torch.float32)
    sign_r = torch.where(lens.curvature < 0.0, -1.0, 1.0).to(torch.float32)
    return torch.stack([lens.center, eta * eta, 1.0 / lens.curvature,
                        lens.curvature * lens.curvature, cull_r_sq, eta,
                        tir_thr, sign_r], dim=1)


def shaping_table(lens: LensSystem, use_lut: bool,
                  use_profile: bool) -> Tuple[Tensor, Tensor]:
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


class Variant(NamedTuple):
    use_lut: bool
    use_profile: bool
    use_poly: bool
    circles: bool
    flags: Tuple[int, ...]
    iris_idx: int


def variant(lens: LensSystem, use_lut: bool, use_profile: bool) -> Variant:
    prof = lens.profile
    use_poly = bool(use_profile and lens.profile_poly)
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
    lo = h * (k & 0xFFFF)
    hi = ((h * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def hash_uniform(ids: Tensor, seed: int, ctr: Tensor, salt: int) -> Tensor:
    """Counter-hash U[0, 1): a murmur3-style mix of (ray id, seed, try
    counter, salt) in uint32 arithmetic; 24 bits to float."""
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
    n_keys = table.shape[0]
    dist = torch.sqrt(fx * fx + fy * fy)
    i_lb = torch.clamp(torch.ceil(dist / spacing).to(torch.int32), 0,
                       n_keys - 1)
    i_prev = torch.clamp_min(i_lb - 1, 0)
    lower = i_lb.to(fx.dtype) * spacing
    prev = i_prev.to(fx.dtype) * spacing
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
        for j in ((1, 3) if v.circles else (0,)):
            pcs[j] = torch.where(off, torch.full_like(pcs[j], BIG), pcs[j])
    if v.circles:
        pcs[0] = pcs[0] * 2.0
        pcs[2] = pcs[2] * 2.0
    return sa, sb, kx, ky, pcs


def _bound_pass(lx, ly, pcs, circles, note=None):
    """Whether a candidate offset passes the pre-check bound; ``note(a,
    b)`` records each comparison's margin (the offsets are O(1))."""
    if circles:
        a1d, q1, a2d, q2 = pcs
        rr = lx * lx + ly * ly
        s1, s2 = rr - a1d * lx, rr - a2d * lx
        if note is not None:
            note(s1, q1)
            note(s2, q2)
        return (s1 <= q1) & (s2 <= q2)
    pc0, pc1, pc2, pc4 = pcs
    rho2 = lx * lx + ly * ly
    r_inv = torch.rsqrt(torch.clamp_min(rho2, RHO2_MIN))
    rho = rho2 * r_inv
    cphi = lx * r_inv
    t2 = 2.0 * cphi * cphi - 1.0
    t4 = 2.0 * t2 * t2 - 1.0
    bound = pc0 + pc1 * cphi + pc2 * t2 + pc4 * t4
    if note is not None:
        note(rho, bound)
    return rho <= bound


def _bound_dead(pcs, circles):
    if circles:
        a1d, q1, a2d, q2 = pcs

        def mn(a):
            aa = torch.abs(a)
            return torch.where(aa <= 2.0, -0.25 * a * a, 1.0 - aa)

        return (mn(a1d) > q1) | (mn(a2d) > q2)
    pc0, pc1, pc2, pc4 = pcs
    return (pc0 + torch.abs(pc1) + torch.abs(pc2) + torch.abs(pc4)) < 0.0


def _dead_sides(pcs, circles):
    """The two sides of each comparison of :func:`_bound_dead`."""
    if circles:
        a1d, q1, a2d, q2 = pcs

        def mn(a):
            aa = torch.abs(a)
            return torch.where(aa <= 2.0, -0.25 * a * a, 1.0 - aa)

        return ((mn(a1d), q1), (mn(a2d), q2))
    pc0, pc1, pc2, pc4 = pcs
    return ((pc0 + torch.abs(pc1) + torch.abs(pc2) + torch.abs(pc4), 0.0),)


def _trace(elems: List[List[float]], flags, iris_idx, ox, oy, oz, dx, dy, dz,
           note=None):
    """Element-stack trace with a latched ``fail``; ``note(a, b, live)``
    records the margin of each comparison a still-live ray makes."""
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
        if note is not None:
            note(d2, r_sq, ~fail)
            note(h2, cull_r_sq, ~fail & ~(d2 > r_sq))
        fail = fail | (d2 > r_sq) | (h2 > cull_r_sq)
        ox = torch.where(fail, ox, hx)
        oy = torch.where(fail, oy, hy)
        oz = torch.where(fail, oz, oz + dz * t)
        if i == iris_idx:
            continue
        wz = cz - oz
        c1 = ((ox * dx + oy * dy) - wz * dz) * inv_r
        cs2 = eta_sq * (1.0 - c1 * c1)
        if not flags or flags[i] & 1:
            limit = thr if not flags else 1.0
            if note is not None and limit != float("inf"):
                note(cs2, limit, ~fail)
            tir = (cs2 > limit) & ~fail
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
    rows = -(-b // LANES)
    while tile_rows >= 32 and rows <= tile_rows // 2:
        tile_rows //= 2
    grid = -(-rows // tile_rows)
    plane_tiles = -(-bp // (tile_rows * LANES))
    return tile_rows, plane_tiles, plane_tiles < grid


def _plane_index(ids: Tensor, idx: int, n_planes: int, bp: int,
                 tile_rows: int, plane_tiles: int, reuse: bool,
                 lane_step: int) -> Tuple[int, Tensor]:
    rr, lane = ids // LANES, ids % LANES
    t, r = rr // tile_rows, rr % tile_rows
    pidx, cyc = idx % n_planes, idx // n_planes
    t_reuse = t // plane_tiles if reuse else torch.zeros_like(t)
    shift = (3 * cyc + 5 * t_reuse) % tile_rows
    lsh = (lane_step * (cyc // 8) + 21 * t_reuse) % LANES
    row = (t % plane_tiles) * tile_rows + (r - shift) % tile_rows
    return pidx, (row * LANES + (lane - lsh) % LANES) % bp


def planes(image, n_cells: int, pseed: int, salt1: int, salt2: int,
           dtype=torch.float32) -> Tuple[Tensor, Tensor]:
    """The raytraced retry planes: cell ``k`` is the bokeh draw of
    ``hash_uniform(k, pseed, 0, salt1)`` and ``(k, pseed, 0, salt2)``."""
    ids = torch.arange(n_cells, dtype=torch.int64,
                       device=image.cdf_row.device)
    zero = torch.zeros_like(ids)
    pu1 = hash_uniform(ids, pseed, zero, salt1).to(dtype)
    pu2 = hash_uniform(ids, pseed, zero, salt2).to(dtype)
    return bokeh_mod.sample(image, pu1, pu2)


# ------------------------------------------------------------ the kernels


def raytraced_block(
    lens: LensSystem, sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor,
    sensor_width: float, seed: int, *, max_tries: int, use_lut: bool,
    use_profile: bool, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
    id0: int = 0, b_total: Optional[int] = None, margin: Margin = None,
    dtype=torch.float32,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``raytraced_plain`` for the rays ``id0 .. id0 + B`` of a call of
    ``b_total`` rays: ``(origin[B,3], dir[B,3], tries[B] i32, tir[B]
    i32)``, origin and direction in float32."""
    b = sx.shape[0]
    b_total = b if b_total is None else b_total
    dev = sx.device
    v = variant(lens, use_lut, use_profile)
    elems = pack_elements(lens).tolist()
    table, spacing = shaping_table(lens, v.use_lut, v.use_profile)
    table = table.to(dtype)
    prof = (lens.profile.poly.to(torch.float32).tolist() if v.use_poly
            else [[0.0]] * 4)
    pr = lens.profile
    if v.use_profile and v.use_poly and pr.poly_scale is not None:
        inv_dmax = float(1.0 / pr.poly_scale.to(torch.float32))
    elif v.use_profile:
        inv_dmax = float(1.0 / pr.keys[-1].to(torch.float32))
    else:
        inv_dmax = 1.0
    origin_shift = float(lens.origin_shift)
    dz0 = float(-lens.thickness[0])
    naive_scale = float(lens.aperture[0])
    spacing = float(spacing)
    sensor_half = float(torch.tensor(sensor_width, dtype=torch.float32) * 0.5)
    max_total = max_tries + 1
    k_draws = PRECHECK_DRAWS if v.use_profile else 1
    sx, sy, u1, u2 = (t.to(dtype) for t in (sx, sy, u1, u2))

    fx = sx * sensor_half
    fy = sy * sensor_half
    sa, sb, kx, ky, pcs = _shaping(fx, fy, table, spacing, prof, inv_dmax, v)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    local = torch.arange(b, dtype=torch.int64, device=dev)
    if v.use_profile:
        tries = torch.where(_bound_dead(pcs, v.circles), max_total,
                            tries).to(torch.int32)
        if margin is not None:
            every, one = torch.ones_like(fx, dtype=torch.bool), torch.ones_like(fx)
            for a, bnd in _dead_sides(pcs, v.circles):
                margin.note(local, a, bnd, every, scale=one.float())
    ok = torch.zeros(b, dtype=torch.bool, device=dev)
    tir = torch.zeros(b, dtype=torch.int32, device=dev)
    payload = [torch.zeros(b, dtype=dtype, device=dev) for _ in range(6)]
    ids = local + id0
    if presampled:
        bu1, bu2 = retry_u1.to(dtype), retry_u2.to(dtype)
        n_planes, bp = bu1.shape
        layout = retry_plane_layout(b_total, bp, DEF_RT_TILE_ROWS)

    for rnd in range(max_total + 1):
        act = (~ok & (tries < max_total)).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        a_ids, a_tries = ids[act], tries[act]
        a_pcs = [p[act] for p in pcs] if v.use_profile else None
        found = torch.zeros(act.shape[0], dtype=torch.bool, device=dev)
        cx = torch.zeros(act.shape[0], dtype=dtype, device=dev)
        cy = torch.zeros_like(cx)
        n_draws = k_draws + 1 if (rnd == 0 and v.use_profile) else k_draws
        for j in range(n_draws):
            if rnd == 0 and j == 0:
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
                    pidx, pos = _plane_index(a_ids, idx, n_planes, bp,
                                             *layout, 7)
                    lx, ly = bu1[pidx][pos], bu2[pidx][pos]
                else:
                    lx, ly = concentric(
                        hash_uniform(a_ids, seed, a_tries, SALT_U1).to(dtype),
                        hash_uniform(a_ids, seed, a_tries, SALT_U2).to(dtype))
                can = ~found & (a_tries < max_total)
                a_tries = a_tries + can.to(torch.int32)
            take = can
            if v.use_profile:
                note = None
                if margin is not None:
                    def note(a, bnd, _act=act, _can=can):
                        margin.note(_act, a, bnd, _can,
                                    scale=torch.ones_like(a.float()))
                take = can & _bound_pass(lx, ly, a_pcs, v.circles, note)
            cx = torch.where(take, lx, cx)
            cy = torch.where(take, ly, cy)
            found = found | take
        tries[act] = a_tries
        sel = found.nonzero().squeeze(1)
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
        tnote = None
        if margin is not None:
            def tnote(a, bnd, live, _g=g):
                margin.note(_g, a, bnd, live)
        *res, nok, ntir = _trace(elems, v.flags, v.iris_idx, g_fx, g_fy, fz,
                                 dx, dy, dz, tnote)
        for p, r in zip(payload, res):
            p[g] = r
        ok[g] = nok
        tir[g] += ntir.to(torch.int32)

    origin = -torch.stack(payload[:3], dim=-1).float()
    direction = -torch.stack(payload[3:], dim=-1).float()
    return origin, direction, tries, tir


def _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr, has_ov):
    lx = lx * ap
    ly = ly * ap
    ddx = fx - lx
    ddy = fy - ly
    inv2 = torch.rsqrt(ddx * ddx + ddy * ddy + fz * fz)
    dx, dy, dz = ddx * inv2, ddy * inv2, fz * inv2
    ok = vv = None
    if has_ov:
        vx = dx * ovd - lx
        vy = dy * ovd - ly
        vv = _fast_sqrt(vx * vx + vy * vy)
        ok = vv < thr
    return [lx, ly, dx, dy, dz], ok, vv


def thinlens_block(
    sx: Tensor, sy: Tensor, u1: Tensor, u2: Tensor, tan_fov, aperture_radius,
    focal_distance, ov_distance, ov_radius, seed: int, *, use_dof: bool,
    has_ov: bool, max_tries: int, presampled: bool = False,
    retry_u1: Optional[Tensor] = None, retry_u2: Optional[Tensor] = None,
    id0: int = 0, b_total: Optional[int] = None, margin: Margin = None,
    dtype=torch.float32,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``thinlens_plain`` for the rays ``id0 .. id0 + B`` of a call of
    ``b_total`` rays: ``(origin[B,3], dir[B,3], tries[B] i32)``."""
    b = sx.shape[0]
    b_total = b if b_total is None else b_total
    dev = sx.device
    tan_fov, ap, focal, ovd, ovr = (_f32(float(v)) for v in (
        tan_fov, aperture_radius, focal_distance, ov_distance, ov_radius))
    thr = float(np.float32(ap) * np.float32(ovr))
    sx, sy, u1, u2 = (t.to(dtype) for t in (sx, sy, u1, u2))

    px = sx * tan_fov
    py = sy * tan_fov
    inv = torch.rsqrt(px * px + py * py + 1.0)
    pdx, pdy, pdz = px * inv, py * inv, inv
    zeros = torch.zeros_like(sx)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    if not use_dof:
        return (torch.stack([zeros, zeros, zeros], -1).float(),
                torch.stack([pdx, pdy, -pdz], -1).float(), tries)

    focal_t = torch.tensor(focal, dtype=dtype, device=dev)
    t = torch.abs(focal_t / pdz)
    fx, fy, fz = pdx * t, pdy * t, pdz * t
    lx, ly = (u1, u2) if presampled else concentric(u1, u2)
    pay, ok, vv = _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr, has_ov)
    local = torch.arange(b, dtype=torch.int64, device=dev)
    if has_ov:
        if margin is not None:
            margin.note(local, vv, thr, torch.ones_like(ok))
        ids = local + id0
        if presampled:
            bu1, bu2 = retry_u1.to(dtype), retry_u2.to(dtype)
            n_planes, bp = bu1.shape
            layout = retry_plane_layout(b_total, bp)
        pending = ~ok
        for rnd in range(1, max_tries + 2):
            if not bool(pending.any()):
                break
            if presampled:
                pidx, pos = _plane_index(ids, rnd - 1, n_planes, bp, *layout,
                                         0)
                lx, ly = bu1[pidx][pos], bu2[pidx][pos]
            else:
                ctr = torch.full_like(ids, rnd)
                lx, ly = concentric(
                    hash_uniform(ids, seed, ctr, SALT_U1).to(dtype),
                    hash_uniform(ids, seed, ctr, SALT_U2).to(dtype))
            new, nok, vv = _lens_attempt(lx, ly, fx, fy, fz, ap, ovd, thr,
                                         True)
            if margin is not None:
                margin.note(local, vv, thr, pending)
            pay = [torch.where(pending, n, o) for n, o in zip(new, pay)]
            tries = torch.where(pending, rnd, tries).to(torch.int32)
            pending = pending & ~nok

    lx, ly, dx, dy, dz = pay
    return (torch.stack([lx, ly, zeros], -1).float(),
            torch.stack([dx, dy, -dz], -1).float(), tries)


# ------------------------------------------------------------ the epilogue


def epilogue(tries: Tensor, tir: Optional[Tensor], origin: Tensor,
             direction: Tensor, exposure: float, max_tries: int, *,
             count_weight: bool = True):
    """Weight (0 iff ``tries > max_tries``), exposure, the fake
    derivatives and the four counters ``(success, vignetted, tir,
    tries_total)`` as int64."""
    if count_weight:
        vig = tries > max_tries
        weight = torch.where(vig, 0.0, 1.0).to(torch.float32)
        n_vig, n_ok = int(vig.sum()), int((~vig).sum())
    else:
        weight = torch.ones(tries.shape, dtype=torch.float32,
                            device=tries.device)
        n_vig = n_ok = 0
    e = torch.tensor(exposure, dtype=torch.float32, device=tries.device)
    e2 = e * e
    weight = torch.where(e > 0.0, weight * (1.0 + e2),
                         torch.where(e < 0.0, weight * (1.0 / (1.0 + e2)),
                                     weight))
    retried = (tries > 0)[..., None]
    zeros = torch.zeros_like(origin)
    d_ody = torch.where(retried, origin, zeros)
    d_ddy = torch.where(retried, direction, zeros)
    n_tir = 0 if tir is None else int(tir.sum())
    return weight, d_ody, d_ddy, (n_ok, n_vig, n_tir, int(tries.sum()))


# ------------------------------------------------------- whole calls


class Rays(NamedTuple):
    origin: Tensor
    dir: Tensor
    weight: Tensor
    d_ody: Tensor
    d_ddy: Tensor
    counters: Tuple[int, int, int, int]
    margin: Tensor


def create_rays(state: CameraState, cam, sx: Tensor, sy: Tensor,
                lensx: Tensor, lensy: Tensor, seed: int, *,
                block: int = 1 << 22, dtype=torch.float32) -> Rays:
    """One call of ``Camera.create_rays(sx, sy, lensx, lensy, seed=seed)``
    on the kernel path, worked out in blocks of ``block`` rays."""
    b = sx.shape[0]
    dev = sx.device
    raytraced = cam.lens_model == "RAYTRACED"
    presampled = bool(cam.use_image)
    has_ov = cam.optical_vignetting_distance > 0.0
    ru1 = ru2 = None
    if presampled:
        lensx, lensy = bokeh_mod.sample(state.bokeh, lensx.to(dtype),
                                        lensy.to(dtype))
        if raytraced and cam.max_tries > 0:
            n_planes = min(BOKEH_PLANES, cam.max_tries + 1)
            bp = min(b, max(1 << 16, b // 8))
            ru1, ru2 = planes(state.bokeh, n_planes * bp,
                              seed + PLANE_SEED_OFFSET, SALT_P1, SALT_P2,
                              dtype)
            ru1, ru2 = ru1.reshape(n_planes, bp), ru2.reshape(n_planes, bp)
        elif (not raytraced and has_ov and cam.max_tries > 0
              and cam.use_dof):
            g = torch.Generator(device=dev).manual_seed(seed)
            n_planes = min(BOKEH_PLANES, cam.max_tries + 1)
            bp = min(b, max(1 << 16, b // 4))
            u = torch.rand((2, n_planes * bp), generator=g, device=dev,
                           dtype=torch.float32)
            ru1, ru2 = bokeh_mod.sample(state.bokeh, u[0].to(dtype),
                                        u[1].to(dtype))
            ru1, ru2 = ru1.reshape(n_planes, bp), ru2.reshape(n_planes, bp)
    parts = []
    for s in range(0, b, block):
        e = min(b, s + block)
        margin = Margin(e - s, dev)
        if raytraced:
            lens = state.lens
            use_profile = bool(cam.pupil_precheck and lens.profile is not None
                               and (not presampled
                                    or lens.profile_domain == "square"))
            out = raytraced_block(
                lens, sx[s:e], sy[s:e], lensx[s:e], lensy[s:e],
                cam.sensor_width, seed, max_tries=cam.max_tries,
                use_lut=bool(cam.kolb_sampling_lut), use_profile=use_profile,
                presampled=presampled, retry_u1=ru1, retry_u2=ru2, id0=s,
                b_total=b, margin=margin, dtype=dtype)
        else:
            out = thinlens_block(
                sx[s:e], sy[s:e], lensx[s:e], lensy[s:e], state.tan_fov,
                state.aperture_radius, state.focal_distance,
                state.ov_distance, state.ov_radius, seed,
                use_dof=cam.use_dof, has_ov=has_ov, max_tries=cam.max_tries,
                presampled=presampled, retry_u1=ru1, retry_u2=ru2, id0=s,
                b_total=b, margin=margin, dtype=dtype)
            out = (*out, None)
        parts.append((*out, margin.m))
    origin, direction, tries = (torch.cat([p[i] for p in parts])
                                for i in range(3))
    tir = None if not raytraced else torch.cat([p[3] for p in parts])
    margin = torch.cat([p[4] for p in parts])
    weight, d_ody, d_ddy, counters = epilogue(
        tries, tir, origin, direction, float(state.exposure_control),
        cam.max_tries, count_weight=raytraced or cam.use_dof)
    return Rays(origin, direction, weight, d_ody, d_ddy, counters, margin)
