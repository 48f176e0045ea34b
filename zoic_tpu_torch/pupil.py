"""Exit-pupil lookup table and pupil pre-check bound: the lens compile's
Monte-Carlo builds and host fits.

Port of what ``zoic_tpu.compile_camera`` reaches in ``zoic_tpu/pupil.py``:

* :func:`build_lut` — the vectorized ``exitPupilLUT`` (src/zoic.cpp:1391-1452):
  one batched trace of a ``[n_film, n_samples]`` grid of rays aimed at the
  whole first element, then masked min/max reductions into per-key bounding
  boxes;
* :func:`lut_lookup` and :func:`profile_lookup` — the uniform-key lerps;
* :func:`build_precheck` — the pupil pre-check bound: three cover traces (fit,
  held-out, key midpoints) under the active sampling cover on the device,
  then the JAX package's numpy float64 fits of the harmonic polar bound and
  the 2-circle cover (``ops/circles_kernel.fit_circles``: its two large
  reductions in ``csrc/circles.cu`` for CUDA tensors, bit-equal), held-out
  loosening, the tighter form kept, and its polynomial form
  (:func:`fit_profile_poly`, :func:`_poly_interval_max`); the reductions
  over the cover samples run where the samples lie
  (``ops/precheck_reduce``: PyTorch on the card, bit-equal), the host
  keeping numpy's ``arctan2`` and ``cos`` and the steps on a key's values;
* :func:`dead_film_fraction`;

and what the exact eager path and the tests reach:

* :func:`lut_shaping` and :func:`shape_sample` — the LUT shaping transform;
* :func:`build_profile` — the harmonic bound fitted alone (no reference
  equivalent; the compile fits it inside :func:`build_precheck`);
* :func:`profile_poly_eval` and :func:`precheck_pass` — the pre-check's
  evaluation, the kernels' math written out.

The traces run in PyTorch on the lens's device.  The host fits are copies of
the reference's numpy code: given equal acceptance masks they give equal
bounds.  The uniforms of every trace can be handed in (``uniforms=``), so
that a test feeds both packages the same draws; otherwise they come from a
``torch.Generator``.

IMPORTANT INVARIANT (``zoic_tpu/pupil.py``): the shaped sampling region
defines the resample acceptance probability and therefore the edge
darkening; the LUT must match the reference's, not a tighter cover.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from . import optics, trace
from .ops import circles_kernel, precheck_reduce
from .optics import V3, f32
from .system import LensSystem, PupilLUT, PupilProfile
from .utils.profiling import readback, span

Tensor = torch.Tensor

log = logging.getLogger("zoic")

FILM_WIDTH = 4.0                   # hard-coded (zoic.cpp:1393)
SAMPLING_ERROR_CORRECTION = 1.05   # safety margin (zoic.cpp:1463, 1891)

POLY_DEGREE = 6          # profile-poly fit degree (7 Horner coefficients)
POLY_MAX_DEFICIT = 0.02  # use the poly in-kernel only when the raw fit is at
#                          least this tight (rho units)

# degree of the circle cover's polynomial form (build_precheck), as in
# zoic_tpu/pupil.py; the fit's own knobs are in ops/circles_kernel.py
CIRCLE_POLY_DEGREE = 8


def draw_uniforms(uniforms: Optional[Mapping], name: str, shape,
                  generator: Optional[torch.Generator], device) -> Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``: ``uniforms[name]`` when
    the caller handed that array in, else drawn from ``generator`` (PyTorch's
    default generator when None)."""
    shape = tuple(shape)
    if uniforms is not None and name in uniforms:
        u = uniforms[name]
        if not isinstance(u, Tensor):
            u = torch.from_numpy(np.array(u, dtype=np.float32))
        u = u.to(device=device, dtype=torch.float32,
                 non_blocking=u.device.type == "cpu")
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms[{name!r}] has shape "
                             f"{tuple(u.shape)}, expected {shape}")
        return u
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def _np(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return readback(x.detach())[0].numpy()
    return np.asarray(x)


def build_lut(
    lens: LensSystem,
    n_film: int = 32,
    n_samples: int = 100_000,
    *,
    uniforms=None,
) -> PupilLUT:
    """Vectorized ``exitPupilLUT`` (``zoic_tpu.pupil.build_lut``): one
    batched trace over the ``[n_film, n_samples]`` grid of ``uniforms``,
    shape ``(2, n_film, n_samples)`` in [0, 1), drawn here when None."""
    dev = lens.ior.device
    u = draw_uniforms(None if uniforms is None else {"lut": uniforms}, "lut",
                      (2, n_film, n_samples), None, dev)
    spacing = f32(FILM_WIDTH / n_film)
    film_x = torch.arange(n_film, dtype=torch.float32, device=dev) * spacing
    lens_u = u[0] * 2.0 - 1.0
    lens_v = u[1] * 2.0 - 1.0

    first_ap = lens.aperture[0]
    ox = film_x[:, None].expand(lens_u.shape)
    oy = torch.zeros_like(ox)
    oz = lens.origin_shift.expand(lens_u.shape)
    # the reference multiplies the lens UV by the element's diameter value
    # (zoic.cpp:1417): the sampled disk over-covers the element by 2x
    dx = lens_u * first_ap - ox
    dy = lens_v * first_ap - oy
    dz = (-lens.thickness[0]).expand(lens_u.shape)
    ok = trace.trace_stack(lens, V3(ox, oy, oz), V3(dx, dy, dz)).ok

    px = lens_u * first_ap
    py = lens_v * first_ap
    inf = float("inf")
    min_x = torch.where(ok, px, inf).amin(1)
    min_y = torch.where(ok, py, inf).amin(1)
    max_x = torch.where(ok, px, -inf).amax(1)
    max_y = torch.where(ok, py, -inf).amax(1)
    # film positions where nothing survives keep the reference's zero bbox
    # (apertureBounds initialized to AI_P2_ZERO, zoic.cpp:1402-1404)
    any_ok = ok.any(1)
    min_x, min_y, max_x, max_y = (torch.where(any_ok, v, 0.0)
                                  for v in (min_x, min_y, max_x, max_y))

    # boundingBox2d::getMaxScale / getCentroid (zoic.cpp:495-517)
    cx = (min_x + max_x) * 0.5
    cy = (min_y + max_y) * 0.5
    max_scale = torch.maximum(torch.abs(max_x - cx), torch.abs(max_y - cy))
    return PupilLUT(keys=film_x, max_scale=max_scale, centroid_x=cx,
                    bbox_min_x=min_x, bbox_min_y=min_y, bbox_max_x=max_x,
                    bbox_max_y=max_y)


def _bracket(keys: Tensor, dist: Tensor):
    """``map::lower_bound`` on uniform keys and the reference's lerp weight
    (zoic.cpp:1892-1911): ``(i_lb, i_prev, perc)``."""
    n = keys.shape[0]
    spacing = keys[1] - keys[0]
    i_lb = torch.clamp(torch.ceil(dist / spacing).to(torch.int64), 0, n - 1)
    i_prev = torch.clamp(i_lb - 1, 0, n - 1)
    lower = keys[i_lb]
    denom = keys[i_prev] - lower
    perc = torch.where(denom != 0.0, (dist - lower) / denom, 0.0)
    perc = torch.where(dist == 0.0, 0.0, perc)
    return i_lb, i_prev, perc


def lut_lookup(lut: PupilLUT, dist: Tensor) -> Tuple[Tensor, Tensor]:
    """Interpolated ``(max_scale * 1.05, centroid_x)`` for film radius
    ``dist`` (``zoic_tpu.pupil.lut_lookup``)."""
    i_lb, i_prev, perc = _bracket(lut.keys, dist)
    max_scale = optics.lerp(perc, lut.max_scale[i_lb], lut.max_scale[i_prev])
    centroid = optics.lerp(perc, lut.centroid_x[i_lb], lut.centroid_x[i_prev])
    return max_scale * f32(SAMPLING_ERROR_CORRECTION), centroid


def profile_lookup(profile: PupilProfile, dist: Tensor):
    """Per-ray ``(c0, c1, c2, c4)`` interpolated over film radius, the same
    uniform-key bracketing as :func:`lut_lookup`."""
    i_lb, i_prev, perc = _bracket(profile.keys, dist)
    return tuple(optics.lerp(perc, c[i_lb], c[i_prev])
                 for c in (profile.c0, profile.c1, profile.c2, profile.c4))


def lut_shaping(lut: PupilLUT, film_x: Tensor, film_y: Tensor):
    """The LUT shaping's per-film-point constants (zoic.cpp:1891-1911):
    ``(max_scale * 1.05, centroid_x, fastSin(theta), fastCos(theta))`` with
    ``theta = atan2(film_y, film_x)``."""
    dist = torch.abs(optics.sqrt(film_x * film_x + film_y * film_y))
    max_scale, translation = lut_lookup(lut, dist)
    theta = torch.atan2(film_y, film_x)
    return max_scale, translation, optics.fast_sin(theta), optics.fast_cos(theta)


def shape_sample(lut: PupilLUT, lens_x: Tensor, lens_y: Tensor,
                 film_x: Tensor, film_y: Tensor) -> Tuple[Tensor, Tensor]:
    """Apply the LUT shaping to unit-disk samples for film points
    (``zoic_tpu.pupil.shape_sample``, zoic.cpp:1891-1924): scale to the
    interpolated pupil bound, translate x by the interpolated centroid,
    rotate by ``atan2(y, x)`` with the reference's fastSin/fastCos."""
    max_scale, translation, s, c = lut_shaping(lut, film_x, film_y)
    lx = lens_x * max_scale + translation
    ly = lens_y * max_scale
    return lx * c - ly * s, lx * s + ly * c


def _polar_offsets(u: Tensor, domain: str):
    """Unit-domain cover offsets ``(lx, ly, rho, phi)`` from uniforms ``u``
    of shape ``(2, ...)``: uniform over the [-1, 1] square, or over the unit
    disk (support coverage, not importance)."""
    if domain == "square":
        lx = u[0] * 2.0 - 1.0
        ly = u[1] * 2.0 - 1.0
        return lx, ly, optics.sqrt(lx * lx + ly * ly), torch.atan2(ly, lx)
    rho = optics.sqrt(u[0])
    phi = (u[1] * 2.0 - 1.0) * f32(np.pi)
    return rho * optics.cos(phi), rho * optics.sin(phi), rho, phi


def build_profile(
    lens: LensSystem,
    n_angles: int = 16,
    n_samples: int = 50_000,
    domain: str = "disk",
    *,
    uniforms: Optional[Mapping] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[PupilProfile, Tensor]:
    """The harmonic polar outer bound of the accepted-sample support per
    LUT film-radius key (``zoic_tpu.pupil.build_profile``), fitted alone:
    per-angle-bin maximum accepted radius, least squares on the cos
    {0, 1, 2, 4} basis shifted up by its worst under-fit plus the (+0.005,
    x1.01) guard (the naive cover: the rotation-invariant circumradius),
    then loosened by every violation on an independent held-out set.

    ``domain`` is ``"disk"`` (concentric-map candidates) or ``"square"``
    (image-bokeh offsets, which reach the corners).  The fit and held-out
    traces take ``uniforms["fit"]`` and ``uniforms["held"]``, each
    ``(2, n_keys, n_samples)``, when given, else draw them in that order
    from ``generator``.  Returns ``(PupilProfile, key_acceptance)``; the
    polynomial is a zero placeholder (:func:`build_precheck` fits it)."""
    dev = lens.ior.device
    lut = lens.lut
    n_keys = lut.keys.shape[0] if lut is not None else 32
    keys = (lut.keys if lut is not None
            else torch.arange(n_keys, dtype=torch.float32, device=dev)
            * f32(FILM_WIDTH / 32))
    shape = (2, n_keys, n_samples)
    u = draw_uniforms(uniforms, "fit", shape, generator, dev)
    uh = draw_uniforms(uniforms, "held", shape, generator, dev)

    _, _, rho, phi = _polar_offsets(u, domain)
    ok = _cover_trace(lens, keys, u, domain)[2]
    key_acceptance = ok.to(torch.float32).mean(1)

    # per-angle-bin max accepted radius
    two_pi = f32(2.0 * np.pi)
    bin_idx = torch.clamp(
        (optics.div(phi + f32(np.pi), two_pi) * n_angles).to(torch.int64),
        0, n_angles - 1)
    rho_ok = torch.where(ok, rho, 0.0)
    rho_max = torch.zeros((n_keys, n_angles), dtype=torch.float32,
                          device=dev).scatter_reduce(1, bin_idx, rho_ok, "amax")

    if lut is not None:
        centers = (optics.div(torch.arange(n_angles, dtype=torch.float32,
                                           device=dev) + 0.5, n_angles)
                   * two_pi - f32(np.pi))
        basis = torch.stack([torch.ones_like(centers), optics.cos(centers),
                             optics.cos(2.0 * centers),
                             optics.cos(4.0 * centers)], -1)   # [A, 4]
        coef = torch.linalg.lstsq(basis, rho_max.T).solution      # [4, K]
        excess = (rho_max.T - basis @ coef).amax(0)
        c0 = (coef[0] + torch.clamp_min(excess, 0.0) + 0.005) * 1.01
        c1, c2, c4 = coef[1] * 1.01, coef[2] * 1.01, coef[3] * 1.01
    else:
        # naive cover: the support rotates with film azimuth, so the bound
        # is the rotation-invariant circumradius
        c0 = (rho_max.amax(1) + 0.005) * 1.01
        c1 = c2 = c4 = torch.zeros_like(c0)

    # held-out validation: loosen c0 by every observed violation
    _, _, rho_h, phi_h = _polar_offsets(uh, domain)
    ok_h = _cover_trace(lens, keys, uh, domain)[2]
    bound_h = (c0[:, None] + c1[:, None] * optics.cos(phi_h)
               + c2[:, None] * optics.cos(2.0 * phi_h)
               + c4[:, None] * optics.cos(4.0 * phi_h))
    viol = torch.where(ok_h, rho_h - bound_h, -float("inf")).amax(1)
    c0 = c0 + torch.clamp_min(viol, 0.0)
    profile = PupilProfile(
        keys=keys, c0=c0, c1=c1, c2=c2, c4=c4,
        poly=torch.zeros((4, POLY_DEGREE + 1), dtype=torch.float32,
                         device=dev),
        poly_scale=keys[-1],
    )
    return profile, key_acceptance


def profile_poly_eval(profile: PupilProfile, dist: Tensor):
    """The polynomial bound form (``zoic_tpu.pupil.profile_poly_eval``, the
    kernels' Horner math): per coefficient in ``t = dist / poly_scale``,
    with the pre-check disabled (every candidate passes) beyond the fitted
    domain: the harmonic constant term, or the circles' q slots, set to
    1e9 there."""
    scale = (profile.poly_scale if profile.poly_scale is not None
             else profile.keys[-1])
    t_raw = dist / scale
    t = torch.clamp_max(t_raw, 1.0)
    deg = profile.poly.shape[1] - 1
    outs = []
    for j in range(4):
        acc = profile.poly[j, deg] * torch.ones_like(t)
        for k in range(deg - 1, -1, -1):
            acc = acc * t + profile.poly[j, k]
        outs.append(acc)
    off = t_raw > 1.0
    slots = (1, 3) if profile.kind == "circles" else (0,)
    for j in slots:
        outs[j] = torch.where(off, f32(1e9), outs[j])
    return tuple(outs)


def precheck_pass(profile: PupilProfile, dist: Tensor, lx: Tensor,
                  ly: Tensor, use_poly: bool = False) -> Tensor:
    """Does the pre-check bound pass candidate offset ``(lx, ly)`` at film
    radius ``dist`` (``zoic_tpu.pupil.precheck_pass``)?  The bound's kind
    (circle pair or harmonic series) and form (lerped per key or its
    polynomial) as the profile and ``use_poly`` say."""
    vals = (profile_poly_eval(profile, dist) if use_poly
            else profile_lookup(profile, dist))
    if profile.kind == "circles":
        a1, q1, a2, q2 = vals
        rr = lx * lx + ly * ly
        return ((rr - 2.0 * a1 * lx) <= q1) & ((rr - 2.0 * a2 * lx) <= q2)
    c0, c1, c2, c4 = vals
    rho = optics.sqrt(lx * lx + ly * ly)
    phi = torch.atan2(ly, lx)
    return rho <= (c0 + c1 * optics.cos(phi) + c2 * optics.cos(2.0 * phi)
                   + c4 * optics.cos(4.0 * phi))


def dead_film_fraction(keys, key_acceptance, r_max: float) -> float:
    """Film-area-weighted fraction of profile keys whose per-draw
    acceptance is below the budget's reach (a_k < 1/26: such rays are
    vignetted by design, zoic.cpp:1767).  A radius r carries annulus weight
    ~ r, cut at ``r_max`` (the film square's circumradius)."""
    acc = _np(key_acceptance).astype(np.float64)
    k = _np(keys).astype(np.float64)
    w = np.where(k <= r_max, np.maximum(k, k[1] if k.shape[0] > 1 else 1.0), 0.0)
    dead = acc < (1.0 / 26.0)
    return float((w * dead).sum() / max(w.sum(), 1e-9))


def _poly_interval_max(coefs: np.ndarray, lo: float, hi: float) -> float:
    """Exact max of a batch of 1-D polynomials over [lo, hi].

    ``coefs`` is [N, D+1] ascending-power.  The max of each polynomial is
    attained at an endpoint or a real root of its derivative — found via
    batched companion-matrix eigenvalues (no sampling grid involved)."""
    n, dp1 = coefs.shape
    best = np.maximum(
        (coefs * lo ** np.arange(dp1)).sum(1),
        (coefs * hi ** np.arange(dp1)).sum(1),
    )
    # derivative coefficients, ascending: d/dt sum a_k t^k = sum k a_k t^(k-1)
    dcoef = coefs[:, 1:] * np.arange(1, dp1)[None, :]    # [N, D]
    # normalize rows; degrees can collapse when leading terms vanish
    scale = np.max(np.abs(dcoef), axis=1, keepdims=True)
    ok_rows = scale[:, 0] > 0.0
    dn = np.where(scale > 0, dcoef / np.maximum(scale, 1e-300), 0.0)
    deg = dp1 - 2
    # split rows by effective degree (leading coeff ~0 -> lower degree)
    for d_eff in range(deg, 0, -1):
        lead = dn[:, d_eff]
        rows = np.where(ok_rows & (np.abs(lead) > 1e-12))[0]
        if rows.size:
            # batched companion matrices of the degree-d_eff polynomials
            comp = np.zeros((rows.size, d_eff, d_eff))
            comp[:, 1:, :-1] = np.eye(d_eff - 1)[None]
            comp[:, :, -1] = -dn[rows, :d_eff] / lead[rows, None]
            roots = np.linalg.eigvals(comp)               # [R, d_eff]
            real = np.abs(roots.imag) < 1e-9
            tt = np.clip(roots.real, lo, hi)
            vals = np.zeros_like(tt)
            for k in range(dp1):
                vals += coefs[rows, k][:, None] * tt ** k
            vals = np.where(real, vals, -np.inf)
            best[rows] = np.maximum(best[rows], vals.max(1))
            ok_rows[rows] = False
        # remaining rows: their lead coeff at this degree is ~0, retry lower
    return float(best.max())


def fit_profile_poly(profile: PupilProfile,
                     r_max: Optional[float] = None) -> Tuple[Tensor, Tensor, float]:
    """Fit the per-key lerped bound with one degree-``POLY_DEGREE``
    polynomial per coefficient in ``t = dist / poly_scale``, uplifted so
    that the polynomial bound dominates the per-key bound for every
    (dist, phi) on the film (``zoic_tpu.pupil.fit_profile_poly``: the
    under-fit maximum is computed analytically per key interval, the
    azimuth scanned on a dense grid).  Returns ``(poly [4, D+1],
    poly_scale, deficit)``, ``deficit`` the raw worst-case under-fit."""
    dev = profile.keys.device
    keys = _np(profile.keys).astype(np.float64)
    dmax = keys[-1]
    scale = dmax if r_max is None else min(float(r_max), dmax)
    tmax = 1.0
    # least-squares target on a dense grid (the grid only shapes the FIT;
    # soundness comes from the analytic uplift below)
    n_grid = (keys.shape[0] - 1) * 16 + 1
    d = np.union1d(
        np.linspace(0.0, tmax, n_grid) * scale, keys[keys <= scale]
    )
    t = d / scale
    c0, c1, c2, c4 = (
        _np(v).astype(np.float64)
        for v in profile_lookup(
            profile, optics.upload(np.asarray(d, np.float32), dev))
    )
    targ = np.stack([c0, c1, c2, c4])                    # [4, n_grid]
    v = t[:, None] ** np.arange(POLY_DEGREE + 1)[None, :]
    coef, *_ = np.linalg.lstsq(v, targ.T, rcond=None)    # [D+1, 4]

    # ---- analytic worst-case under-fit (deficit) ----------------------
    phi = np.linspace(0.0, 2.0 * np.pi, 256, endpoint=False)
    w = np.stack(
        [np.ones_like(phi), np.cos(phi), np.cos(2 * phi), np.cos(4 * phi)]
    )                                                    # [4, n_phi]
    cc = np.stack([_np(c).astype(np.float64) for c in
                   (profile.c0, profile.c1, profile.c2, profile.c4)])  # [4, K]
    deficit = -np.inf
    edges = [0.0] + [float(k) for k in keys if 0.0 < k < scale] + [scale]
    for lo_d, hi_d in zip(edges[:-1], edges[1:]):
        if hi_d - lo_d <= 0:
            continue
        lo_t, hi_t = lo_d / scale, hi_d / scale
        # chain coefficients as linear polys in t on this interval: the
        # lerp runs between the bracketing keys (profile_lookup semantics)
        i_lb = min(int(np.ceil(hi_d / (keys[1] - keys[0]) - 1e-12)), len(keys) - 1)
        i_pr = max(i_lb - 1, 0)
        k_lb, k_pr = keys[i_lb], keys[i_pr]
        den = k_pr - k_lb
        out_v = np.zeros((4, 2))
        for j in range(4):
            if den != 0.0:
                # value(d) = c[lb] + (d - k_lb)/(k_pr - k_lb) * (c[pr]-c[lb])
                sl = (cc[j, i_pr] - cc[j, i_lb]) / den
                out_v[j, 0] = cc[j, i_lb] - k_lb * sl
                out_v[j, 1] = sl * scale       # d = t * scale
            else:
                out_v[j, 0] = cc[j, i_lb]
        # g coefficients per phi: [n_phi, D+1]
        lin = np.zeros((4, POLY_DEGREE + 1))
        lin[:, :2] = out_v
        gcoef = np.einsum("jp,jk->pk", w, lin - coef.T)
        deficit = max(deficit, _poly_interval_max(gcoef, lo_t, hi_t))

    poly = coef.T.copy()                                 # [4, D+1]
    # uplift + a pad for f32 Horner evaluation noise in-kernel and for the
    # azimuth-grid spacing
    poly[0, 0] += max(deficit, 0.0) + 1e-4
    return (
        optics.upload(poly, dev),
        optics.upload(np.float32(scale), dev),
        float(deficit),
    )


def fit_precheck_poly(profile: PupilProfile, r_max: Optional[float] = None):
    """Kind-dispatching poly fit for a bare profile: harmonic bounds use
    :func:`fit_profile_poly`; circle-pair bounds have no standalone refit
    (their poly needs the cover samples, :func:`build_precheck`), so this
    returns zeros and an infinite deficit (poly form gated off)."""
    if profile.kind == "circles":
        keys = profile.keys
        scale = keys[-1] if r_max is None else torch.minimum(
            optics.upload(f32(r_max), keys.device), keys[-1])
        return (torch.zeros((4, CIRCLE_POLY_DEGREE + 1), dtype=torch.float32,
                            device=keys.device), scale, float("inf"))
    return fit_profile_poly(profile, r_max=r_max)


def _cover_trace(lens: LensSystem, radii: Tensor, u: Tensor, domain: str):
    """Trace ``u.shape[2]`` cover candidates per film radius through the
    stack under the active sampling cover (LUT shaping when present, else
    naive first-element targeting), from the uniforms ``u`` of shape
    ``(2, len(radii), n)``.  Returns unit-domain offsets ``(lx, ly)`` and
    the acceptance mask ``ok``."""
    lx, ly, _, _ = _polar_offsets(u, domain)
    fx = radii[:, None].expand(lx.shape)
    if lens.lut is not None:
        ms, trn = lut_lookup(lens.lut, fx)
        px = lx * ms + trn
        py = ly * ms
    else:
        px = lx * lens.aperture[0]
        py = ly * lens.aperture[0]
    zeros = torch.zeros_like(fx)
    oz = zeros + lens.origin_shift
    ok = trace.trace_stack(
        lens, V3(fx, zeros, oz), V3(px - fx, py, zeros - lens.thickness[0])
    ).ok
    return lx, ly, ok


def _circle_viol(a1, q1, a2, q2, lx, ly, ok):
    """Per-key q loosening needed so every accepted sample passes BOTH
    circles: max over accepted of (rho^2 - 2 a_j lx - q_j), per circle,
    floored at 0 (0 where a key has none).  Over a key's accepted samples
    alone, and with q_j subtracted after the max: rounding is monotone, so
    max(fl(x - q)) = fl(max(x) - q) and the bits are those of the
    reference's masked [keys, samples] form (``zoic_tpu/pupil.py``).  The
    maxima on the card for CUDA tensors (``ops/precheck_reduce``)."""
    t = precheck_reduce.circle_excess(lx, ly, ok, 2.0 * np.stack([a1, a2], 1))
    return np.maximum(t[:, 0] - q1, 0.0), np.maximum(t[:, 1] - q2, 0.0)


def _cosines(lxn, lyn) -> np.ndarray:
    """numpy's float32 ``cos(phi)``, ``cos(2 phi)``, ``cos(4 phi)`` of the
    samples' azimuth ``phi = arctan2(ly, lx)``, ``[3, R, N]``."""
    phi = np.arctan2(lyn, lxn)
    return np.stack([np.cos(phi), np.cos(2 * phi), np.cos(4 * phi)])


def build_precheck(
    lens: LensSystem,
    n_samples: int = 50_000,
    domain: str = "disk",
    r_max: Optional[float] = None,
    *,
    uniforms: Optional[Mapping] = None,
):
    """Build the pupil pre-check bound (``zoic_tpu.pupil.build_precheck``):
    fit the harmonic polar bound and the 2-circle cover from one trace
    budget, loosen both by every violation on an independent held-out set
    at the keys and at the key midpoints, keep the form with the smaller
    film-weighted E[bound-pass / accept], and fit its polynomial form.

    The three cover traces take the uniforms ``uniforms["cover_fit"]``,
    ``["cover_held"]`` (both ``(2, n_keys, n_samples)``) and
    ``["cover_mid"]`` (``(2, n_keys - 1, max(n_samples // 2, 1))``) when
    given, else drawn here in that order.

    Returns ``(PupilProfile, key_acceptance, poly_deficit)``;
    ``poly_deficit`` is inf when no polynomial was fitted."""
    dev = lens.ior.device
    lut = lens.lut
    n_keys = lut.keys.shape[0] if lut is not None else 32
    keys = (
        lut.keys
        if lut is not None
        else torch.arange(n_keys, dtype=torch.float32, device=dev)
        * f32(FILM_WIDTH / 32)
    )
    with span("zoic.precheck.covers"):
        keys_np = _np(keys).astype(np.float64)
        spacing = float(keys_np[1] - keys_np[0])

        # --- fit set + held-out set at the keys, midpoint held-out between --
        n_mid = max(n_samples // 2, 1)
        mids = optics.upload(keys_np[:-1] + spacing * 0.5, dev)
        traces = []
        for name, radii, n in (("cover_fit", keys, n_samples),
                               ("cover_held", keys, n_samples),
                               ("cover_mid", mids, n_mid)):
            u = draw_uniforms(uniforms, name, (2, radii.shape[0], n), None, dev)
            traces.append(_cover_trace(lens, radii, u, domain))
        (lx, ly, ok), (lxh, lyh, okh), (lxm, lym, okm) = traces
        # the host reads the offsets back for numpy's arctan2 and cos alone;
        # the reductions over the samples run where they lie
        # (ops/precheck_reduce: on the card for CUDA tensors)
        lxn, lyn, lxhn, lyhn, lxmn, lymn = precheck_reduce.host(
            lx, ly, lxh, lyh, lxm, lym)
        key_acceptance = ok.to(torch.float32).mean(1)
        live_fit = precheck_reduce.accepted(ok) > 0.0

    with span("zoic.precheck.harmonic"):
        n_angles = 16
        with span("zoic.precheck.trig"):
            phin = np.arctan2(lyn, lxn)
            bin_idx = np.clip(
                ((phin + np.pi) / (2 * np.pi) * n_angles).astype(np.int64), 0,
                n_angles - 1
            )
            cos_h = precheck_reduce.routed(_cosines(lxhn, lyhn), lxh)
            cos_m = precheck_reduce.routed(_cosines(lxmn, lymn), lxm)

        # --- harmonic fit (build_profile math, numpy f64) -------------------
        rho_max = precheck_reduce.bin_max(lx, ly, ok, bin_idx, n_angles)
        centers = (np.arange(n_angles) + 0.5) / n_angles * 2 * np.pi - np.pi
        basis = np.stack(
            [np.ones_like(centers), np.cos(centers), np.cos(2 * centers),
             np.cos(4 * centers)], -1
        )
        if lut is not None:
            coef, *_ = np.linalg.lstsq(basis, rho_max.T, rcond=None)  # [4, K]
            fit = basis @ coef
            excess = np.maximum((rho_max.T - fit).max(0), 0.0)
            hc0 = (coef[0] + excess + 0.005) * 1.01
            hc1, hc2, hc4 = coef[1] * 1.01, coef[2] * 1.01, coef[3] * 1.01
            # reject-all bound at keys with NO accepted cover sample, set before
            # the held-out and midpoint passes (zoic_tpu/pupil.py:753-769)
            emp = ~live_fit
            hc0 = np.where(emp, -0.05, hc0)
            hc1 = np.where(emp, 0.0, hc1)
            hc2 = np.where(emp, 0.0, hc2)
            hc4 = np.where(emp, 0.0, hc4)
        else:
            # naive cover: support rotates with film azimuth (no R(theta) in
            # the cover) — emit the rotation-invariant circumradius bound
            hc0 = (rho_max.max(1) + 0.005) * 1.01
            hc1 = hc2 = hc4 = np.zeros(n_keys)

        def _harm_viol(chain, i_a, i_b, w_b, lx_s, ly_s, ok_s, cos_s):
            # row r's bound lerps the chain between keys i_a[r] and i_b[r]
            coef = np.stack([c[i_a] * (1 - w_b) + c[i_b] * w_b for c in chain])
            v = precheck_reduce.harmonic_excess(lx_s, ly_s, ok_s, cos_s, coef)
            out = np.zeros(n_keys)
            for k_a, k_b, v_r in zip(i_a, i_b, v):
                if v_r > 0:
                    out[k_a] = max(out[k_a], v_r)
                    out[k_b] = max(out[k_b], v_r)
            return out

        # held-out at keys, then midpoints (lerped chain = kernel math)
        ki = np.arange(n_keys)
        hc0 = hc0 + _harm_viol((hc0, hc1, hc2, hc4), ki, ki, 0.0,
                               lxh, lyh, okh, cos_h)
        hc0 = hc0 + _harm_viol((hc0, hc1, hc2, hc4), ki[:-1], ki[1:], 0.5,
                               lxm, lym, okm, cos_m)

    # --- circle fit ------------------------------------------------------
    with span("zoic.precheck.circles"):
        # CUDA tensors run the fit's reductions on the card, bit-equal
        a1, q1, a2, q2 = circles_kernel.fit_circles(lx, ly, ok)
        if lut is None:
            # rotation-invariant for the naive cover (see harmonic note)
            r_circ = rho_max.max(1) * 1.01 + 0.005
            a1 = a2 = np.zeros(n_keys)
            q1 = q2 = np.where(live_fit, r_circ**2, -1.0)
        else:
            # smooth the selected center staircases with the degree-POLY_DEGREE
            # family; radii are recomputed at the moved centers over ALL
            # accepted samples, so soundness is unaffected by the smoothing
            rm_fit = min(float(r_max), float(keys_np[-1])) if r_max else float(
                keys_np[-1]
            )
            tt = keys_np / rm_fit
            m = (keys_np <= rm_fit) & live_fit
            if m.sum() >= 3:
                deg = min(POLY_DEGREE, int(m.sum()) - 1)
                vv = tt[m, None] ** np.arange(deg + 1)[None, :]
                for a in (a1, a2):
                    co, *_ = np.linalg.lstsq(vv, a[m], rcond=None)
                    a[m] = vv @ co
            m2 = circles_kernel.reach_at(lx, ly, ok, np.stack([a1, a2], 1))
            for k in np.where(live_fit)[0]:
                r1k = np.sqrt(m2[k, 0]) * 1.01 + 0.005
                r2k = np.sqrt(m2[k, 1]) * 1.01 + 0.005
                q1[k] = r1k**2 - a1[k] ** 2
                q2[k] = r2k**2 - a2[k] ** 2
        v1, v2 = _circle_viol(a1, q1, a2, q2, lxh, lyh, okh)
        q1, q2 = q1 + v1, q2 + v2
        # midpoints: the kernel lerps (a, q); loosen BOTH bracketing keys
        a1m = (a1[:-1] + a1[1:]) * 0.5
        a2m = (a2[:-1] + a2[1:]) * 0.5
        q1m = (q1[:-1] + q1[1:]) * 0.5
        q2m = (q2[:-1] + q2[1:]) * 0.5
        v1m, v2m = _circle_viol(a1m, q1m, a2m, q2m, lxm, lym, okm)
        # raising BOTH bracketing keys' q by >= the interval's violation raises
        # the lerped midpoint by >= it; a key shared by two intervals takes the
        # larger requirement
        for v, q in ((v1m, q1), (v2m, q2)):
            u = np.zeros_like(q)
            u[:-1] = v
            u[1:] = np.maximum(u[1:], v)
            q += u

    # --- pick the tighter form (film-weighted E proxy on held-out) ------
    with span("zoic.precheck.pick"):
        # the held-out set's pass shares: the bound of each form over all
        # of a key's samples, the cosines those of the harmonic pass
        acc_h = precheck_reduce.accepted(okh)
        pass_harm = precheck_reduce.harmonic_share(
            lxh, lyh, cos_h, np.stack([hc0, hc1, hc2, hc4]))
        pass_circ = precheck_reduce.circle_share(
            lxh, lyh, 2 * np.stack([a1, a2], 1), np.stack([q1, q2], 1))
        rm = float(r_max) if r_max is not None else float(keys_np[-1])
        w = np.where(keys_np <= rm, np.maximum(keys_np, keys_np[1]), 0.0)
        live = (acc_h > 1e-6) & (w > 0)
        if live.any():
            e_h = float(
                (w[live] * (pass_harm[live] / acc_h[live])).sum() / w[live].sum()
            )
            e_c = float(
                (w[live] * (pass_circ[live] / acc_h[live])).sum() / w[live].sum()
            )
        else:
            e_h = e_c = 1.0
        kind = "circles" if e_c <= e_h else "harmonic"
        log.info("[ZOIC] pupil pre-check: E[pass/accept] harmonic %.3f, circles "
                 "%.3f -> %s", e_h, e_c, kind)
        chains = (a1, q1, a2, q2) if kind == "circles" else (hc0, hc1, hc2, hc4)

        def t32(a):
            return optics.upload(np.asarray(a), dev)

        prof = PupilProfile(
            keys=keys,
            c0=t32(chains[0]), c1=t32(chains[1]), c2=t32(chains[2]),
            c4=t32(chains[3]),
            poly=torch.zeros((4, POLY_DEGREE + 1), dtype=torch.float32,
                             device=dev),
            poly_scale=keys[-1],
            kind=kind,
        )

    # --- polynomial bound form ------------------------------------------
    # harmonic: fit to the validated chain with the analytic domination
    # uplift; circles: fitted directly to the per-radius requirement
    # against smooth centers, validated on the fit, held-out and midpoint
    # sets (zoic_tpu/pupil.py:892-963)
    with span("zoic.precheck.poly"):
        deficit = float("inf")
        if r_max is not None:
            if kind == "harmonic":
                poly, poly_scale, deficit = fit_profile_poly(prof, r_max=r_max)
                prof = dataclasses.replace(prof, poly=poly, poly_scale=poly_scale)
            else:
                rm_fit = min(float(r_max), float(keys_np[-1]))
                msk = keys_np <= rm_fit + 1e-9
                mid_msk = (keys_np[:-1] + spacing * 0.5) <= rm_fit + 1e-9
                if bool(live_fit[msk].all()) and int(msk.sum()) >= (
                    CIRCLE_POLY_DEGREE + 2
                ):
                    tk = keys_np[msk] / rm_fit
                    tm = (keys_np[:-1] + spacing * 0.5)[mid_msk] / rm_fit
                    vd = np.arange(CIRCLE_POLY_DEGREE + 1)
                    vk = tk[:, None] ** vd[None, :]
                    vm = tm[:, None] ** vd[None, :]
                    vall = np.concatenate([vk, vm], 0)
                    poly = np.zeros((4, CIRCLE_POLY_DEGREE + 1))
                    deficit = 0.0
                    # center polys: fit the (smoothed) per-key centers
                    ca = [np.linalg.lstsq(vk, a_ch[msk], rcond=None)[0]
                          for a_ch in (a1, a2)]
                    ak = np.stack([vk @ c for c in ca], 1)
                    am = np.stack([vm @ c for c in ca], 1)
                    # per-radius requirement against the POLY centers: the
                    # max of (x - a)^2 + y^2 over a key's accepted fit and
                    # held-out samples, over a midpoint's, 0 where none
                    cen_k = np.zeros((n_keys, 2))
                    cen_k[msk] = ak
                    cen_m = np.zeros((n_keys - 1, 2))
                    cen_m[mid_msk] = am
                    reach = precheck_reduce.circle_reach
                    req_k = np.maximum(reach(lx, ly, ok, cen_k),
                                       reach(lxh, lyh, okh, cen_k))[msk]
                    req_m = reach(lxm, lym, okm, cen_m)[mid_msk]
                    reqs = np.maximum(np.concatenate([req_k, req_m]), 0.0)
                    for ci in range(2):
                        ja, jq = 2 * ci, 2 * ci + 1
                        ca_j = ca[ci]
                        a_all = np.concatenate([ak[:, ci], am[:, ci]])
                        req = reqs[:, ci]
                        # margined on the radius like the chain (x1.01, +5e-3)
                        r_m = np.sqrt(req) * 1.01 + 0.005
                        q_req = r_m**2 - a_all**2
                        cq, *_ = np.linalg.lstsq(vall, q_req, rcond=None)
                        fitq = vall @ cq
                        cq[0] += np.maximum((q_req - fitq).max(), 0.0) + 1e-4
                        poly[ja], poly[jq] = ca_j, cq
                        # tightness: radius inflation of the poly circle over
                        # the margined requirement, at the validated radii
                        r_poly = np.sqrt(
                            np.maximum(vall @ cq + a_all**2, 0.0)
                        )
                        deficit = max(deficit, float((r_poly - r_m).max()))
                    prof = dataclasses.replace(
                        prof,
                        poly=t32(poly),
                        poly_scale=optics.upload(np.float32(rm_fit), dev),
                    )
    return prof, key_acceptance, deficit
