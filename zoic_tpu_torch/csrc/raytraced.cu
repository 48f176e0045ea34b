// Raytraced camera-ray generation for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel zoic_tpu/ops/trace_kernel.py:_raytraced_kernel
// (wrapper raytraced_fused) in every variant zoic_tpu.create_rays reaches:
// exit-pupil LUT or naive first-element shaping; the pupil pre-check or none,
// its bound the 2-circle cover or the harmonic cos series, from its Horner
// polynomial or lerped per key (the select chain); static or table-read
// element flags; the iris refract-identity skip; hash or presampled (image
// bokeh) draws.  The variant is one word of bits, the same for every thread
// of a launch, so its branches are uniform: one build serves them all.
//
// What it computes, per ray i (flat index in the batch):
//   film point -> shaping: LUT lerp + fastSin rotation folded into an affine
//   (sa, sb, kx, ky), or the naive scale aperture[0] -> pre-check
//   coefficients -> if the bound rejects the whole domain, tries = max_total
//   (dead-key short-circuit).  Then rounds: round 0 takes the caller's draw
//   (u1, u2), which consumes no try, and with the pre-check scans up to K
//   more draws; retry round rnd scans K draws (1 without the pre-check).  A
//   round stops at the first draw inside the bound and traces it through the
//   element stack; every draw after the caller's consumes a try.  Retry
//   draws come from the counter hash keyed by (i, seed, try), or presampled
//   from the [P, bp] planes at draw index j - 1 (round 0), K*rnd + j (retry
//   round, pre-check) or rnd - 1 (no pre-check), read at the cell that the
//   TPU kernel's whole-tile loop gives ray i (plane_cell, common.cuh).
//   Output: origin = -payload.o, dir = -payload.d, tries, tir.
// The reference's compacted retry machine (fold eras, bitonic unsort) is
// the TPU's answer to lanes in lockstep; here each thread walks its own
// rounds, which gives the whole-tile loop's per-ray result because every
// draw is a function of the ray, its try count or round, and the batch.
//
// What bounds it on this card: float compute, with 16 B read and 32 B
// written per ray, plus up to two 4 B plane reads per presampled draw.  The
// tables (elements E x 8, shaping keys x 6, polynomial 4 x (D+1), 8 scalars;
// under 6 KB) are loaded into shared memory once per block.  Its known cost
// is retry divergence inside a warp: a warp runs until its slowest ray
// resolves.
//
// Rounding: built with --fmad=false and IEEE division and square root so
// that every operation rounds like the eager PyTorch version
// (zoic_tpu_torch/ops/trace_kernel.py:raytraced_plain), in the same order.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace zoic;

constexpr int kBlock = 256;
constexpr int kMaxElems = 64;
constexpr int kMaxKeys = 128;
constexpr int kMaxCoef = 32;

// variant bits (trace_kernel._V_*)
constexpr int kLut = 1;         // exit-pupil LUT shaping, else naive
constexpr int kProfile = 2;     // pupil pre-check
constexpr int kPoly = 4;        // pre-check from the polynomial, else chain
constexpr int kCircles = 8;     // 2-circle bound, else harmonic
constexpr int kPresampled = 16; // image-bokeh offsets and retry planes
constexpr int kStatic = 32;     // static element flags, else table-read

struct Payload {
  float ox, oy, oz, dx, dy, dz;
};

// Element-stack trace with a latched fail that freezes the ray at its last
// reached hit.  Element table row: [center_z, eta^2, 1/R, R^2, cull_r^2,
// eta, tir_thr, sign_r]; static flags bit 0 = TIR possible, bit 1 = R < 0.
__device__ __forceinline__ void trace(const float* __restrict__ el,
                                      const int* __restrict__ flags,
                                      int n_elems, int iris_idx,
                                      bool static_flags, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      Payload& out, bool& ok,
                                      bool& tir_any) {
  float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  bool fail = false;
  tir_any = false;
  for (int i = 0; i < n_elems; ++i) {
    const float* e = el + 8 * i;
    const float cz = e[0], eta_sq = e[1], inv_r = e[2], r_sq = e[3];
    const float cull_r_sq = e[4], eta = e[5], tir_thr = e[6], sign_r = e[7];
    const int fl = flags[i];
    float lz = cz - oz;
    float tca = lz * dz - (ox * dx + oy * dy);
    float px = ox + tca * dx;
    float py = oy + tca * dy;
    float pz = lz - tca * dz;
    float d2 = px * px + py * py + pz * pz;
    float thc = fast_sqrt(fabsf(r_sq - d2));
    float t;
    if (static_flags)
      t = (fl & 2) ? tca - thc : tca + thc;
    else
      t = tca + thc * sign_r;
    float hx = ox + dx * t;
    float hy = oy + dy * t;
    float h2 = hx * hx + hy * hy;
    fail = fail || (d2 > r_sq) || (h2 > cull_r_sq);
    if (!fail) {
      float hz = oz + dz * t;
      ox = hx;
      oy = hy;
      oz = hz;
    }
    if (i == iris_idx) continue;  // eta == 1: refraction is the identity
    float wz = cz - oz;
    float c1 = ((ox * dx + oy * dy) - wz * dz) * inv_r;
    float cs2 = eta_sq * (1.0f - c1 * c1);
    if (!static_flags || (fl & 1)) {
      bool tir = (cs2 > (static_flags ? 1.0f : tir_thr)) && !fail;
      tir_any = tir_any || tir;
      fail = fail || tir;
    }
    float k = eta * c1 - fast_sqrt(fabsf(1.0f - cs2));
    float kk = fail ? 0.0f : k * inv_r;
    float ee = fail ? 1.0f : eta;
    float ndx = dx * ee - ox * kk;
    float ndy = dy * ee - oy * kk;
    float ndz = dz * ee + wz * kk;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }
  out = Payload{ox, oy, oz, dx, dy, dz};
  ok = !fail;
}

// Pre-check bound test of one candidate offset.  Circles: pc = (2 a1, q1,
// 2 a2, q2), inside both circles.  Harmonic: pc = (c0, c1, c2, c4),
// rho <= c0 + c1 cos + c2 cos 2phi + c4 cos 4phi by Chebyshev from one rsqrt.
__device__ __forceinline__ bool bound_pass(float lx, float ly,
                                           const float (&pc)[4],
                                           bool circles) {
  const float rr = lx * lx + ly * ly;
  if (circles)
    return ((rr - pc[0] * lx) <= pc[1]) && ((rr - pc[2] * lx) <= pc[3]);
  const float r_inv = rsqrtf(max_nan(rr, F32(1e-18)));
  const float rho = rr * r_inv;
  const float cphi = lx * r_inv;
  const float t2 = 2.0f * cphi * cphi - 1.0f;
  const float t4 = 2.0f * t2 * t2 - 1.0f;
  return rho <= pc[0] + pc[1] * cphi + pc[2] * t2 + pc[3] * t4;
}

__device__ __forceinline__ float circle_min(float a) {
  float aa = fabsf(a);
  return (aa <= 2.0f) ? -0.25f * a * a : 1.0f - aa;
}

// Whether the bound rejects every candidate of the domain.
__device__ __forceinline__ bool bound_dead(const float (&pc)[4],
                                           bool circles) {
  if (circles)
    return (circle_min(pc[0]) > pc[1]) || (circle_min(pc[2]) > pc[3]);
  return (pc[0] + fabsf(pc[1]) + fabsf(pc[2]) + fabsf(pc[3])) < 0.0f;
}

__global__ void __launch_bounds__(kBlock)
raytraced_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                 const float* __restrict__ u1, const float* __restrict__ u2,
                 const float* __restrict__ bu1, const float* __restrict__ bu2,
                 const float* __restrict__ elems_g,
                 const int* __restrict__ flags_g,
                 const float* __restrict__ shap_g,
                 const float* __restrict__ prof_g,
                 const float* __restrict__ scal_g, float* __restrict__ origin,
                 float* __restrict__ dir, int* __restrict__ tries_out,
                 int* __restrict__ tir_out, int B, int n_elems, int n_keys,
                 int n_coef, int iris_idx, int max_total, int seed,
                 int variant, int k_draws, int n_planes, int bp,
                 int tile_rows, int plane_tiles, bool reuse) {
  __shared__ float elems[kMaxElems * 8];
  __shared__ int flags[kMaxElems];
  __shared__ float shap[kMaxKeys * 6];
  __shared__ float prof[4 * kMaxCoef];
  __shared__ float scal[8];
  for (int j = threadIdx.x; j < n_elems * 8; j += blockDim.x) elems[j] = elems_g[j];
  for (int j = threadIdx.x; j < n_elems; j += blockDim.x) flags[j] = flags_g[j];
  for (int j = threadIdx.x; j < n_keys * 6; j += blockDim.x) shap[j] = shap_g[j];
  for (int j = threadIdx.x; j < 4 * n_coef; j += blockDim.x) prof[j] = prof_g[j];
  if (threadIdx.x < 8) scal[threadIdx.x] = scal_g[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

  const bool use_lut = variant & kLut, use_profile = variant & kProfile;
  const bool use_poly = variant & kPoly, circles = variant & kCircles;
  const bool presampled = variant & kPresampled;
  const bool static_flags = variant & kStatic;
  const float origin_shift = scal[0];
  const float dz0 = scal[1];
  const float naive_scale = scal[3];
  const float spacing = scal[4];
  const float sensor_half = scal[6];
  const float inv_dmax = scal[7];

  // film point: both axes scale by sensorWidth / 2
  const float fx = sx[i] * sensor_half;
  const float fy = sy[i] * sensor_half;

  // key bracket and lerp weight (true division, not a reciprocal
  // multiply: it decides the bracket)
  const float dist = sqrtf(fx * fx + fy * fy);
  int i_lb = (int)ceilf(dist / spacing);
  i_lb = i_lb < 0 ? 0 : (i_lb > n_keys - 1 ? n_keys - 1 : i_lb);
  const int i_prev = i_lb - 1 > 0 ? i_lb - 1 : 0;
  const float lower = (float)i_lb * spacing;
  const float prev = (float)i_prev * spacing;
  const float denom = prev - lower;
  float perc = (denom != 0.0f) ? (dist - lower) / denom : 0.0f;
  perc = (dist == 0.0f) ? 0.0f : perc;
  const float* lb = shap + 6 * i_lb;
  const float* pr = shap + 6 * i_prev;

  // LUT shaping folded into dx = lx*sa - ly*sb + kx, dy = lx*sb + ly*sa + ky
  float sa = 0.0f, sb = 0.0f, kx = 0.0f, ky = 0.0f;
  if (use_lut) {
    const float ms = lb[0] + perc * (pr[0] - lb[0]);
    const float trn = lb[1] + perc * (pr[1] - lb[1]);
    const float theta = atan2f(fy, fx);
    const float sn = fast_sin(theta);
    const float cs = fast_cos(theta);
    sa = ms * cs;
    sb = ms * sn;
    kx = trn * cs - fx;
    ky = trn * sn - fy;
  }

  // pre-check coefficients: lerped per key, or by Horner in
  // t = min(dist/dmax, 1) and switched off beyond the fitted domain
  float pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (use_profile && !use_poly) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pc[j] = lb[2 + j] + perc * (pr[2 + j] - lb[2 + j]);
  } else if (use_profile) {
    const float t_raw = dist * inv_dmax;
    const float t = (t_raw > 1.0f) ? 1.0f : t_raw;  // NaN propagates
    const int deg = n_coef - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = prof + j * n_coef;
      float acc = 0.0f + row[deg];
      for (int k = deg - 1; k >= 0; --k) acc = acc * t + row[k];
      pc[j] = acc;
    }
    if (t_raw > 1.0f) {
      if (circles) {
        pc[1] = F32(1e9);
        pc[3] = F32(1e9);
      } else {
        pc[0] = F32(1e9);
      }
    }
  }
  if (circles) {  // pre-doubled circle centres
    pc[0] = pc[0] * 2.0f;
    pc[2] = pc[2] * 2.0f;
  }

  int tries = 0, tir = 0;
  bool ok = false;
  Payload pay{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (use_profile && bound_dead(pc, circles)) tries = max_total;
  const int per_round = use_profile ? k_draws : 1;
  for (int rnd = 0; rnd <= max_total && !ok && tries < max_total; ++rnd) {
    const int n_draws = (use_profile && rnd == 0) ? per_round + 1 : per_round;
    bool found = false;
    float cx = 0.0f, cy = 0.0f;
    for (int j = 0; j < n_draws; ++j) {
      float lx, ly;
      if (rnd == 0 && j == 0) {  // the caller's draw: no try consumed
        if (presampled) {
          lx = u1[i];
          ly = u2[i];
        } else {
          concentric(u1[i], u2[i], lx, ly);
        }
      } else {
        if (tries >= max_total) break;
        if (presampled) {
          const int idx = !use_profile ? rnd - 1
                          : rnd == 0   ? j - 1
                                       : per_round * rnd + j;
          const int64_t c = plane_cell(i, idx, n_planes, bp, tile_rows,
                                       plane_tiles, reuse, 7);
          lx = bu1[c];
          ly = bu2[c];
        } else {
          concentric(hash_uniform((uint32_t)i, (uint32_t)seed,
                                  (uint32_t)tries, kSaltU1),
                     hash_uniform((uint32_t)i, (uint32_t)seed,
                                  (uint32_t)tries, kSaltU2),
                     lx, ly);
        }
        ++tries;
      }
      if (!use_profile || bound_pass(lx, ly, pc, circles)) {
        found = true;
        cx = lx;
        cy = ly;
        break;
      }
    }
    if (!found) continue;
    float dx, dy;
    if (use_lut) {
      dx = cx * sa - cy * sb + kx;
      dy = cx * sb + cy * sa + ky;
    } else {
      dx = cx * naive_scale - fx;
      dy = cy * naive_scale - fy;
    }
    bool tir_flag;
    trace(elems, flags, n_elems, iris_idx, static_flags, fx, fy,
          origin_shift, dx, dy, dz0, pay, ok, tir_flag);
    tir += tir_flag ? 1 : 0;
  }
  origin[3 * i + 0] = -pay.ox;
  origin[3 * i + 1] = -pay.oy;
  origin[3 * i + 2] = -pay.oz;
  dir[3 * i + 0] = -pay.dx;
  dir[3 * i + 1] = -pay.dy;
  dir[3 * i + 2] = -pay.dz;
  tries_out[i] = tries;
  tir_out[i] = tir;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
// bu1/bu2 ([n_planes, bp]) are read only in the presampled variant.
extern "C" int zoic_raytraced_launch(
    const float* sx, const float* sy, const float* u1, const float* u2,
    const float* bu1, const float* bu2, const float* elems, const int* flags,
    const float* shap, const float* prof, const float* scal, float* origin,
    float* dir, int* tries, int* tir, int B, int n_elems, int n_keys,
    int n_coef, int iris_idx, int max_total, int seed, int variant,
    int k_draws, int n_planes, int bp, int tile_rows, int plane_tiles,
    int reuse, void* stream) {
  if (B <= 0) return 0;
  if (n_elems > kMaxElems || n_keys > kMaxKeys || n_keys < 1 ||
      n_coef > kMaxCoef || n_coef < 1 || k_draws < 1)
    return (int)cudaErrorInvalidValue;
  if ((variant & kPresampled) &&
      (bu1 == nullptr || bu2 == nullptr || n_planes < 1 || bp < 1 ||
       tile_rows < 1 || (tile_rows & (tile_rows - 1)) != 0 ||
       plane_tiles < 1))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  raytraced_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      sx, sy, u1, u2, bu1, bu2, elems, flags, shap, prof, scal, origin, dir,
      tries, tir, B, n_elems, n_keys, n_coef, iris_idx, max_total, seed,
      variant, k_draws, n_planes, bp, tile_rows, plane_tiles, reuse != 0);
  return (int)cudaGetLastError();
}
