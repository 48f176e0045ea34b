// Raytraced camera-ray generation for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel zoic_tpu/ops/trace_kernel.py:_raytraced_kernel
// (wrapper raytraced_fused) for the main path's flags: exit-pupil LUT
// shaping, the pupil pre-check with the 2-circle bound from its polynomial
// fit, static per-element flags and the iris refract-identity skip.
//
// What it computes, per ray i (flat index in the batch):
//   film point -> LUT lerp + fastSin rotation folded into an affine
//   (sa, sb, kx, ky) -> pre-check circle coefficients -> if the bound
//   rejects the whole disk, tries = max_total; else draw 0 is the caller's
//   (u1, u2) and consumes no try, and retry c draws from the counter hash
//   keyed by (i, seed, c).  A draw outside the bound consumes a try
//   without a trace; a draw inside it is traced through the element stack.
//   Output: origin = -payload.o, dir = -payload.d, tries, tir.
// The reference's compacted retry machine (fold eras, bitonic unsort) is
// the TPU's answer to lanes in lockstep; here each thread walks its own
// draws in order, which gives the same per-ray result because every draw
// is keyed by the ray's own try count.
//
// What bounds it on this card: float compute, with 16 B read and 32 B
// written per ray.  The tables (elements E x 8, shaping keys x 6,
// polynomial 4 x (D+1), 8 scalars; under 2 KB on the headline lens) are
// loaded into shared memory once per block.  Its known cost is retry
// divergence inside a warp: a warp runs until its slowest ray resolves.
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

struct Payload {
  float ox, oy, oz, dx, dy, dz;
};

// Element-stack trace with a latched fail that freezes the ray at its last
// reached hit.  Element table row: [center_z, eta^2, 1/R, R^2, cull_r^2,
// eta, tir_thr, sign_r]; flags bit 0 = TIR possible, bit 1 = R < 0.
__device__ __forceinline__ void trace(const float* __restrict__ el,
                                      const int* __restrict__ flags,
                                      int n_elems, int iris_idx, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz, Payload& out, bool& ok,
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
    const float cull_r_sq = e[4], eta = e[5];
    const int fl = flags[i];
    float lz = cz - oz;
    float tca = lz * dz - (ox * dx + oy * dy);
    float px = ox + tca * dx;
    float py = oy + tca * dy;
    float pz = lz - tca * dz;
    float d2 = px * px + py * py + pz * pz;
    float thc = fast_sqrt(fabsf(r_sq - d2));
    float t = (fl & 2) ? tca - thc : tca + thc;
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
    if (fl & 1) {
      bool tir = (cs2 > 1.0f) && !fail;
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

__device__ __forceinline__ bool bound_pass(float lx, float ly, float a1d,
                                           float q1, float a2d, float q2) {
  float rr = lx * lx + ly * ly;
  return ((rr - a1d * lx) <= q1) && ((rr - a2d * lx) <= q2);
}

__device__ __forceinline__ float bound_min(float a) {
  float aa = fabsf(a);
  return (aa <= 2.0f) ? -0.25f * a * a : 1.0f - aa;
}

__global__ void __launch_bounds__(kBlock)
raytraced_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                 const float* __restrict__ u1, const float* __restrict__ u2,
                 const float* __restrict__ elems_g,
                 const int* __restrict__ flags_g,
                 const float* __restrict__ shap_g,
                 const float* __restrict__ prof_g,
                 const float* __restrict__ scal_g, float* __restrict__ origin,
                 float* __restrict__ dir, int* __restrict__ tries_out,
                 int* __restrict__ tir_out, int B, int n_elems, int n_keys,
                 int n_coef, int iris_idx, int max_total, int seed) {
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

  const float origin_shift = scal[0];
  const float dz0 = scal[1];
  const float spacing = scal[4];
  const float sensor_half = scal[6];
  const float inv_dmax = scal[7];

  // film point: both axes scale by sensorWidth / 2
  const float fx = sx[i] * sensor_half;
  const float fy = sy[i] * sensor_half;

  // LUT lerp between the bracketing keys (true division, not a
  // reciprocal multiply: it decides the bracket)
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
  const float ms = lb[0] + perc * (pr[0] - lb[0]);
  const float trn = lb[1] + perc * (pr[1] - lb[1]);
  const float theta = atan2f(fy, fx);
  const float sn = fast_sin(theta);
  const float cs = fast_cos(theta);
  // folded shaping affine: dx = lx*sa - ly*sb + kx, dy = lx*sb + ly*sa + ky
  const float sa = ms * cs, sb = ms * sn;
  const float kx = trn * cs - fx, ky = trn * sn - fy;

  // pre-check circles (a1, q1, a2, q2) by Horner in t = min(dist/dmax, 1);
  // beyond the fitted domain the bound is switched off (q -> 1e9)
  const float t_raw = dist * inv_dmax;
  const float t = (t_raw > 1.0f) ? 1.0f : t_raw;  // NaN propagates
  const int deg = n_coef - 1;
  float pc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* row = prof + j * n_coef;
    float acc = 0.0f + row[deg];
    for (int k = deg - 1; k >= 0; --k) acc = acc * t + row[k];
    pc[j] = acc;
  }
  const bool off = t_raw > 1.0f;
  const float q1 = off ? F32(1e9) : pc[1];
  const float q2 = off ? F32(1e9) : pc[3];
  const float a1d = pc[0] * 2.0f;
  const float a2d = pc[2] * 2.0f;

  int tries = 0, tir = 0;
  bool ok = false;
  Payload pay{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const bool dead = (bound_min(a1d) > q1) || (bound_min(a2d) > q2);
  if (dead) {
    tries = max_total;  // every draw would be rejected by the bound
  } else {
    float lx, ly;
    concentric(u1[i], u2[i], lx, ly);
    int c = 0;
    while (true) {
      if (bound_pass(lx, ly, a1d, q1, a2d, q2)) {
        float dx = lx * sa - ly * sb + kx;
        float dy = lx * sb + ly * sa + ky;
        bool tir_flag;
        trace(elems, flags, n_elems, iris_idx, fx, fy, origin_shift, dx, dy,
              dz0, pay, ok, tir_flag);
        tir += tir_flag ? 1 : 0;
      }
      if (ok || tries >= max_total) break;
      concentric(hash_uniform((uint32_t)i, (uint32_t)seed, (uint32_t)c,
                              kSaltU1),
                 hash_uniform((uint32_t)i, (uint32_t)seed, (uint32_t)c,
                              kSaltU2),
                 lx, ly);
      ++c;
      ++tries;
    }
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
extern "C" int zoic_raytraced_launch(
    const float* sx, const float* sy, const float* u1, const float* u2,
    const float* elems, const int* flags, const float* shap,
    const float* prof, const float* scal, float* origin, float* dir,
    int* tries, int* tir, int B, int n_elems, int n_keys, int n_coef,
    int iris_idx, int max_total, int seed, void* stream) {
  if (B <= 0) return 0;
  if (n_elems > kMaxElems || n_keys > kMaxKeys || n_coef > kMaxCoef ||
      n_coef < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  raytraced_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      sx, sy, u1, u2, elems, flags, shap, prof, scal, origin, dir, tries, tir,
      B, n_elems, n_keys, n_coef, iris_idx, max_total, seed);
  return (int)cudaGetLastError();
}
