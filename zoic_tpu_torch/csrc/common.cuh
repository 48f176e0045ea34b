// Per-ray device functions shared by the port's camera kernels
// (raytraced.cu, thinlens.cu), and the epilogue's weight, exposure and run
// counters (epilogue.cu, and thinlens.cu's instance that writes finished
// rays).
//
// Each mirrors, operation for operation, its PyTorch counterpart in
// zoic_tpu_torch/ops/trace_kernel.py (_sin_poly, fast_sin, fast_cos,
// concentric, hash_uniform, _fast_sqrt, _plane_index), which mirror the
// JAX package's
// zoic_tpu/ops/trace_kernel.py.  The kernels are built with --fmad=false, so
// keep the order of operations identical when editing either side: the
// kernels are held bit-equal to their plain PyTorch versions on the card.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zoic {

// Constants rounded from double to float, as the Python reference rounds them.
constexpr double kPiD = 3.14159265358979323;
#define F32(x) ((float)(x))

__device__ __forceinline__ float max_nan(float x, float lo) {
  // torch.clamp_min / jnp.maximum: NaN propagates
  return (x != x || x > lo) ? x : lo;
}

__device__ __forceinline__ float fast_sqrt(float x) {
  return x * rsqrtf(max_nan(x, F32(1e-35)));
}

__device__ __forceinline__ float sin_poly(float x) {
  const float b = F32(4.0 / kPiD);
  const float c = F32(-4.0 / (kPiD * kPiD));
  const float p = F32(0.225);
  float y = b * x + c * x * fabsf(x);
  return p * (y * fabsf(y) - y) + y;
}

__device__ __forceinline__ float fast_sin(float x) {
  x = x - floorf((x + F32(kPiD)) / F32(2.0 * kPiD)) * F32(2.0 * kPiD);
  return sin_poly(x);
}

__device__ __forceinline__ float fast_cos(float x) {
  return fast_sin(x + F32(kPiD * 0.5));
}

__device__ __forceinline__ void concentric(float u1, float u2, float& lx,
                                           float& ly) {
  float a = 2.0f * u1 - 1.0f;
  float b = 2.0f * u2 - 1.0f;
  bool use_a = (a * a) > (b * b);
  float r = use_a ? a : b;
  float num = use_a ? b : a;
  float den = use_a ? a : b;
  den = (den == 0.0f) ? 1.0f : den;
  float q = F32(0.78539816339) * (num / den);
  float phi = use_a ? q : F32(kPiD * 0.5) - q;
  float xc = phi + F32(kPiD * 0.5);
  xc = (xc > F32(kPiD)) ? xc - F32(2.0 * kPiD) : xc;
  lx = r * sin_poly(xc);
  ly = r * sin_poly(phi);
}

// Retry-draw salts of the two uniforms (_hash_uniform's stream salts).
constexpr uint32_t kSaltU1 = 0x11111111u;
constexpr uint32_t kSaltU2 = 0x22222222u;

__device__ __forceinline__ float hash_uniform(uint32_t id, uint32_t seed,
                                              uint32_t ctr, uint32_t salt) {
  uint32_t h = id * 2654435761u + seed + ctr * 0x9E3779B9u + salt;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (float)(int32_t)(h >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

#ifdef ZOIC_COUNT_LANES
// Lane-use counting (the kernels' counting builds): the first active lane of
// the converged group adds the group's lanes to c[0] and one to c[1]
// (count_lanes), or one to c[0] alone (count_warps).
__device__ __forceinline__ void count_lanes(unsigned long long* c) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    atomicAdd(&c[0], (unsigned long long)__popc(m));
    atomicAdd(&c[1], 1ull);
  }
}

__device__ __forceinline__ void count_warps(unsigned long long* c) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(c, 1ull);
}
#endif

constexpr int kLanes = 128;

// Flat index into [P, bp] retry planes of presampled draw idx for ray i:
// the TPU kernel lays ray i at row R = i / 128, lane l = i % 128 of tile
// t = R / tile_rows (row r in it); tile t reads plane block t % plane_tiles,
// of plane idx % P, rolled down by `shift` rows and right by `lsh` lanes
// for reuse cycle idx / P and, when tiles share blocks (reuse), reuse index
// t / plane_tiles; lane_step lanes more per eight cycles (7 raytraced, 0
// thin lens).  tile_rows is a power of two, so the masks are the moduli.
// Planes shorter than their tiles wrap.  Mirrors trace_kernel._plane_index.
__device__ __forceinline__ int64_t plane_cell(int i, int idx, int n_planes,
                                              int bp, int tile_rows,
                                              int plane_tiles, bool reuse,
                                              int lane_step) {
  const int rr = i / kLanes, l = i % kLanes;
  const int t = rr / tile_rows, r = rr % tile_rows;
  const int pidx = idx % n_planes, cyc = idx / n_planes;
  const int t_reuse = reuse ? t / plane_tiles : 0;
  const int shift = (3 * cyc + 5 * t_reuse) & (tile_rows - 1);
  const int lsh = (lane_step * (cyc / 8) + 21 * t_reuse) & (kLanes - 1);
  const int64_t row = (int64_t)(t % plane_tiles) * tile_rows +
                      ((r - shift) & (tile_rows - 1));
  const int64_t pos = (row * kLanes + ((l - lsh) & (kLanes - 1))) % bp;
  return (int64_t)pidx * bp + pos;
}

// The epilogue (zoic_tpu_torch/ops/epilogue_kernel.py:epilogue_plain): the
// exposure factors of e = *exposure, read on the card; 1 + e*e is a
// multiply and an add and 1 / (1 + e*e) an IEEE division under
// --fmad=false, as PyTorch rounds them.
struct Exposure {
  float e, up, down;
};

__device__ __forceinline__ Exposure exposure_factors(const float* exposure) {
  const float e = *exposure;
  const float one_plus = 1.0f + e * e;
  return {e, one_plus, 1.0f / one_plus};
}

__device__ __forceinline__ float exposed(float w, const Exposure& x) {
  return x.e > 0.0f ? w * x.up : (x.e < 0.0f ? w * x.down : w);
}

// The four run counters: successes, vignetted rays, the TIR sum and the
// tries sum.
struct Counts {
  int ok = 0, vig = 0, tir = 0, tries = 0;
};

// One ray's weight from its tries t and TIR count r, its counters added to
// c: 0 iff count_weight && t > max_tries, else 1, then the exposure.
__device__ __forceinline__ float ray_weight(int t, int r, int max_tries,
                                            bool count_weight,
                                            const Exposure& x, Counts& c) {
  const bool vig = count_weight && t > max_tries;
  c.ok += count_weight && t <= max_tries;
  c.vig += vig;
  c.tir += r;
  c.tries += t;
  return exposed(vig ? 0.0f : 1.0f, x);
}

// Add every thread's counters to stats[4]: reduced within each warp
// (__reduce_add_sync), added into the block's shared copy, and added to
// stats with one atomicAdd a non-zero counter a block.  Every thread of
// the block calls it, all 32 lanes of each warp.
__device__ __forceinline__ void add_counts(const Counts& c, int* stats) {
  const unsigned all = 0xffffffffu;
  __shared__ int block_counts[4];
  if (threadIdx.x < 4) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const int ok = __reduce_add_sync(all, c.ok);
  const int vig = __reduce_add_sync(all, c.vig);
  const int tir_sum = __reduce_add_sync(all, c.tir);
  const int tries_sum = __reduce_add_sync(all, c.tries);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_counts[0], ok);
    atomicAdd(&block_counts[1], vig);
    atomicAdd(&block_counts[2], tir_sum);
    atomicAdd(&block_counts[3], tries_sum);
  }
  __syncthreads();
  if (threadIdx.x < 4 && block_counts[threadIdx.x] != 0)
    atomicAdd(&stats[threadIdx.x], block_counts[threadIdx.x]);
}

// Add every thread's a and b to totals[0] and totals[1] (64-bit), reduced
// as add_counts reduces the counters.  Every thread of the block calls it.
__device__ __forceinline__ void add_totals(int a, int b,
                                           unsigned long long* totals) {
  const unsigned all = 0xffffffffu;
  __shared__ unsigned long long block_totals[2];
  if (threadIdx.x < 2) block_totals[threadIdx.x] = 0ull;
  __syncthreads();
  const unsigned wa = __reduce_add_sync(all, (unsigned)a);
  const unsigned wb = __reduce_add_sync(all, (unsigned)b);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_totals[0], (unsigned long long)wa);
    atomicAdd(&block_totals[1], (unsigned long long)wb);
  }
  __syncthreads();
  if (threadIdx.x < 2 && block_totals[threadIdx.x] != 0ull)
    atomicAdd(&totals[threadIdx.x], block_totals[threadIdx.x]);
}

}  // namespace zoic
