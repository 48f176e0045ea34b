// Thin-lens camera-ray generation for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel zoic_tpu/ops/trace_kernel.py:_thinlens_kernel
// (wrapper thinlens_fused), the reference's THINLENS branch of
// camera_create_ray (src/zoic.cpp:1771-1848).
//
// What it computes, per ray i (flat index in the batch):
//   pinhole direction p = (sx, sy) * tan_fov, normalised with rsqrt; without
//   depth of field that is the ray (origin 0, dir.z negated, tries 0).  With
//   it: refocus to the focal plane (t = |focal / p.z|), then attempt 0 takes
//   the caller's draw (concentric map of (u1, u2), or with image bokeh the
//   presampled offset itself), scaled to the aperture; the ray aims from the
//   lens point through the focal-plane point.  With empirical vignetting a
//   ray whose virtual-aperture test fails redraws in rounds 1..max_total:
//   from the counter hash keyed by (i, seed, round), or with image bokeh from
//   the presampled retry planes at the cell the TPU kernel's tile layout
//   gives ray i in that round (plane_cell, common.cuh).  tries is the last
//   round the ray took.  Output: origin = (lx, ly, 0), dir = (dx, dy, -dz).
// The TPU kernel's straggler compaction (fold eras, bitonic unsort) is
// scheduling: each thread walks its own rounds, which gives the same per-ray
// result because every draw is keyed by the ray's id and round.
//
// What bounds it on this card: memory, 16 B read and 28 B written per ray
// with ~40 float operations per attempt; a warp with a vignetted ray runs
// until that ray's last round, so retry divergence is its known cost.  The
// five camera scalars are kernel arguments by value: a launch reads no
// table.  Built with ZOIC_COUNT_LANES the kernel also counts the lanes and
// warps that enter an attempt (lane use under vignetting retries).
//
// Rounding: built with --fmad=false and IEEE division, rsqrtf where the
// plain version uses torch.rsqrt, in the same order of operations as
// zoic_tpu_torch/ops/trace_kernel.py:thinlens_plain.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace zoic;

constexpr int kBlock = 256;

#ifdef ZOIC_COUNT_LANES
// Lane-use counters of the counting build: [0] lanes and [1] warps that
// entered an aperture attempt.
__device__ unsigned long long g_counts[2];
#define COUNT_LANES() count_lanes(g_counts)
#else
#define COUNT_LANES()
#endif

struct Attempt {
  float lx, ly, dx, dy, dz;
  bool ok;
};

// one aperture attempt from an offset in the unit disk or square
__device__ __forceinline__ Attempt attempt(float lx, float ly, float fx,
                                           float fy, float fz, float ap,
                                           float ovd, float thr, bool has_ov) {
  COUNT_LANES();
  Attempt a;
  a.lx = lx * ap;
  a.ly = ly * ap;
  const float ddx = fx - a.lx;
  const float ddy = fy - a.ly;
  const float inv2 = rsqrtf(ddx * ddx + ddy * ddy + fz * fz);
  a.dx = ddx * inv2;
  a.dy = ddy * inv2;
  a.dz = fz * inv2;
  a.ok = true;
  if (has_ov) {
    // empericalOpticalVignetting (zoic.cpp:1297-1305); its ABS is dropped
    const float vx = a.dx * ovd - a.lx;
    const float vy = a.dy * ovd - a.ly;
    a.ok = fast_sqrt(vx * vx + vy * vy) < thr;
  }
  return a;
}

__global__ void __launch_bounds__(kBlock)
thinlens_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ u1, const float* __restrict__ u2,
                const float* __restrict__ bu1, const float* __restrict__ bu2,
                float tan_fov, float ap, float focal, float ovd, float ovr,
                float* __restrict__ origin, float* __restrict__ dir,
                int* __restrict__ tries_out, int B, bool use_dof,
                bool has_ov, bool presampled, int max_total,
                int seed, int n_planes, int bp, int tile_rows,
                int plane_tiles, bool reuse) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float px = sx[i] * tan_fov;
  const float py = sy[i] * tan_fov;
  const float inv = rsqrtf(px * px + py * py + 1.0f);
  const float pdx = px * inv, pdy = py * inv, pdz = inv;
  if (!use_dof) {
    origin[3 * i + 0] = 0.0f;
    origin[3 * i + 1] = 0.0f;
    origin[3 * i + 2] = 0.0f;
    dir[3 * i + 0] = pdx;
    dir[3 * i + 1] = pdy;
    dir[3 * i + 2] = -pdz;
    tries_out[i] = 0;
    return;
  }

  // focal-plane point along the pinhole ray (zoic.cpp:1798-1800)
  const float t = fabsf(focal / pdz);
  const float fx = pdx * t, fy = pdy * t, fz = pdz * t;
  const float thr = ap * ovr;

  float lx, ly;
  if (presampled) {
    lx = u1[i];
    ly = u2[i];
  } else {
    concentric(u1[i], u2[i], lx, ly);
  }
  Attempt a = attempt(lx, ly, fx, fy, fz, ap, ovd, thr, has_ov);
  int tries = 0;
  if (has_ov) {
    for (int rnd = 1; rnd <= max_total && !a.ok; ++rnd) {
      if (presampled) {
        const int64_t k = plane_cell(i, rnd - 1, n_planes, bp, tile_rows,
                                     plane_tiles, reuse, 0);
        lx = bu1[k];
        ly = bu2[k];
      } else {
        concentric(hash_uniform((uint32_t)i, (uint32_t)seed, (uint32_t)rnd,
                                kSaltU1),
                   hash_uniform((uint32_t)i, (uint32_t)seed, (uint32_t)rnd,
                                kSaltU2),
                   lx, ly);
      }
      a = attempt(lx, ly, fx, fy, fz, ap, ovd, thr, true);
      tries = rnd;
    }
  }
  origin[3 * i + 0] = a.lx;
  origin[3 * i + 1] = a.ly;
  origin[3 * i + 2] = 0.0f;
  dir[3 * i + 0] = a.dx;
  dir[3 * i + 1] = a.dy;
  dir[3 * i + 2] = -a.dz;  // looking down -Z (zoic.cpp:1845)
  tries_out[i] = tries;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
// The camera scalars (tan_fov, aperture_radius, focal_distance, ov_distance,
// ov_radius) come by value.  bu1/bu2 ([n_planes, bp]) are read only when
// presampled and has_ov are both set.
extern "C" int zoic_thinlens_launch(
    const float* sx, const float* sy, const float* u1, const float* u2,
    const float* bu1, const float* bu2, float tan_fov, float aperture_radius,
    float focal_distance, float ov_distance, float ov_radius, float* origin,
    float* dir, int* tries, int B, int use_dof, int has_ov, int presampled,
    int max_total, int seed, int n_planes, int bp, int tile_rows,
    int plane_tiles, int reuse, void* stream) {
  if (B <= 0) return 0;
  if (presampled && has_ov &&
      (bu1 == nullptr || bu2 == nullptr || n_planes < 1 || bp < 1 ||
       tile_rows < 1 || (tile_rows & (tile_rows - 1)) != 0 ||
       plane_tiles < 1))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  thinlens_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      sx, sy, u1, u2, bu1, bu2, tan_fov, aperture_radius, focal_distance,
      ov_distance, ov_radius, origin, dir, tries, B, use_dof != 0,
      has_ov != 0, presampled != 0, max_total, seed, n_planes, bp, tile_rows,
      plane_tiles, reuse != 0);
  return (int)cudaGetLastError();
}

#ifdef ZOIC_COUNT_LANES
// The counting build's counters: zero them, or copy them to the host after
// the launches on every stream have finished.
extern "C" int zoic_thinlens_counts_reset() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
}

extern "C" int zoic_thinlens_counts_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_counts, 2 * sizeof(*out));
}
#endif
