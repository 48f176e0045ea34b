// Thin-lens camera-ray generation for Hopper (sm_90a): the thin lens's whole
// kernel path, finished rays, their weights and the run counters in one
// launch (entry zoic_thinlens_rays_launch).
//
// Replaces the TPU kernel zoic_tpu/ops/trace_kernel.py:_thinlens_kernel
// (its wrapper here: ops/trace_kernel.py:thinlens_rays), the reference's
// THINLENS branch of camera_create_ray (src/zoic.cpp:1771-1848), and the
// jnp epilogue XLA fuses after it.
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
//   round the ray took.  The ray: origin = (lx, ly, 0), dir = (dx, dy, -dz).
//   Then what epilogue.cu computes from it (common.cuh: the weight, 0 iff
//   use_dof and tries > max_tries, then the exposure read on the card; dOdy,
//   dDdy the origin and dir of a retried ray, else 0; the four counters,
//   tir 0), so that no pass reads the rays back.
// The TPU kernel's straggler compaction (fold eras, bitonic unsort) is
// scheduling: each thread walks its own rounds, which gives the same per-ray
// result because every draw is keyed by the ray's id and round.
//
// Rounding: built with --fmad=false and IEEE division, rsqrtf where the
// plain version uses torch.rsqrt, in the same order of operations as
// zoic_tpu_torch/ops/trace_kernel.py:thinlens_plain; every output is
// bit-equal to thinlens_plain followed by epilogue_plain
// (ops/trace_kernel.py:thinlens_rays_plain).
//
// What bounds it on this card: memory, 16 B read a ray and 52 written
// (origin, dir, weight, dOdy, dDdy), with ~40 float operations per attempt;
// a warp with a vignetted ray runs until that ray's last round, so retry
// divergence is its known cost.  The five camera scalars are kernel
// arguments by value: a launch reads no table.  So every access is 16 B a
// lane on neighbouring addresses, as in epilogue.cu: a warp takes a tile of
// 128 rays, lane l the four rays 4l..4l+3 of each input (one float4 each)
// and of the weight, and the tile's 384 floats of origin, of dir and of
// each derivative as 96 float4, lane l the ones at l, l + 32 and l + 64.  A
// float's ray is rarely the lane's own, so origin and dir go through the
// warp's 3 KB of shared memory, and the "retried" bits (tries > 0) to every
// lane by four ballots; the derivatives are masked as they are stored.
// Tiles are spread over the warps of a grid that the card holds at once
// (blocks per SM from the occupancy query, at least kRaysBlocksPerSm) by a
// grid-stride loop, so the counters, reduced in each warp and block
// (add_counts), reach the [4] buffer by one atomicAdd a non-zero counter a
// block: about four hundred blocks, where a block a 256 rays would make
// 290,000 same-address atomics an HD frame at AA 3.  Inputs off the
// 16-byte alignment are read a float at a time; rays past the last whole
// tile, and every ray when an output is off it, take a one-ray loop.  The
// buffer is zeroed on the same stream first (cudaMemsetAsync).  Built with
// ZOIC_COUNT_LANES the kernel also counts the lanes and warps that enter an
// attempt (lane use under vignetting retries).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace zoic;

constexpr int kBlock = 256;
// rays a warp takes a step (four a lane), and blocks an SM must hold: at
// most 85 registers a thread, which it fits unspilled (at 4 blocks, 64
// registers, it spills and is 9% slower)
constexpr int kTile = 128;
constexpr int kRaysBlocksPerSm = 3;

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

// The camera's inputs and scalars as a launch gives them.  bu1/bu2
// ([n_planes, bp]) are read only when presampled and has_ov are both set.
struct Params {
  const float *sx, *sy, *u1, *u2, *bu1, *bu2;
  float tan_fov, ap, focal, ovd, ovr;
  int B, max_total, seed, n_planes, bp, tile_rows, plane_tiles;
  bool use_dof, has_ov, presampled, reuse;
};

// Where the kernel writes: the finished rays and the counters.
struct Out {
  float *origin, *dir;
  float *weight, *d_ody, *d_ddy;
  int* stats;
  const float* exposure;
  bool vec;     // outputs 16-byte aligned: whole tiles take float4 stores
  bool vec_in;  // sx, sy, u1, u2 16-byte aligned: and float4 loads
};

// A ray: origin (lx, ly, 0), dir (dx, dy, -dz) (looking down -Z,
// zoic.cpp:1845), and the last round it took.
struct Ray {
  float lx, ly, dx, dy, dz;
  int tries;
};

// ray i from its screen point (sx, sy) and its lens draw (u1, u2)
__device__ __forceinline__ Ray camera_ray(int i, float sx, float sy, float u1,
                                          float u2, const Params& p) {
  const float px = sx * p.tan_fov;
  const float py = sy * p.tan_fov;
  const float inv = rsqrtf(px * px + py * py + 1.0f);
  const float pdx = px * inv, pdy = py * inv, pdz = inv;
  if (!p.use_dof) return {0.0f, 0.0f, pdx, pdy, pdz, 0};

  // focal-plane point along the pinhole ray (zoic.cpp:1798-1800)
  const float t = fabsf(p.focal / pdz);
  const float fx = pdx * t, fy = pdy * t, fz = pdz * t;
  const float thr = p.ap * p.ovr;

  float lx, ly;
  if (p.presampled) {
    lx = u1;
    ly = u2;
  } else {
    concentric(u1, u2, lx, ly);
  }
  Attempt a = attempt(lx, ly, fx, fy, fz, p.ap, p.ovd, thr, p.has_ov);
  int tries = 0;
  if (p.has_ov) {
    for (int rnd = 1; rnd <= p.max_total && !a.ok; ++rnd) {
      if (p.presampled) {
        const int64_t k = plane_cell(i, rnd - 1, p.n_planes, p.bp,
                                     p.tile_rows, p.plane_tiles, p.reuse, 0);
        lx = __ldg(p.bu1 + k);
        ly = __ldg(p.bu2 + k);
      } else {
        concentric(hash_uniform((uint32_t)i, (uint32_t)p.seed, (uint32_t)rnd,
                                kSaltU1),
                   hash_uniform((uint32_t)i, (uint32_t)p.seed, (uint32_t)rnd,
                                kSaltU2),
                   lx, ly);
      }
      a = attempt(lx, ly, fx, fy, fz, p.ap, p.ovd, thr, true);
      tries = rnd;
    }
  }
  return {a.lx, a.ly, a.dx, a.dy, a.dz, tries};
}

// ray i read in place (the lens draw only with depth of field)
__device__ __forceinline__ Ray camera_ray(int i, const Params& p) {
  return camera_ray(i, __ldg(p.sx + i), __ldg(p.sy + i),
                    p.use_dof ? __ldg(p.u1 + i) : 0.0f,
                    p.use_dof ? __ldg(p.u2 + i) : 0.0f, p);
}

// the four floats from x + 4g on: one float4 load when aligned
__device__ __forceinline__ float4 four(const float* x, int g, bool vec_in) {
  if (vec_in) return __ldg(reinterpret_cast<const float4*>(x) + g);
  return {__ldg(x + 4 * g), __ldg(x + 4 * g + 1), __ldg(x + 4 * g + 2),
          __ldg(x + 4 * g + 3)};
}

// the thin lens's whole kernel path, writing the finished rays, their
// weights and the counters (the file's header)
__global__ void __launch_bounds__(kBlock, kRaysBlocksPerSm)
thinlens_kernel(const Params p, const Out o) {
  const Exposure x = exposure_factors(o.exposure);
  const int max_tries = p.max_total - 1;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int tiles = o.vec ? p.B / kTile : 0;
  // a warp's tile as it is stored: origin's 96 float4, then dir's
  __shared__ float4 staged[kBlock / 32][2 * 96];
  float4* mine = staged[threadIdx.x >> 5];
  Counts c;
  // the warp's index is uniform across its lanes, so every lane of a warp
  // runs the same tiles and the ballots see all 32
  for (int tile = first >> 5; tile < tiles; tile += stride >> 5) {
    const int g = tile * 32 + lane;  // the lane's rays 4g..4g+3
    const float4 a = four(p.sx, g, o.vec_in);
    const float4 b = four(p.sy, g, o.vec_in);
    const float4 e = p.use_dof ? four(p.u1, g, o.vec_in) : float4{};
    const float4 f = p.use_dof ? four(p.u2, g, o.vec_in) : float4{};
    const float sx[4] = {a.x, a.y, a.z, a.w}, sy[4] = {b.x, b.y, b.z, b.w};
    const float u1[4] = {e.x, e.y, e.z, e.w}, u2[4] = {f.x, f.y, f.z, f.w};
    float lx[4], ly[4], dx[4], dy[4], nz[4], w[4];
    int t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Ray r = camera_ray(4 * g + k, sx[k], sy[k], u1[k], u2[k], p);
      lx[k] = r.lx;
      ly[k] = r.ly;
      dx[k] = r.dx;
      dy[k] = r.dy;
      nz[k] = -r.dz;
      t[k] = r.tries;
      w[k] = ray_weight(r.tries, 0, max_tries, p.use_dof, x, c);
    }
    reinterpret_cast<float4*>(o.weight)[g] =
        make_float4(w[0], w[1], w[2], w[3]);
    // bit l of retried[k]: ray 4l + k of the tile was retried
    const unsigned all = 0xffffffffu;
    const unsigned retried[4] = {
        __ballot_sync(all, t[0] > 0), __ballot_sync(all, t[1] > 0),
        __ballot_sync(all, t[2] > 0), __ballot_sync(all, t[3] > 0)};
    // the lane's 12 floats of origin and of dir, floats 12l..12l+11 of
    // the tile's 384
    __syncwarp();  // the last tile's float4s have been read
    mine[3 * lane + 0] = make_float4(lx[0], ly[0], 0.0f, lx[1]);
    mine[3 * lane + 1] = make_float4(ly[1], 0.0f, lx[2], ly[2]);
    mine[3 * lane + 2] = make_float4(0.0f, lx[3], ly[3], 0.0f);
    mine[96 + 3 * lane + 0] = make_float4(dx[0], dy[0], nz[0], dx[1]);
    mine[96 + 3 * lane + 1] = make_float4(dy[1], nz[1], dx[2], dy[2]);
    mine[96 + 3 * lane + 2] = make_float4(nz[2], dx[3], dy[3], nz[3]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int u = 32 * q + lane;  // float4 u of the tile's 96
      const int64_t v = (int64_t)tile * 96 + u;
      const float4 of4 = mine[u];
      const float4 df4 = mine[96 + u];
      const float of[4] = {of4.x, of4.y, of4.z, of4.w};
      const float df[4] = {df4.x, df4.y, df4.z, df4.w};
      float oo[4], dd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = (4 * u + k) / 3;  // the float's ray in the tile
        const unsigned bits = (r & 3) == 0   ? retried[0]
                              : (r & 3) == 1 ? retried[1]
                              : (r & 3) == 2 ? retried[2]
                                             : retried[3];
        const bool on = (bits >> (r >> 2)) & 1u;
        oo[k] = on ? of[k] : 0.0f;
        dd[k] = on ? df[k] : 0.0f;
      }
      reinterpret_cast<float4*>(o.origin)[v] = of4;
      reinterpret_cast<float4*>(o.dir)[v] = df4;
      reinterpret_cast<float4*>(o.d_ody)[v] =
          make_float4(oo[0], oo[1], oo[2], oo[3]);
      reinterpret_cast<float4*>(o.d_ddy)[v] =
          make_float4(dd[0], dd[1], dd[2], dd[3]);
    }
  }
  for (int i = tiles * kTile + first; i < p.B; i += stride) {
    const Ray r = camera_ray(i, p);
    o.weight[i] = ray_weight(r.tries, 0, max_tries, p.use_dof, x, c);
    const bool on = r.tries > 0;
    const float of[3] = {r.lx, r.ly, 0.0f};
    const float df[3] = {r.dx, r.dy, -r.dz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int64_t j = 3 * (int64_t)i + k;
      o.origin[j] = of[k];
      o.dir[j] = df[k];
      o.d_ody[j] = on ? of[k] : 0.0f;
      o.d_ddy[j] = on ? df[k] : 0.0f;
    }
  }
  add_counts(c, o.stats);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool planes_ok(const float* bu1, const float* bu2, int has_ov,
               int presampled, int n_planes, int bp, int tile_rows,
               int plane_tiles) {
  return !(presampled && has_ov) ||
         (bu1 != nullptr && bu2 != nullptr && n_planes >= 1 && bp >= 1 &&
          tile_rows >= 1 && (tile_rows & (tile_rows - 1)) == 0 &&
          plane_tiles >= 1);
}

}  // namespace

// Blocks of the kernel that one SM holds at a time, or -1 on a failed
// query; the wrapper sizes its grid with it.
extern "C" int zoic_thinlens_rays_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, thinlens_kernel, kBlock, 0) != cudaSuccess)
    return -1;
  return n;
}

// The thin lens's whole kernel path: zero stats ([4] int32) and launch
// `grid` blocks on `stream` that write origin, dir, d_ody, d_ddy ([B, 3]),
// weight ([B]) and the four counters; returns the first CUDA error as an
// int (0 = success).  The camera scalars (tan_fov, aperture_radius,
// focal_distance, ov_distance, ov_radius) come by value; bu1/bu2
// ([n_planes, bp]) are read only when presampled and has_ov are both set;
// max_total = max_tries + 1; exposure is one float in device memory, read
// on the card.
extern "C" int zoic_thinlens_rays_launch(
    const float* sx, const float* sy, const float* u1, const float* u2,
    const float* bu1, const float* bu2, float tan_fov, float aperture_radius,
    float focal_distance, float ov_distance, float ov_radius,
    const float* exposure, float* origin, float* dir, float* weight,
    float* d_ody, float* d_ddy, int* stats, int B, int use_dof, int has_ov,
    int presampled, int max_total, int seed, int n_planes, int bp,
    int tile_rows, int plane_tiles, int reuse, int grid, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 0 || grid < 1 ||
      !planes_ok(bu1, bu2, has_ov, presampled, n_planes, bp, tile_rows,
                 plane_tiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(stats, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess || B == 0) return (int)err;
  const Params p{sx, sy, u1, u2, bu1, bu2, tan_fov, aperture_radius,
                 focal_distance, ov_distance, ov_radius, B, max_total, seed,
                 n_planes, bp, tile_rows, plane_tiles, use_dof != 0,
                 has_ov != 0, presampled != 0, reuse != 0};
  Out o{};
  o.origin = origin;
  o.dir = dir;
  o.weight = weight;
  o.d_ody = d_ody;
  o.d_ddy = d_ddy;
  o.stats = stats;
  o.exposure = exposure;
  o.vec = aligned16(origin) && aligned16(dir) && aligned16(weight) &&
          aligned16(d_ody) && aligned16(d_ddy);
  o.vec_in = aligned16(sx) && aligned16(sy) &&
             (!use_dof || (aligned16(u1) && aligned16(u2)));
  thinlens_kernel<<<grid, kBlock, 0, s>>>(p, o);
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
