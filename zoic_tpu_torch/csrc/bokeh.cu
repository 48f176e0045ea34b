// Image-bokeh CDF inversion for Hopper (sm_90a), and the retry planes of
// raytraced + image bokeh drawn by the same search.
//
// Replaces the TPU kernel zoic_tpu/ops/bokeh_kernel.py:_bokeh_kernel
// (wrapper sample_fused), the reference's bokehSample
// (src/zoic.cpp:420-485), and the plane draws of
// zoic_tpu/models/raytraced.py:_create_rays_pallas (a counter hash per plane
// cell feeding the sampler).  Per draw i, over tables whose per-row entries
// the host put in sorted-row order (cdf_col_s[r] = cdf_col[row_indices[r]],
// dx_col_s likewise; ops/bokeh_kernel.py:packed_tables):
//   r     = min(upper_bound(cdf_row[0:h], u1[i]), h - 1)
//   c     = min(upper_bound(cdf_col_s[r, 0:w], u2[i]), w - 1)
//   dx[i] = dx_col_s[r, c];  dy[i] = dy_srow[r]
// upper_bound is the first index whose value exceeds u, which for the
// ascending CDFs equals the count of values <= u (the TPU kernel's count
// form, and torch.searchsorted(..., right=True) in the plain version).
//
// Two entries: zoic_bokeh_launch reads u1, u2; zoic_bokeh_planes_launch
// draws them for plane cell k as hash_uniform(k, pseed, 0, salt1) and
// hash_uniform(k, pseed, 0, salt2) (common.cuh), so the retry planes are
// one launch that reads nothing but the tables.
//
// No float arithmetic touches the offsets: they are selected from tables
// the host built with true f32 division (x / const compiled as a reciprocal
// multiply would be 1 ulp off), so the output is bit-equal to the plain
// PyTorch versions (zoic_tpu_torch/ops/bokeh_kernel.py:sample_plain,
// planes_plain).
//
// What bounds it: 8 B read and 8 B written a draw (the planes: 8 B written a
// cell), so bytes.  The sampler's searches are log2(h) + log2(w) + 2
// dependent table loads a draw; from global memory the 32 lanes of a warp
// probe 32 rows of the column table, up to 32 cache lines a load.  So:
// * the tables live in dynamic shared memory, loaded once by each block of
//   a persistent grid (blocks per SM from the occupancy query), so their
//   reads from L2 scale with the resident blocks, not with the draws;
// * the row stride is w + 1 words: at the first steps of a search every
//   lane probes the same column, and with a stride of w = 64 all 32 rows
//   would fall in one bank;
// * a thread takes four draws a step, read and written as float4 where the
//   pointers allow, and runs their searches interleaved, each a fixed
//   ceil(log2 n) steps (the plane entry's: the host's s, below) with no
//   branch, so the probes of the four overlap and no lane waits on another;
// * tables that do not fit in a block's shared memory (the host's choice by
//   size, ops/bokeh_kernel.py:uses_smem) are searched in global memory by a
//   second instance of the same kernel, which reads the plane entry's
//   tables and searches through their guides (below): on the 512 x 512
//   disk a draw is then 7 dependent loads (a guide and two steps for the
//   row, a guide and one step for the column, dx and dy) where two full
//   searches are 22.  One set of tables serves both entries.  No size is
//   refused.
//
// The plane entry and the sampler's global instance cut their searches
// short with guide tables.  For K =
// 2^log2k <= 2^24 equal slices of [0, 1), the slice k = u * K of a uniform
// u < 1 is exact (a power-of-two scaling).  Guide word k of a CDF holds lo
// and hi, the answers at u = k / K and at (k + 1) / K; the answer is
// monotone in u, so for every u of slice k it lies in [lo, hi], and it is
// lo plus the count of entries of [lo, hi) that are <= u.  The host packs a
// word as lo << s | (hi - lo), s the bit length of the widest bracket of
// that table, and passes s: it is also the search's fixed number of steps
// (by 2^(s-1), ..., 1), the same for every lane.  The guides hold
// min(upper_bound, n - 1), so the past-the-end clamps (zoic.cpp:435, 461)
// are folded into them.  A flat CDF tail (rows and pixels of zero
// luminance sort last) would make one bracket as wide as the tail, since
// upper_bound jumps across it from its first index e to n: the host copies
// what index n - 1 selects (a row's tables and dy; a column's dx) to index
// e + 1 of the plane entry's own copy of the tables and ends that CDF
// there.  K is 8x the next power of two of h and at least 4,096 for the row
// guide, the next power of two of w for the column guides.  On the 64x64
// disk a search is then one step a table, and a cell takes 6 shared loads
// (two guides, two probes, dx and dy) where the sampler's draw takes 16.
// Its loads are at random addresses, so bank conflicts, not latency, set
// its pace: the plane entry runs blocks of 1,024 threads, one an SM when
// its tables are in shared memory, since every block copies them in
// (tools/bokeh_bound.py times it at one and at two blocks an SM).
//
// The guides hold the answer only for draws in [0, 1), where every hashed
// uniform lies; the sampler takes any float.  Its global instance reads
// slice 0 for a draw outside [0, 1) (NaN too), and after the bracketed
// search of that CDF a lane holding such a draw runs the full search and
// its clamp over the same tables, off the in-range draws' chain of loads.
// The collapsed tails leave what every index a full search returns selects
// as it was (tests/test_torch_bokeh_planes.py), so the sampler's bits are
// those of the packed tables' full search on every input.
//
// Packed tables (floats; the host builds them once per image):
//   [0, h) cdf_row | [h, 2h) dy_srow | [2h, 2h + h*ws) cdf_col_s |
//   [2h + h*ws, 2h + 2h*ws) dx_col_s | zeros to t, a multiple of 4;
//   ws = w + 1.  The plane entry's (ops/bokeh_kernel.py:plane_tables)
//   continue with guide words: [t, t + kr) the row guide |
//   [t + kr, t + kr + h*kc) the column guides, kc words a sorted row;
//   kr = 2^log2_kr, kc = 2^log2_kc, both at least 4

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kPlaneBlock = 1024;  // the plane entry's threads a block
constexpr int kDraws = 4;  // draws a thread takes per step of its loop
// dynamic shared memory a block gets without opting in
constexpr int kDefaultSmem = 48 * 1024;

// For each k: the first index j in [0, n) with a[off[k] + j] > u[k], or n.
// A fixed ceil(log2 n) halvings, then one probe: base + len stays within the
// searched range, and the answer within [base, base + len].
__device__ __forceinline__ void upper_bound4(const float* a,
                                             const int (&off)[kDraws], int n,
                                             const float (&u)[kDraws],
                                             int (&pos)[kDraws]) {
  int base[kDraws];
#pragma unroll
  for (int k = 0; k < kDraws; ++k) base[k] = off[k];
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < kDraws; ++k)
      base[k] += a[base[k] + half] <= u[k] ? half : 0;
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < kDraws; ++k)
    pos[k] = base[k] - off[k] + (a[base[k]] <= u[k] ? 1 : 0);
}

// For each k, with the bracket [pos[k], hi[k]] of guide word g[k] (offset by
// off[k]): pos[k] becomes its start plus the count of a[start, hi) that are
// <= u[k].  `steps` steps by 2^(steps-1), ..., 1; every bracket is below
// 2^steps wide (the host's choice), so they land on the count.  A probe
// past hi is not made; no branch.
__device__ __forceinline__ void bracket_search4(const float* a,
                                                const uint32_t (&g)[kDraws],
                                                const int (&off)[kDraws],
                                                int steps,
                                                const float (&u)[kDraws],
                                                int (&pos)[kDraws]) {
  const uint32_t width = (1u << steps) - 1u;
  int hi[kDraws];
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    pos[k] = off[k] + (int)(g[k] >> steps);
    hi[k] = pos[k] + (int)(g[k] & width);
  }
  for (int s = steps - 1; s >= 0; --s) {
#pragma unroll
    for (int k = 0; k < kDraws; ++k) {
      const int p = pos[k] + (1 << s);
      pos[k] = p <= hi[k] && a[p - 1] <= u[k] ? p : pos[k];
    }
  }
}

// The tables a block of kThreads searches: copied into its shared memory
// (kShared), else `tab` itself in global memory.
template <bool kShared, int kThreads>
__device__ __forceinline__ const float* stage(const float* tab, int n_tab,
                                              float4* smem) {
  if (!kShared) return tab;
  const float4* src = reinterpret_cast<const float4*>(tab);
  for (int j = threadIdx.x; j < (n_tab >> 2); j += kThreads)
    smem[j] = __ldg(src + j);
  __syncthreads();
  return reinterpret_cast<const float*>(smem);
}

// Writes the four draws from i0 on that lie below n: as float4 when `full`.
__device__ __forceinline__ void store4(float* dx, float* dy, int i0, int n,
                                       bool full, const float (&ox)[kDraws],
                                       const float (&oy)[kDraws]) {
  if (full) {
    *reinterpret_cast<float4*>(dx + i0) = make_float4(ox[0], ox[1], ox[2],
                                                      ox[3]);
    *reinterpret_cast<float4*>(dy + i0) = make_float4(oy[0], oy[1], oy[2],
                                                      oy[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    if (i0 + k < n) {
      dx[i0 + k] = ox[k];
      dy[i0 + k] = oy[k];
    }
  }
}

// The guide tables after the plane entry's packed tables (layout above) and
// the host's arguments for them.
struct Guides {
  const float* row;  // the row guide, kr words
  const float* col;  // the column guides, kc words a sorted row
  float kr, kc;      // 2^log2_kr, 2^log2_kc
  int log2_kc, steps_r, steps_c;
};

__device__ __forceinline__ Guides guides_of(const float* t, int h, int w,
                                            int log2_kr, int log2_kc,
                                            int steps_r, int steps_c) {
  const float* row = t + ((2 * h * (w + 2) + 3) & ~3);  // word bits
  return {row, row + (1 << log2_kr), (float)(1 << log2_kr),
          (float)(1 << log2_kc), log2_kc, steps_r, steps_c};
}

// Four draws (a[k], b[k]) through the guides g of the plane entry's tables
// t: slice a * kr of the row guide and a bracketed search of the row CDF,
// then slice b * kc of sorted row r's column guide and a bracketed search
// of its CDF.  kAnyDraw: a draw outside [0, 1), where the guides do not
// hold, reads slice 0, then takes the full search and its clamp (header);
// else every draw is in [0, 1).
template <bool kAnyDraw>
__device__ __forceinline__ void guided_draws4(const float* t, int h, int w,
                                              const Guides& g,
                                              const float (&a)[kDraws],
                                              const float (&b)[kDraws],
                                              float (&ox)[kDraws],
                                              float (&oy)[kDraws]) {
  const int ws = w + 1;
  const float* cdf_row = t;
  const float* dy_srow = t + h;
  const float* cdf_col = t + 2 * h;
  const float* dx_col = cdf_col + h * ws;
  bool in_a[kDraws], in_b[kDraws];
  bool all_a = true, all_b = true;
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    in_a[k] = !kAnyDraw || (0.0f <= a[k] && a[k] < 1.0f);
    in_b[k] = !kAnyDraw || (0.0f <= b[k] && b[k] < 1.0f);
    all_a = all_a && in_a[k];
    all_b = all_b && in_b[k];
  }
  uint32_t word[kDraws];
  int r[kDraws], c[kDraws], off[kDraws];
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    // u * K is exact and below K
    word[k] = __float_as_uint(g.row[(int)((in_a[k] ? a[k] : 0.0f) * g.kr)]);
    off[k] = 0;
  }
  bracket_search4(cdf_row, word, off, g.steps_r, a, r);
  if (kAnyDraw && !all_a) {
    int full[kDraws];
    upper_bound4(cdf_row, off, h, a, full);
#pragma unroll
    for (int k = 0; k < kDraws; ++k)
      if (!in_a[k]) r[k] = full[k] < h - 1 ? full[k] : h - 1;
  }
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    const int j = (r[k] << g.log2_kc) + (int)((in_b[k] ? b[k] : 0.0f) * g.kc);
    word[k] = __float_as_uint(g.col[j]);
    off[k] = r[k] * ws;
  }
  bracket_search4(cdf_col, word, off, g.steps_c, b, c);
  if (kAnyDraw && !all_b) {
    int full[kDraws];
    upper_bound4(cdf_col, off, w, b, full);
#pragma unroll
    for (int k = 0; k < kDraws; ++k)
      if (!in_b[k]) c[k] = off[k] + (full[k] < w - 1 ? full[k] : w - 1);
  }
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    ox[k] = dx_col[c[k]];
    oy[k] = dy_srow[r[k]];
  }
}

// The sampler.  kShared: the packed tables, copied into shared memory and
// searched in full; else the plane entry's tables with their guides, read
// in global memory (guided_draws4, any draw; log2_kr to steps_c are their
// arguments, which the shared instance ignores).  vec: every pointer it
// reads or writes per draw is 16-byte aligned.
template <bool kShared>
__global__ void __launch_bounds__(kBlock)
bokeh_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
             const float* __restrict__ tab, float* __restrict__ dx,
             float* __restrict__ dy, int n, int h, int w, int n_tab,
             bool vec, int log2_kr, int log2_kc, int steps_r, int steps_c) {
  extern __shared__ float4 smem[];
  const float* t = stage<kShared, kBlock>(tab, n_tab, smem);
  const int ws = w + 1;
  const float* cdf_row = t;
  const float* dy_srow = t + h;
  const float* cdf_col = t + 2 * h;
  const float* dx_col = cdf_col + h * ws;
  const int steps = (n >> 2) + ((n & 3) != 0);
  for (int q = blockIdx.x * kBlock + threadIdx.x; q < steps;
       q += gridDim.x * kBlock) {
    const int i0 = q * kDraws;
    const bool full = vec && n - i0 >= kDraws;
    float a[kDraws], b[kDraws];
    if (full) {
      const float4 x = *reinterpret_cast<const float4*>(u1 + i0);
      const float4 y = *reinterpret_cast<const float4*>(u2 + i0);
      a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
      b[0] = y.x, b[1] = y.y, b[2] = y.z, b[3] = y.w;
    } else {
#pragma unroll
      for (int k = 0; k < kDraws; ++k) {
        a[k] = i0 + k < n ? u1[i0 + k] : 0.0f;
        b[k] = i0 + k < n ? u2[i0 + k] : 0.0f;
      }
    }
    float ox[kDraws], oy[kDraws];
    if constexpr (kShared) {
      int r[kDraws], c[kDraws], off[kDraws] = {0, 0, 0, 0};
      upper_bound4(cdf_row, off, h, a, r);
#pragma unroll
      for (int k = 0; k < kDraws; ++k) {
        // past-the-end clamp (zoic.cpp:435)
        r[k] = r[k] < h - 1 ? r[k] : h - 1;
        off[k] = r[k] * ws;
      }
      upper_bound4(cdf_col, off, w, b, c);
#pragma unroll
      for (int k = 0; k < kDraws; ++k) {
        // global-index clamp (zoic.cpp:461)
        c[k] = c[k] < w - 1 ? c[k] : w - 1;
        ox[k] = dx_col[off[k] + c[k]];
        oy[k] = dy_srow[r[k]];
      }
    } else {
      guided_draws4<true>(
          t, h, w, guides_of(t, h, w, log2_kr, log2_kc, steps_r, steps_c), a,
          b, ox, oy);
    }
    store4(dx, dy, i0, n, full, ox, oy);
  }
}

// The retry planes over the plane entry's tables (guides after the packed
// tables, layout above): cell i's uniforms hashed from i, then a bracketed
// search of each CDF with steps_r and steps_c steps.  vec: dx and dy are
// 16-byte aligned.
template <bool kShared>
__global__ void __launch_bounds__(kPlaneBlock)
bokeh_planes_kernel(const float* __restrict__ tab, float* __restrict__ dx,
                    float* __restrict__ dy, int n, int h, int w, int n_tab,
                    int log2_kr, int log2_kc, int steps_r, int steps_c,
                    bool vec, uint32_t pseed, uint32_t salt1,
                    uint32_t salt2) {
  extern __shared__ float4 smem[];
  const float* t = stage<kShared, kPlaneBlock>(tab, n_tab, smem);
  const Guides g = guides_of(t, h, w, log2_kr, log2_kc, steps_r, steps_c);
  const int steps = (n >> 2) + ((n & 3) != 0);
  for (int q = blockIdx.x * kPlaneBlock + threadIdx.x; q < steps;
       q += gridDim.x * kPlaneBlock) {
    const int i0 = q * kDraws;
    float a[kDraws], b[kDraws];
#pragma unroll
    for (int k = 0; k < kDraws; ++k) {
      a[k] = zoic::hash_uniform((uint32_t)(i0 + k), pseed, 0u, salt1);
      b[k] = zoic::hash_uniform((uint32_t)(i0 + k), pseed, 0u, salt2);
    }
    float ox[kDraws], oy[kDraws];
    guided_draws4<false>(t, h, w, g, a, b, ox, oy);  // hashes are in [0, 1)
    store4(dx, dy, i0, n, vec && n - i0 >= kDraws, ox, oy);
  }
}

const void* instance(bool shared, bool planes) {
  if (planes)
    return shared ? (const void*)bokeh_planes_kernel<true>
                  : (const void*)bokeh_planes_kernel<false>;
  return shared ? (const void*)bokeh_kernel<true>
                : (const void*)bokeh_kernel<false>;
}

// The instance, with its shared-memory limit raised when the tables need
// more than the default; 0 or a CUDA error code.
int prepare(const void* fn, int smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The tables' checks common to both entries: sizes, 16-byte alignment, at
// least the floats of their layout; with `guides`, the guides' arguments in
// range (u * K exact, no bracket of 2^31 entries) and their words after the
// packed tables.
bool tables_ok(int h, int w, int n_tab, bool guides, int log2_kr,
               int log2_kc, int steps_r, int steps_c, int grid,
               const float* tab) {
  if (h < 1 || w < 1 || grid < 1 || (n_tab & 3) != 0 || !aligned16(tab))
    return false;
  int64_t need = 2 * (int64_t)h * (w + 2);
  if (guides) {
    if (log2_kr < 0 || log2_kr > 24 || log2_kc < 0 || log2_kc > 24 ||
        steps_r < 0 || steps_r > 31 || steps_c < 0 || steps_c > 31)
      return false;
    need = (need + 3) / 4 * 4 + ((int64_t)1 << log2_kr) +
           ((int64_t)h << log2_kc);
  }
  return (int64_t)n_tab >= need;
}

}  // namespace

// The current device's opt-in limit of dynamic shared memory a block, in
// bytes, or -1: the host takes the shared-memory instance for tables up to
// it.
extern "C" int zoic_bokeh_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// Blocks of an instance (the plane entry's, of kPlaneBlock threads, when
// `hash`; else kBlock) that one SM holds at a time with `smem` bytes of
// tables (0 for the global instance), or -1 on a failed query.  The wrapper
// sizes the persistent grid with it.
extern "C" int zoic_bokeh_blocks_per_sm(int shared, int hash, int smem) {
  const void* fn = instance(shared != 0, hash != 0);
  int n = 0;
  if (prepare(fn, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn, hash != 0 ? kPlaneBlock : kBlock, (size_t)smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// Launch `grid` blocks on `stream` over n draws; returns cudaGetLastError()
// as an int (0 = success).  tab: [n_tab] floats of device memory, 16-byte
// aligned.  shared: the packed tables, copied into shared memory (the guide
// arguments unread); else the plane entry's tables with their guides
// (as zoic_bokeh_planes_launch takes them), searched in global memory.
extern "C" int zoic_bokeh_launch(const float* u1, const float* u2,
                                 const float* tab, float* dx, float* dy,
                                 int n, int h, int w, int n_tab, int log2_kr,
                                 int log2_kc, int steps_r, int steps_c,
                                 int shared, int grid, void* stream) {
  if (n <= 0) return 0;
  if (!tables_ok(h, w, n_tab, shared == 0, log2_kr, log2_kc, steps_r,
                 steps_c, grid, tab))
    return (int)cudaErrorInvalidValue;
  const void* fn = instance(shared != 0, false);
  const int smem = shared ? n_tab * (int)sizeof(float) : 0;
  const int err = prepare(fn, smem);
  if (err != 0) return err;
  const bool vec = aligned16(dx) && aligned16(dy) && aligned16(u1) &&
                   aligned16(u2);
  (shared ? bokeh_kernel<true> : bokeh_kernel<false>)
      <<<grid, kBlock, smem, (cudaStream_t)stream>>>(
          u1, u2, tab, dx, dy, n, h, w, n_tab, vec, log2_kr, log2_kc, steps_r,
          steps_c);
  return (int)cudaGetLastError();
}

// The retry planes: for cell k in [0, n_cells) the draw of
// (hash_uniform(k, pseed, 0, salt1), hash_uniform(k, pseed, 0, salt2)),
// written to dx[k], dy[k].  tab: the plane entry's tables with their guides
// (2^log2_kr words for the row CDF, 2^log2_kc a sorted row's CDF, brackets
// below 2^steps_r and 2^steps_c wide).
extern "C" int zoic_bokeh_planes_launch(const float* tab, float* dx,
                                        float* dy, int n_cells,
                                        uint32_t pseed, uint32_t salt1,
                                        uint32_t salt2, int h, int w,
                                        int n_tab, int log2_kr, int log2_kc,
                                        int steps_r, int steps_c, int shared,
                                        int grid, void* stream) {
  if (n_cells <= 0) return 0;
  if (!tables_ok(h, w, n_tab, true, log2_kr, log2_kc, steps_r, steps_c, grid,
                 tab))
    return (int)cudaErrorInvalidValue;
  const void* fn = instance(shared != 0, true);
  const int smem = shared ? n_tab * (int)sizeof(float) : 0;
  const int err = prepare(fn, smem);
  if (err != 0) return err;
  const bool vec = aligned16(dx) && aligned16(dy);
  (shared ? bokeh_planes_kernel<true> : bokeh_planes_kernel<false>)
      <<<grid, kPlaneBlock, smem, (cudaStream_t)stream>>>(
          tab, dx, dy, n_cells, h, w, n_tab, log2_kr, log2_kc, steps_r,
          steps_c, vec, pseed, salt1, salt2);
  return (int)cudaGetLastError();
}
