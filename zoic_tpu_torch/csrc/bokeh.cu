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
// cell), so bytes.  The searches are log2(h) + log2(w) + 2 dependent table
// loads a draw; from global memory the 32 lanes of a warp probe 32 rows of
// the column table, up to 32 cache lines a load.  So:
// * the tables live in dynamic shared memory, loaded once by each block of
//   a persistent grid (blocks per SM from the occupancy query), so their
//   reads from L2 scale with the resident blocks, not with the draws;
// * the row stride is w + 1 words: at the first steps of a search every
//   lane probes the same column, and with a stride of w = 64 all 32 rows
//   would fall in one bank;
// * a thread takes four draws a step, read and written as float4 where the
//   pointers allow, and runs their searches interleaved, each a fixed
//   ceil(log2 n) steps with no branch, so the probes of the four overlap
//   and no lane waits on another;
// * tables that do not fit in a block's shared memory (the host's choice by
//   size, ops/bokeh_kernel.py:uses_smem) are searched in global memory by a
//   second instance of the same kernel.  No size is refused.
//
// Packed tables (floats; the host builds them once per image):
//   [0, h) cdf_row | [h, 2h) dy_srow | [2h, 2h + h*ws) cdf_col_s |
//   [2h + h*ws, 2h + 2h*ws) dx_col_s | zeros to a multiple of 4;  ws = w + 1

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 512;
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

// kShared: tables copied into shared memory, else read in global memory.
// kHash: u1, u2 drawn from the plane cell's index, else read.  vec: every
// pointer the instance reads or writes per draw is 16-byte aligned.
template <bool kShared, bool kHash>
__global__ void __launch_bounds__(kBlock)
bokeh_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
             const float* __restrict__ tab, float* __restrict__ dx,
             float* __restrict__ dy, int n, int h, int w, int n_tab, bool vec,
             uint32_t pseed, uint32_t salt1, uint32_t salt2) {
  extern __shared__ float4 smem[];
  const float* t = tab;
  if (kShared) {
    const float4* src = reinterpret_cast<const float4*>(tab);
    for (int j = threadIdx.x; j < (n_tab >> 2); j += kBlock)
      smem[j] = __ldg(src + j);
    __syncthreads();
    t = reinterpret_cast<const float*>(smem);
  }
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
    if (kHash) {
#pragma unroll
      for (int k = 0; k < kDraws; ++k) {
        a[k] = zoic::hash_uniform((uint32_t)(i0 + k), pseed, 0u, salt1);
        b[k] = zoic::hash_uniform((uint32_t)(i0 + k), pseed, 0u, salt2);
      }
    } else if (full) {
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
    int r[kDraws], c[kDraws], off[kDraws] = {0, 0, 0, 0};
    upper_bound4(cdf_row, off, h, a, r);
#pragma unroll
    for (int k = 0; k < kDraws; ++k) {
      r[k] = r[k] < h - 1 ? r[k] : h - 1;  // past-the-end clamp (zoic.cpp:435)
      off[k] = r[k] * ws;
    }
    upper_bound4(cdf_col, off, w, b, c);
    float ox[kDraws], oy[kDraws];
#pragma unroll
    for (int k = 0; k < kDraws; ++k) {
      c[k] = c[k] < w - 1 ? c[k] : w - 1;  // global-index clamp (zoic.cpp:461)
      ox[k] = dx_col[off[k] + c[k]];
      oy[k] = dy_srow[r[k]];
    }
    if (full) {
      *reinterpret_cast<float4*>(dx + i0) = make_float4(ox[0], ox[1], ox[2],
                                                        ox[3]);
      *reinterpret_cast<float4*>(dy + i0) = make_float4(oy[0], oy[1], oy[2],
                                                        oy[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kDraws; ++k) {
        if (i0 + k < n) {
          dx[i0 + k] = ox[k];
          dy[i0 + k] = oy[k];
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        float*, int, int, int, int, bool, uint32_t, uint32_t,
                        uint32_t);

Kernel instance(bool shared, bool hash) {
  if (shared) return hash ? bokeh_kernel<true, true> : bokeh_kernel<true, false>;
  return hash ? bokeh_kernel<false, true> : bokeh_kernel<false, false>;
}

// The instance, with its shared-memory limit raised when the tables need
// more than the default; 0 or a CUDA error code.
int prepare(Kernel fn, int smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute((const void*)fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int launch(bool shared, bool hash, const float* u1, const float* u2,
           const float* tab, float* dx, float* dy, int n, int h, int w,
           int n_tab, uint32_t pseed, uint32_t salt1, uint32_t salt2,
           int grid, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (h < 1 || w < 1 || grid < 1 || (n_tab & 3) != 0 ||
      (int64_t)n_tab < 2 * (int64_t)h * (w + 2) || !aligned16(tab))
    return (int)cudaErrorInvalidValue;
  const Kernel fn = instance(shared, hash);
  const int smem = shared ? n_tab * (int)sizeof(float) : 0;
  const int err = prepare(fn, smem);
  if (err != 0) return err;
  const bool vec = aligned16(dx) && aligned16(dy) &&
                   (hash || (aligned16(u1) && aligned16(u2)));
  fn<<<grid, kBlock, smem, stream>>>(u1, u2, tab, dx, dy, n, h, w, n_tab,
                                     vec, pseed, salt1, salt2);
  return (int)cudaGetLastError();
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

// Blocks of kBlock threads of an instance that one SM holds at a time with
// `smem` bytes of tables (0 for the global instance), or -1 on a failed
// query.  The wrapper sizes the persistent grid with it.
extern "C" int zoic_bokeh_blocks_per_sm(int shared, int hash, int smem) {
  const Kernel fn = instance(shared != 0, hash != 0);
  int n = 0;
  if (prepare(fn, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock,
                                                    (size_t)smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// Launch `grid` blocks on `stream` over n draws; returns cudaGetLastError()
// as an int (0 = success).  tab: the packed tables ([n_tab] floats, device
// memory, 16-byte aligned); shared: copy them into shared memory.
extern "C" int zoic_bokeh_launch(const float* u1, const float* u2,
                                 const float* tab, float* dx, float* dy,
                                 int n, int h, int w, int n_tab, int shared,
                                 int grid, void* stream) {
  return launch(shared != 0, false, u1, u2, tab, dx, dy, n, h, w, n_tab, 0u,
                0u, 0u, grid, (cudaStream_t)stream);
}

// The retry planes: for cell k in [0, n_cells) the draw of
// (hash_uniform(k, pseed, 0, salt1), hash_uniform(k, pseed, 0, salt2)),
// written to dx[k], dy[k].
extern "C" int zoic_bokeh_planes_launch(const float* tab, float* dx,
                                        float* dy, int n_cells,
                                        uint32_t pseed, uint32_t salt1,
                                        uint32_t salt2, int h, int w,
                                        int n_tab, int shared, int grid,
                                        void* stream) {
  return launch(shared != 0, true, nullptr, nullptr, tab, dx, dy, n_cells, h,
                w, n_tab, pseed, salt1, salt2, grid, (cudaStream_t)stream);
}
