// Image-bokeh CDF inversion for Hopper (sm_90a): one thread per draw.
//
// Replaces the TPU kernel zoic_tpu/ops/bokeh_kernel.py:_bokeh_kernel
// (wrapper sample_fused), the reference's bokehSample
// (src/zoic.cpp:420-485).  Per draw i:
//   r   = min(upper_bound(cdf_row[0:h], u1[i]), h - 1)
//   src = row_indices[r]
//   c   = min(upper_bound(cdf_col[src, 0:w], u2[i]), w - 1)
//   dx[i] = dx_col[src, c];  dy[i] = dy_srow[r]
// upper_bound is the first index whose value exceeds u, which for the
// ascending CDFs equals the count of values <= u (the TPU kernel's count
// form, and torch.searchsorted(..., right=True) in the plain version).
//
// No float arithmetic touches the offsets: they are selected from tables
// the host built with true f32 division (x / const compiled as a reciprocal
// multiply would be 1 ulp off), so the output is bit-equal to the plain
// PyTorch version (zoic_tpu_torch/ops/bokeh_kernel.py:sample_plain).
//
// The TPU kernel selects rows by one-hot matrix products because a gather
// is slow there; here a binary search over log2(h) + log2(w) dependent
// loads is the whole cost.  Tables stay in global memory, read through L1
// (a 64x64 image is 33 KB of tables, resident in L1/L2 after the first
// warps); 8 B are read and 8 B written per draw, so at large batches the
// kernel is bound by the latency of the dependent table loads.  Any h, w
// that the host build makes is covered: there is no size gate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// first index j in [0, n) with a[j] > u, or n
__device__ __forceinline__ int upper_bound(const float* __restrict__ a, int n,
                                           float u) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(a + lo + half) <= u) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock)
bokeh_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
             const float* __restrict__ cdf_row,
             const int* __restrict__ row_indices,
             const float* __restrict__ cdf_col,
             const float* __restrict__ dx_col,
             const float* __restrict__ dy_srow, float* __restrict__ dx,
             float* __restrict__ dy, int B, int h, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int r = upper_bound(cdf_row, h, u1[i]);
  r = r < h - 1 ? r : h - 1;  // past-the-end clamp (zoic.cpp:435)
  const int src = __ldg(row_indices + r);
  const float* row = cdf_col + (int64_t)src * w;
  int c = upper_bound(row, w, u2[i]);
  c = c < w - 1 ? c : w - 1;  // global-index clamp (zoic.cpp:461)
  dx[i] = __ldg(dx_col + (int64_t)src * w + c);
  dy[i] = __ldg(dy_srow + r);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
extern "C" int zoic_bokeh_launch(const float* u1, const float* u2,
                                 const float* cdf_row, const int* row_indices,
                                 const float* cdf_col, const float* dx_col,
                                 const float* dy_srow, float* dx, float* dy,
                                 int B, int h, int w, void* stream) {
  if (B <= 0) return 0;
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  bokeh_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      u1, u2, cdf_row, row_indices, cdf_col, dx_col, dy_srow, dx, dy, B, h,
      w);
  return (int)cudaGetLastError();
}
