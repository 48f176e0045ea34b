// The pupil pre-check's circle fit for Hopper (sm_90a): the reach of the
// candidate centres over every accepted cover sample, and the pick of the
// centre pair that passes the fewest subsampled candidates.
//
// Replaces no TPU kernel: the JAX package fits the 2-circle cover on the
// host in numpy (zoic_tpu/pupil.py:_fit_circles_np, and the smoothing loop
// of build_precheck).  The port writes the fit once
// (zoic_tpu_torch/ops/circles_kernel.py:fit_circles): its small steps that
// define bits stay on the host in numpy, and its two large reductions run
// here for CUDA tensors, on the cover traces where the compile made them,
// and in numpy for CPU tensors (reach_plain, pick_plain, beside the
// entries' wrappers).
//
// Entry zoic_circles_reach_launch, per key k and centre c:
//   m2[k, c] = max over accepted n of fl64(fl64(d * d) + (double) fl32(py * py)),
//   d = fl64((double) px - centre), px = lx[k, n], py = ly[k, n],
// numpy's promotion of (px - cand) ** 2 + py ** 2 for float32 px, py and
// float64 centres: a float64 difference and square, a float32 square, a
// float64 sum.  Built with --fmad=false and written with __dsub_rn,
// __dmul_rn, __dadd_rn and __fmul_rn, each step rounds as numpy's does.
// The centres are one list [C] for every key (the 241 candidates, made on
// the host) or a list [K, C] of a key's own (the smoothed pair).  A max is
// exact in any order, so blocks fold their partial maxima into m2 with
// atomicMax on the bits of a non-negative double (as int64 they order as
// the doubles do) and the result is the same on every run.  m2 comes in
// filled with -1.0, whose bits are a negative int64: a key with no
// accepted sample keeps -1.
//
// Entry zoic_circles_pick_launch, per key k, over the subsample s = 0,
// stride, 2 * stride, ... of ALL the key's samples (accepted or not):
//   inside[s, c] = dist2(s, cand[c]) <= rk2[k, c]   (the same dist2)
//   joint[i, j]  = #s with inside[s, negi[i]] and inside[s, posi[j]]
//   out[k]       = min over (i, j) of joint[i, j] << 32 | i * n_pos + j
// numpy counts joint as a float32 product of 0/1 matrices, exact below
// 2^24, so the integer count is the same number; the minimum of the packed
// word is the least count at the least flat index, numpy's argmin with its
// first-index tie-break.  Two kernels: one writes the inside bits, a word
// of 32 subsampled samples per (key, word, centre), laid out [K, W, C] so
// that neighbouring lanes read neighbouring centres; the other ANDs and
// counts them per pair and folds each block's least word into out[k] with
// atomicMin, after out is set to all ones (cudaMemsetAsync).
//
// What bounds it: FP64 operations.  At the compile's shapes (32 keys, 50,000
// samples, 241 centres) the reach is 3 FP64 operations and a compare an
// (accepted sample, centre), up to 386 M of each, against 14 MB of inputs;
// the pick's bits 96 M more, its pairs 183 M 32-bit AND + popcount.  So a
// block stages a chunk of samples in shared memory as doubles (px and the
// float32 square of py, converted once), each thread takes one centre and
// runs over the chunk, and the accepted samples are packed first so that
// none is compared for nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReachBlock = 256;  // threads a reach block; also most centres
constexpr int kChunk = 1024;      // samples a reach block stages
constexpr int kBitsBlock = 256;
constexpr int kBitsWords = 32;    // words of 32 samples a bits block writes
constexpr int kPairBlock = 128;
constexpr int kPairRows = 8;      // negative centres a pair block holds

// (px - c) ** 2 + py2 as numpy rounds it, px and py2 already doubles
__device__ __forceinline__ double dist2(double px, double py2, double c) {
  const double d = __dsub_rn(px, c);
  return __dadd_rn(__dmul_rn(d, d), py2);
}

__device__ __forceinline__ double square32(float y) {
  return (double)__fmul_rn(y, y);
}

__global__ void __launch_bounds__(kReachBlock)
reach_kernel(const float* __restrict__ lx, const float* __restrict__ ly,
             const unsigned char* __restrict__ ok,
             const double* __restrict__ centres, long long* __restrict__ m2,
             int n, int n_centres, bool per_key) {
  __shared__ double s_px[kChunk];
  __shared__ double s_py2[kChunk];
  __shared__ long long s_best[kReachBlock];
  __shared__ int s_count;
  const int k = blockIdx.y;
  const int64_t row = (int64_t)k * n;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, n);
  if (threadIdx.x == 0) s_count = 0;
  if (threadIdx.x < n_centres) s_best[threadIdx.x] = __double_as_longlong(-1.0);
  __syncthreads();
  // the chunk's accepted samples, packed in any order: a max has none
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (ok[row + i]) {
      const int slot = atomicAdd(&s_count, 1);
      s_px[slot] = (double)lx[row + i];
      s_py2[slot] = square32(ly[row + i]);
    }
  }
  __syncthreads();
  const int m = s_count;
  if (m == 0) return;
  // item (c, g): centre c over the samples g, g + lanes, ...; lanes > 1 only
  // when the centres are fewer than half the block (a key's own pair)
  const int lanes = max(1, kReachBlock / n_centres);
  const double* cen = centres + (per_key ? (int64_t)k * n_centres : 0);
  for (int item = threadIdx.x; item < n_centres * lanes;
       item += blockDim.x) {
    const int c = item % n_centres;
    const double cc = cen[c];
    double best = -1.0;
    for (int s = item / n_centres; s < m; s += lanes) {
      const double v = dist2(s_px[s], s_py2[s], cc);
      best = v > best ? v : best;
    }
    if (best >= 0.0) atomicMax(&s_best[c], __double_as_longlong(best));
  }
  __syncthreads();
  if (threadIdx.x < n_centres && s_best[threadIdx.x] >= 0)
    atomicMax(&m2[(int64_t)k * n_centres + threadIdx.x],
              s_best[threadIdx.x]);
}

__global__ void __launch_bounds__(kBitsBlock)
bits_kernel(const float* __restrict__ lx, const float* __restrict__ ly,
            const double* __restrict__ rk2, const double* __restrict__ cand,
            unsigned* __restrict__ bits, int n, int n_centres, int stride,
            int n_sub, int words) {
  __shared__ double s_px[kBitsWords * 32];
  __shared__ double s_py2[kBitsWords * 32];
  const int k = blockIdx.y;
  const int w0 = blockIdx.x * kBitsWords;
  const int64_t row = (int64_t)k * n;
  for (int j = threadIdx.x; j < kBitsWords * 32; j += blockDim.x) {
    const int sub = w0 * 32 + j;
    if (sub < n_sub) {
      const int64_t i = row + (int64_t)sub * stride;
      s_px[j] = (double)lx[i];
      s_py2[j] = square32(ly[i]);
    }
  }
  __syncthreads();
  const int n_words = min(kBitsWords, words - w0);
  const double* lim = rk2 + (int64_t)k * n_centres;
  for (int item = threadIdx.x; item < n_words * n_centres;
       item += blockDim.x) {
    const int c = item % n_centres;
    const int wl = item / n_centres;
    const double cc = cand[c];
    const double r2 = lim[c];
    const int first = (w0 + wl) * 32;
    const int valid = min(32, n_sub - first);
    unsigned word = 0u;
    for (int b = 0; b < valid; ++b) {
      const int j = wl * 32 + b;
      word |= (unsigned)(dist2(s_px[j], s_py2[j], cc) <= r2) << b;
    }
    bits[((int64_t)k * words + w0 + wl) * n_centres + c] = word;
  }
}

__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kPairBlock)
pair_kernel(const unsigned* __restrict__ bits, const int* __restrict__ negi,
            const int* __restrict__ posi, unsigned long long* __restrict__ out,
            int n_centres, int words, int n_neg, int n_pos) {
  extern __shared__ unsigned s_rows[];  // [kPairRows][words]
  __shared__ unsigned long long s_min[kPairBlock / 32];
  const int k = blockIdx.y;
  const int i0 = blockIdx.x * kPairRows;
  const int rows = min(kPairRows, n_neg - i0);
  const unsigned* kb = bits + (int64_t)k * words * n_centres;
  for (int e = threadIdx.x; e < kPairRows * words; e += blockDim.x) {
    const int r = e / words;
    const int w = e - r * words;
    s_rows[e] = r < rows ? kb[(int64_t)w * n_centres + negi[i0 + r]] : 0u;
  }
  __syncthreads();
  unsigned long long best = ~0ull;
  for (int j = threadIdx.x; j < n_pos; j += blockDim.x) {
    const unsigned* col = kb + posi[j];
    int cnt[kPairRows];
#pragma unroll
    for (int r = 0; r < kPairRows; ++r) cnt[r] = 0;
    for (int w = 0; w < words; ++w) {
      const unsigned pj = col[(int64_t)w * n_centres];
#pragma unroll
      for (int r = 0; r < kPairRows; ++r)
        cnt[r] += __popc(s_rows[r * words + w] & pj);
    }
#pragma unroll
    for (int r = 0; r < kPairRows; ++r)
      if (r < rows)
        best = min64(best, (unsigned long long)cnt[r] << 32 |
                               (unsigned)((i0 + r) * n_pos + j));
  }
  for (int off = 16; off > 0; off >>= 1)
    best = min64(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPairBlock / 32; ++w) best = min64(best, s_min[w]);
    atomicMin(&out[k], best);
  }
}

}  // namespace

// m2 [n_keys, n_centres] float64, filled with -1.0 by the caller, gets the
// reach of every centre over each key's accepted samples (above).  lx, ly
// [n_keys, n] float32, ok [n_keys, n] bool (one byte), centres [n_centres]
// or, with per_key, [n_keys, n_centres] float64; all device memory.  At
// most 256 centres.  Returns the first CUDA error as an int (0 = success).
extern "C" int zoic_circles_reach_launch(const float* lx, const float* ly,
                                         const unsigned char* ok,
                                         const double* centres, double* m2,
                                         int n_keys, int n, int n_centres,
                                         int per_key, void* stream) {
  if (n_keys < 0 || n < 0 || n_centres < 1 || n_centres > kReachBlock)
    return (int)cudaErrorInvalidValue;
  if (n_keys == 0 || n == 0) return 0;
  const dim3 grid((n + kChunk - 1) / kChunk, n_keys);
  reach_kernel<<<grid, kReachBlock, 0, (cudaStream_t)stream>>>(
      lx, ly, ok, centres, reinterpret_cast<long long*>(m2), n, n_centres,
      per_key != 0);
  return (int)cudaGetLastError();
}

// out [n_keys] (uint64) gets, per key, the least joint count of a centre
// pair (negi[i], posi[j]) over the subsample of stride `stride`, shifted
// left by 32, or'ed with its flat index i * n_pos + j (above).  lx, ly
// [n_keys, n] float32; rk2 [n_keys, n_centres] and cand [n_centres]
// float64; negi [n_neg], posi [n_pos] int32 centre indices; bits scratch of
// n_keys * ceil(ceil(n / stride) / 32) * n_centres words.  Returns the
// first CUDA error as an int.
extern "C" int zoic_circles_pick_launch(
    const float* lx, const float* ly, const double* rk2, const double* cand,
    const int* negi, const int* posi, unsigned* bits, unsigned long long* out,
    int n_keys, int n, int n_centres, int stride, int n_neg, int n_pos,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_keys < 0 || n < 1 || n_centres < 1 || stride < 1 || n_neg < 1 ||
      n_pos < 1)
    return (int)cudaErrorInvalidValue;
  if (n_keys == 0) return 0;
  const int n_sub = (n + stride - 1) / stride;
  const int words = (n_sub + 31) / 32;
  const size_t smem = sizeof(unsigned) * kPairRows * words;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0xff, sizeof(*out) * n_keys, s);
  if (err != cudaSuccess) return (int)err;
  bits_kernel<<<dim3((words + kBitsWords - 1) / kBitsWords, n_keys),
                kBitsBlock, 0, s>>>(lx, ly, rk2, cand, bits, n, n_centres,
                                    stride, n_sub, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_kernel<<<dim3((n_neg + kPairRows - 1) / kPairRows, n_keys),
                kPairBlock, smem, s>>>(bits, negi, posi, out, n_centres,
                                       words, n_neg, n_pos);
  return (int)cudaGetLastError();
}
