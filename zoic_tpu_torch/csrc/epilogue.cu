// The camera models' epilogue for Hopper (sm_90a), a pass of its own:
// weight, exposure, fake derivatives and the four run counters.  Both
// camera kernels compute the same in their own stores (raytraced.cu's
// finished rays, zoic_raytraced_launch with a weight output; thinlens.cu,
// zoic_thinlens_rays_launch), so no frame path launches it.
//
// Replaces no TPU kernel: the JAX package's create_rays is one jitted
// program, and XLA fuses this epilogue into it after the Pallas call
// (zoic_tpu/models/common.py:105-136 weight_and_stats, apply_exposure,
// fake_derivatives; the counter sums of zoic_tpu/models/raytraced.py:252-257
// and zoic_tpu/models/thinlens.py:199-206).  Per ray i, with
// e = *exposure (a 0-d tensor on the card, read here, never on the host):
//   w        = tries[i] > max_tries ? 0 : 1
//   weight   = e > 0 ? w * (1 + e*e) : e < 0 ? w * (1 / (1 + e*e)) : w
//   d_ody[i] = tries[i] > 0 ? origin[i] : 0;  d_ddy[i] likewise from dir
//   stats    = {#(tries <= max_tries), #(tries > max_tries), sum(tir),
//               sum(tries)}
// A ray that leaves its retry loop with tries == max_tries + 1 is
// zero-weighted even when its last retry succeeded (the reference's quirk,
// zoic_tpu_torch/models/common.py).  Built with --fmad=false, 1 + e*e is a
// multiply and an add, and 1 / (1 + e*e) an IEEE division, as PyTorch
// rounds them in the plain version
// (zoic_tpu_torch/ops/epilogue_kernel.py:epilogue_plain), so the weights
// and derivatives are bit-equal to it; the counters are integer sums, exact
// in any order.
//
// What bounds it: bytes.  It reads tries, tir, origin and dir (4 + 4 + 12 +
// 12 B a ray) and writes the weight and both derivatives (4 + 12 + 12 B),
// and does a handful of operations a ray.  So every access is 16 bytes a
// lane on neighbouring addresses: a warp takes a tile of 128 rays, lane l
// the four rays 4l..4l+3 of tries and tir (one int4 each) and of the
// weight (one float4), and the tile's 384 floats of origin, of dir and of
// each derivative as 96 float4, lane l the ones at l, l + 32 and l + 64.
// A float's ray is rarely the lane's own, so the tile's "retried" bits
// (tries > 0) go to every lane by four ballots (a lane reading its own
// rays' 12 floats would put 48 B between neighbouring lanes, three times
// the cache sectors an instruction).  Tiles are spread
// over warps by a grid-stride loop over as many blocks as give each warp
// one tile; rays past the last whole tile, and every ray when a pointer
// is not 16-byte aligned, take the one-ray loop.  The counters are summed
// in registers, reduced within each warp (__reduce_add_sync), added into
// the block's shared copy, and added to the [4] buffer with one atomicAdd
// a non-zero counter a block.  The buffer is zeroed on the same stream
// first (cudaMemsetAsync): two device operations an epilogue.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace zoic;

constexpr int kBlock = 256;
constexpr int kTile = 128;  // rays a warp takes a step: four a lane

__global__ void __launch_bounds__(kBlock)
epilogue_kernel(const int* __restrict__ tries, const int* __restrict__ tir,
                const float* __restrict__ origin,
                const float* __restrict__ dir,
                const float* __restrict__ exposure,
                float* __restrict__ weight, float* __restrict__ d_ody,
                float* __restrict__ d_ddy, int* __restrict__ stats, int n,
                int max_tries, bool vec) {
  const Exposure x = exposure_factors(exposure);
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int tiles = vec ? n / kTile : 0;
  Counts c;
  // the warp's index is uniform across its lanes, so every lane of a warp
  // runs the same iterations and the ballots see all 32
  for (int tile = first >> 5; tile < tiles; tile += stride >> 5) {
    const int g = tile * 32 + lane;  // the lane's four rays, 4g..4g+3
    const int4 t4 = reinterpret_cast<const int4*>(tries)[g];
    const int4 r4 = reinterpret_cast<const int4*>(tir)[g];
    reinterpret_cast<float4*>(weight)[g] = make_float4(
        ray_weight(t4.x, r4.x, max_tries, true, x, c),
        ray_weight(t4.y, r4.y, max_tries, true, x, c),
        ray_weight(t4.z, r4.z, max_tries, true, x, c),
        ray_weight(t4.w, r4.w, max_tries, true, x, c));
    // bit l of retried[k]: ray 4l + k of the tile was retried
    const unsigned retried[4] = {
        __ballot_sync(all, t4.x > 0), __ballot_sync(all, t4.y > 0),
        __ballot_sync(all, t4.z > 0), __ballot_sync(all, t4.w > 0)};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int u = 32 * q + lane;  // float4 u of the tile's 96
      const int64_t v = (int64_t)tile * 96 + u;
      const float4 o = reinterpret_cast<const float4*>(origin)[v];
      const float4 d = reinterpret_cast<const float4*>(dir)[v];
      const float of[4] = {o.x, o.y, o.z, o.w};
      const float df[4] = {d.x, d.y, d.z, d.w};
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
      reinterpret_cast<float4*>(d_ody)[v] =
          make_float4(oo[0], oo[1], oo[2], oo[3]);
      reinterpret_cast<float4*>(d_ddy)[v] =
          make_float4(dd[0], dd[1], dd[2], dd[3]);
    }
  }
  for (int i = tiles * kTile + first; i < n; i += stride) {
    const int t = tries[i];
    weight[i] = ray_weight(t, tir[i], max_tries, true, x, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int64_t j = 3 * (int64_t)i + k;
      d_ody[j] = t > 0 ? origin[j] : 0.0f;
      d_ddy[j] = t > 0 ? dir[j] : 0.0f;
    }
  }

  add_counts(c, stats);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Zero stats ([4] int32) and run the epilogue over n rays on `stream`;
// returns the first CUDA error as an int (0 = success).  tries, tir,
// weight: [n]; origin, dir, d_ody, d_ddy: [n, 3]; exposure: one float; all
// device memory.
extern "C" int zoic_epilogue_launch(const int* tries, const int* tir,
                                    const float* origin, const float* dir,
                                    const float* exposure, float* weight,
                                    float* d_ody, float* d_ddy, int* stats,
                                    int n, int max_tries, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(stats, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const bool vec = aligned16(tries) && aligned16(tir) &&
                   aligned16(origin) && aligned16(dir) &&
                   aligned16(weight) && aligned16(d_ody) && aligned16(d_ddy);
  // a warp a whole tile, a thread one of the rays no whole tile holds (all
  // of them when a pointer is unaligned): at most 2^23 blocks
  const int tiles = vec ? n / kTile : 0;
  const int rest = n - tiles * kTile;
  const int for_tiles = (tiles + kBlock / 32 - 1) / (kBlock / 32);
  const int for_rest = rest / kBlock + (rest % kBlock != 0);
  const int grid = for_tiles > for_rest ? for_tiles : for_rest;
  epilogue_kernel<<<grid, kBlock, 0, s>>>(tries, tir, origin, dir, exposure,
                                          weight, d_ody, d_ddy, stats, n,
                                          max_tries, vec);
  return (int)cudaGetLastError();
}
