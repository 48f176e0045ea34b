// Raytraced camera-ray generation for Hopper (sm_90a): persistent warps that
// draw for 32 rays or trace 32 rays at a time, whichever rays are ready.
//
// Replaces the TPU kernel zoic_tpu/ops/trace_kernel.py:_raytraced_kernel
// (wrapper raytraced_fused) in every variant zoic_tpu.create_rays reaches:
// exit-pupil LUT or naive first-element shaping; the pupil pre-check or none,
// its bound the 2-circle cover or the harmonic cos series, from its Horner
// polynomial or lerped per key (the select chain); the iris refract-identity
// skip; hash or presampled (image bokeh) draws.  The variant is a template
// argument, one kernel instance per word of bits (ZOIC_RAYTRACED_INSTANCES),
// so no instance tests a bit.  The element flags are no variant either: the
// root's sign and the TIR threshold are read from the element table, into
// which the wrapper writes a state's static flags (a multiply by +-1 picks
// the same root as the add or subtract, a threshold of +inf gates the TIR
// test off).
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
//   Output: origin = -payload.o, dir = -payload.d of the ray's last trace
//   (zeros if it never traced), tries, tir.
//
// The schedule.  Every draw is a function of the ray, its try count or round,
// and the batch, so a ray's result does not depend on which lane runs which
// of its steps, nor when.  The TPU kernel answers lanes in lockstep with a
// compacted retry machine (fold eras, bitonic unsort); a thread that owns
// one ray from start to end leaves a warp waiting for its slowest ray, and
// its lanes reach the trace one by one as their scans end (6 of 32 lanes
// active per trace on the headline camera, 2-4 on the others, measured on
// an NVIDIA H100 at 4,194,304 rays; here 25-31).
// Here a warp is a worker with two rings of 64 rays in shared memory, one of
// rays that stand before a draw and one of rays that stand before a trace,
// and a ray's walk is cut into steps that every lane can take at once:
//   tile pass:  32 consecutive rays (tile = warp, warp + warps of the grid,
//               ...): prologue and the caller's draw in every lane;
//   draw pass:  the oldest 32 rays of the draw ring take one draw each: the
//               budget and round checks of the per-ray loop, the draw, the
//               bound;
//   trace pass: the oldest 32 rays of the trace ring go through the element
//               stack together and write their payload.
// A ray whose draw passes the bound joins the trace ring, one whose draw
// fails (or whose trace failed) joins the draw ring at its next draw, and a
// ray that comes out of the stack alive, or has spent its budget, writes
// its tries and tir and is done (zeros for a payload it never had).  A full
// pass of either ring goes first; a new tile is taken only while both rings
// hold fewer than 32 rays, so neither overflows; when the tiles are used up
// the rings drain in partly filled passes, draws first.  One loop body holds
// one prologue, one draw, one trace and one store site.  The grid is
// persistent (blocks per SM from the occupancy query x SMs, capped by the
// work; the wrapper computes it) so that a warp sees enough tiles to keep
// its rings full; no global counter, no scratch.
//
// What bounds it on this card: float compute (53 FADD/FMUL per element with
// contraction off, the algorithm's count, in a loop of 83 instructions of
// which 54 are FADD/FMUL: tools/sass_count.py --match ILi15E counts them),
// with 16 B read and 32 B written per ray, 24 B more per failed trace, plus
// up to two 4 B plane reads per presampled draw.  The rings (8 KB per warp)
// hold an SM to 24 warps.  The element rows, flags, polynomial and scalars
// travel in the kernel's parameter (__grid_constant__, under 3 KB), so every
// lane reads them as constant-bank operands and two launches in flight on
// two streams each see their own; only the shaping keys, indexed per ray,
// sit in shared memory.  Outputs are written by ray id as their rays
// finish: rays leave a ring in the order they joined it, mostly the order
// of their ids.
//
// Rounding: built with --fmad=false and IEEE division and square root so
// that every operation rounds like the eager PyTorch version
// (zoic_tpu_torch/ops/trace_kernel.py:raytraced_plain), in the same order.
//
// Built with ZOIC_COUNT_LANES the kernel also counts the lanes and the
// converged groups of a warp that enter a trace and that take a draw.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace zoic;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kSlots = 64;   // rays a ring of a warp holds
constexpr int kFields = 16;  // words per ray in a ring
constexpr int kMaxElems = 64;
constexpr int kMaxKeys = 128;
constexpr int kMaxCoef = 32;
constexpr unsigned kFull = 0xffffffffu;

// variant bits (trace_kernel._V_*)
constexpr int kLut = 1;         // exit-pupil LUT shaping, else naive
constexpr int kProfile = 2;     // pupil pre-check
constexpr int kPoly = 4;        // pre-check from the polynomial, else chain
constexpr int kCircles = 8;     // 2-circle bound, else harmonic
constexpr int kPresampled = 16; // image-bokeh offsets and retry planes

// One kernel instance per variant word that trace_kernel.variant can
// produce: kPoly and kCircles mean nothing without kProfile.
#define ZOIC_RAYTRACED_INSTANCES(X)                                         \
  X(0) X(1) X(2) X(3) X(6) X(7) X(10) X(11) X(14) X(15)                     \
  X(16) X(17) X(18) X(19) X(22) X(23) X(26) X(27) X(30) X(31)

#ifdef ZOIC_COUNT_LANES
// Lane-use counters of the counting build: [0] lanes and [1] warps that
// entered a trace, [2] lanes and [3] warps that took an aperture draw.
__device__ unsigned long long g_counts[4];
#define COUNT_LANES(slot) count_lanes(g_counts + (slot))
#else
#define COUNT_LANES(slot)
#endif

// What a launch reads at the same address from every lane.  Element table
// row: [center_z, eta^2, 1/R, R^2, cull_r^2, eta, tir_thr (1, or +inf where
// no TIR is possible), sign_r (-1 where R < 0, else 1)].
struct Params {
  float elems[kMaxElems * 8];
  float prof[4 * kMaxCoef];
  float origin_shift, dz0, naive_scale, spacing, sensor_half, inv_dmax;
  int B, n_elems, n_keys, n_coef, iris_idx, max_total, seed, k_draws;
  int n_planes, bp, tile_rows, plane_tiles, reuse;
  const float *sx, *sy, *u1, *u2, *bu1, *bu2, *shap;
  float *origin, *dir;
  int *tries, *tir;
};

struct Payload {
  float ox, oy, oz, dx, dy, dz;
};

// A ray between its rounds.
struct Ray {
  int i;
  float fx, fy, sa, sb, kx, ky, pc[4];
  int tries, tir, rnd;
};

// sqrt(x) for x >= 0 as x * rsqrt(max(x, 1e-35)) (_fast_sqrt).  The clamped
// argument is a normal number, so the bare MUFU.RSQ (no denormal guard) gives
// rsqrtf's bits; a NaN x comes out NaN through the product either way.
__device__ __forceinline__ float sqrt_pos(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(x, F32(1e-35))));
  return x * r;
}

// Element-stack trace with a latched fail that freezes the ray at its last
// reached hit.  Returns whether the ray came out alive.
__device__ __forceinline__ bool trace(const Params& p, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      Payload& out, bool& tir_any) {
  COUNT_LANES(0);
  float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  // fail and tir as words of bits, all set or none: a latch is an OR, a
  // freeze a select, and no bool is carried around the loop
  unsigned fail = 0u, tir = 0u;
  const int n_elems = p.n_elems, iris_idx = p.iris_idx;
  for (int i = 0; i < n_elems; ++i) {
    const float* e = p.elems + 8 * i;
    const float cz = e[0], eta_sq = e[1], inv_r = e[2], r_sq = e[3];
    const float cull_r_sq = e[4], eta = e[5], tir_thr = e[6], sign_r = e[7];
    float lz = cz - oz;
    float tca = lz * dz - (ox * dx + oy * dy);
    float px = ox + tca * dx;
    float py = oy + tca * dy;
    float pz = lz - tca * dz;
    float d2 = px * px + py * py + pz * pz;
    float thc = sqrt_pos(fabsf(r_sq - d2));
    float t = tca + thc * sign_r;
    float hx = ox + dx * t;
    float hy = oy + dy * t;
    float h2 = hx * hx + hy * hy;
    fail |= (d2 > r_sq || h2 > cull_r_sq) ? ~0u : 0u;
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
    const unsigned now = (cs2 > tir_thr) ? ~fail : 0u;
    tir |= now;
    fail |= now;
    float k = eta * c1 - sqrt_pos(fabsf(1.0f - cs2));
    float kk = fail ? 0.0f : k * inv_r;
    float ee = fail ? 1.0f : eta;
    float ndx = dx * ee - ox * kk;
    float ndy = dy * ee - oy * kk;
    float ndz = dz * ee + wz * kk;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }
  tir_any = tir != 0u;
  out = Payload{ox, oy, oz, dx, dy, dz};
  return !fail;
}

// Pre-check bound test of one candidate offset.  Circles: pc = (2 a1, q1,
// 2 a2, q2), inside both circles.  Harmonic: pc = (c0, c1, c2, c4),
// rho <= c0 + c1 cos + c2 cos 2phi + c4 cos 4phi by Chebyshev from one rsqrt.
template <bool kCirc>
__device__ __forceinline__ bool bound_pass(float lx, float ly,
                                           const float (&pc)[4]) {
  const float rr = lx * lx + ly * ly;
  if (kCirc)
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
template <bool kCirc>
__device__ __forceinline__ bool bound_dead(const float (&pc)[4]) {
  if (kCirc)
    return (circle_min(pc[0]) > pc[1]) || (circle_min(pc[2]) > pc[3]);
  return (pc[0] + fabsf(pc[1]) + fabsf(pc[2]) + fabsf(pc[3])) < 0.0f;
}

// Film point, shaping affine and pre-check coefficients of ray r.i.  Returns
// whether the ray is live: a dead key takes its whole budget without a round.
template <int V>
__device__ __forceinline__ bool prologue(const Params& p, const float* shap,
                                         Ray& r) {
  constexpr bool use_lut = V & kLut, use_profile = V & kProfile;
  constexpr bool use_poly = V & kPoly, circles = V & kCircles;
  // film point: both axes scale by sensorWidth / 2
  const float fx = p.sx[r.i] * p.sensor_half;
  const float fy = p.sy[r.i] * p.sensor_half;
  r.fx = fx;
  r.fy = fy;

  // key bracket and lerp weight (true division, not a reciprocal
  // multiply: it decides the bracket)
  const float spacing = p.spacing;
  const float dist = sqrtf(fx * fx + fy * fy);
  int i_lb = (int)ceilf(dist / spacing);
  i_lb = i_lb < 0 ? 0 : (i_lb > p.n_keys - 1 ? p.n_keys - 1 : i_lb);
  const int i_prev = i_lb - 1 > 0 ? i_lb - 1 : 0;
  const float lower = (float)i_lb * spacing;
  const float prev = (float)i_prev * spacing;
  const float denom = prev - lower;
  float perc = (denom != 0.0f) ? (dist - lower) / denom : 0.0f;
  perc = (dist == 0.0f) ? 0.0f : perc;
  const float* lb = shap + 6 * i_lb;
  const float* pr = shap + 6 * i_prev;

  // LUT shaping folded into dx = lx*sa - ly*sb + kx, dy = lx*sb + ly*sa + ky
  r.sa = r.sb = r.kx = r.ky = 0.0f;
  if (use_lut) {
    const float ms = lb[0] + perc * (pr[0] - lb[0]);
    const float trn = lb[1] + perc * (pr[1] - lb[1]);
    const float theta = atan2f(fy, fx);
    const float sn = fast_sin(theta);
    const float cs = fast_cos(theta);
    r.sa = ms * cs;
    r.sb = ms * sn;
    r.kx = trn * cs - fx;
    r.ky = trn * sn - fy;
  }

  // pre-check coefficients: lerped per key, or by Horner in
  // t = min(dist/dmax, 1) and switched off beyond the fitted domain
  float pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (use_profile && !use_poly) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pc[j] = lb[2 + j] + perc * (pr[2 + j] - lb[2 + j]);
  } else if (use_profile) {
    const float t_raw = dist * p.inv_dmax;
    const float t = (t_raw > 1.0f) ? 1.0f : t_raw;  // NaN propagates
    const int n_coef = p.n_coef, deg = n_coef - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) pc[j] = 0.0f + p.prof[j * n_coef + deg];
    for (int k = deg - 1; k >= 0; --k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pc[j] = pc[j] * t + p.prof[j * n_coef + k];
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
#pragma unroll
  for (int j = 0; j < 4; ++j) r.pc[j] = pc[j];
  r.tir = 0;
  r.rnd = 0;
  const bool dead = use_profile && bound_dead<circles>(r.pc);
  r.tries = dead ? p.max_total : 0;
  return !dead;
}

// The aperture offset of ray r's draw j of round r.rnd.  The caller's draw
// (round 0, j = 0) is (u1v, u2v) and consumes no try; every other draw is
// the counter hash keyed by (i, seed, try) or, presampled, the plane cell of
// its draw index, and consumes one.
template <int V>
__device__ __forceinline__ void draw(const Params& p, Ray& r, int j,
                                     float u1v, float u2v, float& lx,
                                     float& ly) {
  constexpr bool use_profile = V & kProfile, presampled = V & kPresampled;
  if (r.rnd == 0 && j == 0) {
    if (presampled) {
      lx = u1v;
      ly = u2v;
    } else {
      concentric(u1v, u2v, lx, ly);
    }
    return;
  }
  if (presampled) {
    const int idx = !use_profile ? r.rnd - 1
                    : r.rnd == 0 ? j - 1
                                 : p.k_draws * r.rnd + j;
    const int64_t c = plane_cell(r.i, idx, p.n_planes, p.bp, p.tile_rows,
                                 p.plane_tiles, p.reuse != 0, 7);
    lx = p.bu1[c];
    ly = p.bu2[c];
  } else {
    concentric(hash_uniform((uint32_t)r.i, (uint32_t)p.seed,
                            (uint32_t)r.tries, kSaltU1),
               hash_uniform((uint32_t)r.i, (uint32_t)p.seed,
                            (uint32_t)r.tries, kSaltU2),
               lx, ly);
  }
  ++r.tries;
}

// Fields of a ray in a warp's rings: field f of slot s at q[f * kSlots + s],
// so that 32 lanes on 32 consecutive slots touch 32 banks.  qA, qB: in the
// trace ring the lens-space direction (dx, dy) of the candidate; in the draw
// ring qA = j | traced << 16, the position in the round and whether the ray
// has a payload on the card.
enum { qI, qFx, qFy, qSa, qSb, qKx, qKy, qPc0, qPc1, qPc2, qPc3, qTries,
       qTir, qRnd, qA, qB };

template <int V>
__device__ __forceinline__ void load_rest(const float* q, int s, Ray& r) {
  const int* qi = reinterpret_cast<const int*>(q);
  r.rnd = qi[qRnd * kSlots + s];
  if (V & kLut) {
    r.sa = q[qSa * kSlots + s];
    r.sb = q[qSb * kSlots + s];
    r.kx = q[qKx * kSlots + s];
    r.ky = q[qKy * kSlots + s];
  }
  if (V & kProfile) {
    r.pc[0] = q[qPc0 * kSlots + s];
    r.pc[1] = q[qPc1 * kSlots + s];
    r.pc[2] = q[qPc2 * kSlots + s];
    r.pc[3] = q[qPc3 * kSlots + s];
  }
}

template <int V>
__device__ __forceinline__ void store_ray(float* q, int s, const Ray& r) {
  int* qi = reinterpret_cast<int*>(q);
  qi[qI * kSlots + s] = r.i;
  q[qFx * kSlots + s] = r.fx;
  q[qFy * kSlots + s] = r.fy;
  if (V & kLut) {
    q[qSa * kSlots + s] = r.sa;
    q[qSb * kSlots + s] = r.sb;
    q[qKx * kSlots + s] = r.kx;
    q[qKy * kSlots + s] = r.ky;
  }
  if (V & kProfile) {
    q[qPc0 * kSlots + s] = r.pc[0];
    q[qPc1 * kSlots + s] = r.pc[1];
    q[qPc2 * kSlots + s] = r.pc[2];
    q[qPc3 * kSlots + s] = r.pc[3];
  }
  qi[qTries * kSlots + s] = r.tries;
  qi[qTir * kSlots + s] = r.tir;
  qi[qRnd * kSlots + s] = r.rnd;
}

template <int V>
__global__ void __launch_bounds__(kBlock)
raytraced_kernel(const __grid_constant__ Params p) {
  constexpr bool use_lut = V & kLut, use_profile = V & kProfile;
  constexpr bool circles = V & kCircles;
  __shared__ float shap[kMaxKeys * 6];
  __shared__ float rings[kWarps * 2 * kFields * kSlots];
  for (int j = threadIdx.x; j < p.n_keys * 6; j += blockDim.x)
    shap[j] = p.shap[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* tq = rings + (threadIdx.x >> 5) * (2 * kFields * kSlots);  // traces
  float* dq = tq + kFields * kSlots;                                // draws
  int* tqi = reinterpret_cast<int*>(tq);
  int* dqi = reinterpret_cast<int*>(dq);
  const int n_tiles = (p.B + 31) >> 5;
  const int n_warps = gridDim.x * kWarps;
  const int max_total = p.max_total;
  const int per_round = use_profile ? p.k_draws : 1;
  int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // ring positions, the same in every lane
  int t_head = 0, t_tail = 0, d_head = 0, d_tail = 0;

  for (;;) {
    // At this point no lane holds a ray: every ray of this warp is finished,
    // waits in a ring, or is not loaded yet.  A pass pops at most 32 rays
    // of one ring and pushes at most as many to either, so it takes no more
    // than the other ring has room for.
    const int nt = t_tail - t_head, nd = d_tail - d_head;
    const int can_trace = min(min(nt, 32), kSlots - nd);
    const int can_draw = min(min(nd, 32), kSlots - nt);
    enum { kTile, kTrace, kDraw } pass;
    if (can_trace == 32) {
      pass = kTrace;
    } else if (can_draw == 32) {
      pass = kDraw;
    } else if (tile < n_tiles && nt < 32 && nd < 32) {
      pass = kTile;
    } else if (can_draw > 0) {  // partly filled: the cheaper pass first
      pass = kDraw;
    } else if (can_trace > 0) {
      pass = kTrace;
    } else {
      break;
    }

    Ray r;
    int j = 0;
    float u1v = 0.0f, u2v = 0.0f, dx = 0.0f, dy = 0.0f;
    bool step = false, finish = false, traced = false;
    bool to_trace = false, to_draw = false;
    if (pass == kTile) {
      // a new tile of 32 consecutive rays: prologue and the caller's draw
      r.i = tile * 32 + lane;
      tile += n_warps;
      if (r.i < p.B) {
        u1v = p.u1[r.i];
        u2v = p.u2[r.i];
        step = prologue<V>(p, shap, r);
        finish = !step;
      }
    } else if (pass == kTrace) {
      const int s = (t_head + lane) & (kSlots - 1);
      t_head += can_trace;
      if (lane < can_trace) {
        r.fx = tq[qFx * kSlots + s];
        r.fy = tq[qFy * kSlots + s];
        Payload pay;
        bool tir_flag;
        finish = trace(p, r.fx, r.fy, p.origin_shift, tq[qA * kSlots + s],
                       tq[qB * kSlots + s], p.dz0, pay, tir_flag);
        r.i = tqi[qI * kSlots + s];
        r.tries = tqi[qTries * kSlots + s];
        r.tir = tqi[qTir * kSlots + s] + (tir_flag ? 1 : 0);
        traced = true;
        float* o = p.origin + 3 * (int64_t)r.i;
        float* d = p.dir + 3 * (int64_t)r.i;
        o[0] = -pay.ox;
        o[1] = -pay.oy;
        o[2] = -pay.oz;
        d[0] = -pay.dx;
        d[1] = -pay.dy;
        d[2] = -pay.dz;
        if (!finish) {  // the ray goes on with its next round's draws
          to_draw = true;
          load_rest<V>(tq, s, r);
        }
      }
    } else {
      const int s = (d_head + lane) & (kSlots - 1);
      d_head += can_draw;
      if (lane < can_draw) {
        step = true;
        r.i = dqi[qI * kSlots + s];
        r.fx = dq[qFx * kSlots + s];
        r.fy = dq[qFy * kSlots + s];
        r.tries = dqi[qTries * kSlots + s];
        r.tir = dqi[qTir * kSlots + s];
        load_rest<V>(dq, s, r);
        const int jt = dqi[qA * kSlots + s];
        j = jt & 0xffff;
        traced = (jt >> 16) != 0;
      }
    }

    // one draw of each ray that stands at one: the budget and round checks
    // of the per-ray loop, the draw, the bound
    if (step) {
      if (r.tries >= max_total || (j == 0 && r.rnd > max_total)) {
        finish = true;  // the budget is spent
      } else {
        float lx, ly;
        const int n_draws =
            (use_profile && r.rnd == 0) ? per_round + 1 : per_round;
        draw<V>(p, r, j, u1v, u2v, lx, ly);
        COUNT_LANES(2);
        if (!use_profile || bound_pass<circles>(lx, ly, r.pc)) {
          to_trace = true;
          ++r.rnd;
          if (use_lut) {
            dx = lx * r.sa - ly * r.sb + r.kx;
            dy = lx * r.sb + ly * r.sa + r.ky;
          } else {
            dx = lx * p.naive_scale - r.fx;
            dy = ly * p.naive_scale - r.fy;
          }
        } else {
          to_draw = true;
          if (++j == n_draws) {
            j = 0;
            ++r.rnd;
          }
        }
      }
    }
    if (finish) {
      if (!traced) {  // never traced: the negated zero payload
        float* o = p.origin + 3 * (int64_t)r.i;
        float* d = p.dir + 3 * (int64_t)r.i;
        o[0] = o[1] = o[2] = -0.0f;
        d[0] = d[1] = d[2] = -0.0f;
      }
      p.tries[r.i] = r.tries;
      p.tir[r.i] = r.tir;
    }

    // queue behind the rays that wait: every lane has read its popped slot
    // before any lane writes one
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    const unsigned mt = __ballot_sync(kFull, to_trace);
    const unsigned md = __ballot_sync(kFull, to_draw);
    if (to_trace) {
      const int s = (t_tail + __popc(mt & below)) & (kSlots - 1);
      store_ray<V>(tq, s, r);
      tq[qA * kSlots + s] = dx;
      tq[qB * kSlots + s] = dy;
    }
    if (to_draw) {
      const int s = (d_tail + __popc(md & below)) & (kSlots - 1);
      store_ray<V>(dq, s, r);
      dqi[qA * kSlots + s] = j | (traced ? 1 << 16 : 0);
    }
    t_tail += __popc(mt);
    d_tail += __popc(md);
    __syncwarp();
  }
}

template <int V>
int launch_instance(const Params& p, int grid, cudaStream_t stream) {
  raytraced_kernel<V><<<grid, kBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int V>
int blocks_per_sm_instance(int* n) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, raytraced_kernel<V>, kBlock, 0);
}

}  // namespace

// Blocks of kBlock threads of the variant's instance that one SM holds at a
// time (the occupancy query), or -1 for a variant without an instance or a
// failed query.  The wrapper sizes the persistent grid with it.
extern "C" int zoic_raytraced_blocks_per_sm(int variant) {
  int n = 0, err = (int)cudaErrorInvalidValue;
  switch (variant) {
#define ZOIC_CASE(V)                     \
  case V:                                \
    err = blocks_per_sm_instance<V>(&n); \
    break;
    ZOIC_RAYTRACED_INSTANCES(ZOIC_CASE)
#undef ZOIC_CASE
  }
  return err == 0 ? n : -1;
}

// Launch `grid` blocks on `stream`; returns cudaGetLastError() as an int
// (0 = success).  elems ([n_elems, 8]), prof ([4, n_coef]) and scal ([8]: origin_shift, -thickness[0], -, aperture[0],
// key spacing, -, sensor_width / 2, inv_dmax) are host arrays, copied into
// the kernel's parameter; shap ([n_keys, 6]) and every other pointer are
// device memory.  bu1/bu2 ([n_planes, bp]) are read only in the presampled
// variants.
extern "C" int zoic_raytraced_launch(
    const float* sx, const float* sy, const float* u1, const float* u2,
    const float* bu1, const float* bu2, const float* elems,
    const float* shap, const float* prof, const float* scal, float* origin,
    float* dir, int* tries, int* tir, int B, int n_elems, int n_keys,
    int n_coef, int iris_idx, int max_total, int seed, int variant,
    int k_draws, int n_planes, int bp, int tile_rows, int plane_tiles,
    int reuse, int grid, void* stream) {
  if (B <= 0) return 0;
  if (n_elems > kMaxElems || n_elems < 0 || n_keys > kMaxKeys || n_keys < 1 ||
      n_coef > kMaxCoef || n_coef < 1 || k_draws < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if ((variant & kPresampled) &&
      (bu1 == nullptr || bu2 == nullptr || n_planes < 1 || bp < 1 ||
       tile_rows < 1 || (tile_rows & (tile_rows - 1)) != 0 ||
       plane_tiles < 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int j = 0; j < n_elems * 8; ++j) p.elems[j] = elems[j];
  for (int j = 0; j < 4 * n_coef; ++j) p.prof[j] = prof[j];
  p.origin_shift = scal[0];
  p.dz0 = scal[1];
  p.naive_scale = scal[3];
  p.spacing = scal[4];
  p.sensor_half = scal[6];
  p.inv_dmax = scal[7];
  p.B = B;
  p.n_elems = n_elems;
  p.n_keys = n_keys;
  p.n_coef = n_coef;
  p.iris_idx = iris_idx;
  p.max_total = max_total;
  p.seed = seed;
  p.k_draws = k_draws;
  p.n_planes = n_planes;
  p.bp = bp;
  p.tile_rows = tile_rows;
  p.plane_tiles = plane_tiles;
  p.reuse = reuse;
  p.sx = sx;
  p.sy = sy;
  p.u1 = u1;
  p.u2 = u2;
  p.bu1 = bu1;
  p.bu2 = bu2;
  p.shap = shap;
  p.origin = origin;
  p.dir = dir;
  p.tries = tries;
  p.tir = tir;
  switch (variant) {
#define ZOIC_CASE(V) \
  case V:            \
    return launch_instance<V>(p, grid, (cudaStream_t)stream);
    ZOIC_RAYTRACED_INSTANCES(ZOIC_CASE)
#undef ZOIC_CASE
  }
  return (int)cudaErrorInvalidValue;  // a variant word without an instance
}

#ifdef ZOIC_COUNT_LANES
// The counting build's counters: zero them, or copy them to the host after
// the launches on every stream have finished.
extern "C" int zoic_raytraced_counts_reset() {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
}

extern "C" int zoic_raytraced_counts_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_counts, 4 * sizeof(*out));
}
#endif
