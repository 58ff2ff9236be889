// K7: keyed sampling from the fused distribution (Gumbel-max over the
// vocabulary) with the greedy argmax beside it, in one read of probs.
//
// The reference has no Pallas kernel for this: it samples in jnp,
// src/repro/kernels/logit_fusion/ops.py::sample_fused and
// ::select_sample_fused (jax.random.categorical on log(max(p, 1e-9)),
// keyed fold_in(fold_in(key(seed), key_id), step) per row).  Per row b
// and element j this kernel computes what jax 0.9.0 computes there on
// the CPU, bit for bit:
//   key    = threefry(threefry((0, seed), (0, key_ids[b])), (0, steps[b]))
//   bits   = x0 ^ x1 of threefry(key, (0, j))   (partitionable counters)
//   u      = max(tiny, float((bits >> 9) | 0x3f800000) - 1 + tiny)
//   score  = -log(-log(u)) + log(max(p, 1e-9))
// and returns argmax_j score (the drawn id) or, on greedy rows, argmax_j
// p; ties go to the smaller index, as jnp.argmax breaks them.  log is
// XLA's CPU f32 log (Cephes via Eigen's plog), op for op as
// repro_torch/core/prng.py::log has it: fused multiply-adds through
// __fmaf_rn where XLA fuses, __fmul_rn / __fadd_rn / __fsub_rn where it
// must round, so nvcc's contraction of a*b+c (on by default) never
// touches them.  The constants are the f32 values as hex literals.
//
// Bound on the H100: the integer instruction rate, not bytes.  At B = 8,
// V = 256,000 the kernel reads 8.2 MB of probs (0.0024 ms at 3.35 TB/s),
// but each element needs 20 threefry rounds (an add, a funnel shift and a xor
// each, ~75 integer operations with the key injections) and three logs:
// ~154 M integer operations, 0.009 ms over 132 SMs x 64 INT32 lanes at
// 1,980 MHz.
//
// Design: split-V over the card.  Grid (C, B), 256 threads: CTA (c, b)
// folds row b's key once (thread 0, into shared memory; the key ids and
// steps are read from device memory, so the launch can sit in a CUDA
// graph whose inputs change between replays), walks chunk c of the row
// (thread t takes elements lo + t, lo + t + 256, ...) keeping a running
// (score, index) and (p, index) max, reduces them over the block and
// writes one partial per CTA.  A second launch (one warp a row) merges
// the C partials.  (max, smallest index) is exact and does not depend
// on the order of the merge, so a call repeats bit for bit.  With
// `scores` non-null the first pass also writes every score (tests).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// XLA's CPU log constants (f32), see prng.py
constexpr float kP0 = 0x1.204376p-4f, kP1 = -0x1.d7a370p-4f,
                kP2 = 0x1.de4a34p-4f, kP3 = -0x1.fcba9ep-4f,
                kP4 = 0x1.23d37ep-3f, kP5 = -0x1.555ca0p-3f,
                kP6 = 0x1.999d58p-3f, kP7 = -0x1.fffff8p-3f,
                kP8 = 0x1.555554p-2f, kQ1 = -0x1.bd0106p-13f,
                kQ2 = 0x1.630000p-1f, kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kClip = 0x1.12e0bep-30f;       // float32(1e-9)
constexpr float kTiny = 0x1p-126f;             // finfo(float32).tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax.random's threefry2x32.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define ROUND(r) \
  x0 += x1;      \
  x1 = rotl(x1, r) ^ x0;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef ROUND
  return make_uint2(x0, x1);
}

// XLA's CPU f32 log: subnormals read as zero, frexp into
// [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three fma chains, the
// exponent added back as e * (q1 + q2).
__device__ __forceinline__ float xla_log(float x) {
  if (fabsf(x) < kTiny) return -INFINITY;
  if (x < 0.f) return __int_as_float(0x7fc00000);
  if (isinf(x) || isnan(x)) return x;
  int ei;
  const float m = frexpf(x, &ei);
  const bool small = m < kSqrtHalf;
  const float e = static_cast<float>(ei - (small ? 1 : 0));
  const float r = __fadd_rn(__fsub_rn(m, 1.f), small ? m : 0.f);
  const float r2 = __fmul_rn(r, r);
  const float r3 = __fmul_rn(r2, r);
  float y = __fmaf_rn(__fmaf_rn(kP0, r, kP1), r, kP2);
  const float y1 = __fmaf_rn(__fmaf_rn(kP3, r, kP4), r, kP5);
  const float y2 = __fmaf_rn(__fmaf_rn(kP6, r, kP7), r, kP8);
  y = __fmaf_rn(__fmaf_rn(y, r3, y1), r3, y2);
  y = __fmaf_rn(y, r3, __fmul_rn(kQ1, e));
  const float out = __fadd_rn(__fmaf_rn(-0.5f, r2, r), y);
  return __fmaf_rn(kQ2, e, out);
}

// (v, i) beats (bv, bi): larger value, or equal value at a smaller index
__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_take(float& sv, int& si, float& pv,
                                          int& pi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    take(sv, si, __shfl_xor_sync(0xffffffffu, sv, o),
         __shfl_xor_sync(0xffffffffu, si, o));
    take(pv, pi, __shfl_xor_sync(0xffffffffu, pv, o),
         __shfl_xor_sync(0xffffffffu, pi, o));
  }
}

// grid (C, B), block kThreads; part (B, C) int4 of (score bits, index,
// p bits, index)
__global__ void __launch_bounds__(kThreads)
sample_partial(const float* __restrict__ probs, int vocab, int chunk,
               const int* __restrict__ key_ids,
               const int* __restrict__ steps, uint32_t seed_hi,
               uint32_t seed_lo, float* __restrict__ scores,
               int4* __restrict__ part) {
  __shared__ uint2 key;
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    const uint2 k = threefry(seed_hi, seed_lo, 0u,
                             static_cast<uint32_t>(key_ids[b]));
    key = threefry(k.x, k.y, 0u, static_cast<uint32_t>(steps[b]));
  }
  __syncthreads();
  const uint32_t k0 = key.x, k1 = key.y;
  const size_t row = static_cast<size_t>(b) * vocab;
  const int lo = c * chunk, hi = min(lo + chunk, vocab);
  float sv = -INFINITY, pv = -INFINITY;
  int si = INT_MAX, pi = INT_MAX;
  for (int j = lo + tid; j < hi; j += kThreads) {
    const float p = probs[row + j];
    const uint2 o = threefry(k0, k1, 0u, static_cast<uint32_t>(j));
    const uint32_t bits = o.x ^ o.y;
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u),
                              1.f);
    // f * (1 - tiny) + tiny, where 1 - tiny is 1 in f32
    const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
    const float g = -xla_log(-xla_log(u));
    const float s = __fadd_rn(g, xla_log(fmaxf(p, kClip)));
    if (scores != nullptr) scores[row + j] = s;
    take(sv, si, s, j);
    take(pv, pi, p, j);
  }
  warp_take(sv, si, pv, pi);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red_v[0][warp] = sv;
    red_i[0][warp] = si;
    red_v[1][warp] = pv;
    red_i[1][warp] = pi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      take(sv, si, red_v[0][w], red_i[0][w]);
      take(pv, pi, red_v[1][w], red_i[1][w]);
    }
    part[static_cast<size_t>(b) * gridDim.x + c] =
        make_int4(__float_as_int(sv), si, __float_as_int(pv), pi);
  }
}

// grid B, one warp: merge row b's C partials
__global__ void sample_select(const int4* __restrict__ part, int chunks,
                              const uint8_t* __restrict__ greedy,
                              long long* __restrict__ out) {
  const int b = blockIdx.x;
  float sv = -INFINITY, pv = -INFINITY;
  int si = INT_MAX, pi = INT_MAX;
  for (int c = threadIdx.x; c < chunks; c += 32) {
    const int4 q = part[static_cast<size_t>(b) * chunks + c];
    take(sv, si, __int_as_float(q.x), q.y);
    take(pv, pi, __int_as_float(q.z), q.w);
  }
  warp_take(sv, si, pv, pi);
  if (threadIdx.x == 0)
    out[b] = (greedy != nullptr && greedy[b]) ? pi : si;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// probs (batch, vocab) f32 contiguous; key_ids, steps (batch,) int32;
// greedy (batch,) bool or null (every row draws); the sampling key is
// jax.random.key(seed) = (seed_hi, seed_lo); scores (batch, vocab) f32
// or null; part an int32 scratch of batch * chunks * 4 values, 16-byte
// aligned; out (batch,) int64.  Chunk c covers [c * chunk, min((c + 1)
// * chunk, vocab)), chunks = ceil(vocab / chunk).  Returns 0 or a
// cudaError_t.
extern "C" int sample_fused(const float* probs, int batch, int vocab,
                            const int* key_ids, const int* steps,
                            const uint8_t* greedy, unsigned int seed_hi,
                            unsigned int seed_lo, float* scores, int* part,
                            int chunks, int chunk, long long* out,
                            cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || vocab <= 0 || chunks <= 0 ||
      chunk <= 0 || static_cast<long long>(chunks) * chunk < vocab ||
      static_cast<long long>(chunks - 1) * chunk >= vocab ||
      !aligned16(part))
    return cudaErrorInvalidValue;
  sample_partial<<<dim3(chunks, batch), kThreads, 0, stream>>>(
      probs, vocab, chunk, key_ids, steps, seed_hi, seed_lo, scores,
      reinterpret_cast<int4*>(part));
  sample_select<<<batch, 32, 0, stream>>>(
      reinterpret_cast<const int4*>(part), chunks, greedy, out);
  return static_cast<int>(cudaGetLastError());
}
