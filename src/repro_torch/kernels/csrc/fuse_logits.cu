// Fused logit-level LLM-SLM fusion (paper Eq. 15 + the Sec. IV-D mask).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/logit_fusion/kernel.py::fuse_logits (_fusion_kernel):
// per row, out = w * softmax(z_slm) + (1 - w) * softmax(z_llm), with w
// rounded to the logits' type (as the Pallas wrapper does) and forced to
// 1 where arrived is false.
//
// Bound on the H100: bytes.  B rows of V logits need two reads of B x V
// values and one f32 write of B x V values: at B = 8, V = 256,000, f32,
// 24.6 MB, 0.0073 ms at 3.35 TB/s; the arithmetic (two exps a value) is
// far below the card's rate.  A row is 1 MB per input, far above the
// 227 KB of shared memory a block may hold, so the TPU kernel's
// one-block-in-VMEM softmax does not carry over.
//
// Design: split-V over the whole card, two launches over one grid
// (C, B); the wrapper takes the chunk count C and length from B, V and
// the card's SM count alone (B x C at least two waves of CTAs, 264 on
// an H100 SXM's 132 SMs; a chunk a multiple of 8 values and at most
// kThreads * kElems).
//  1. stats: CTA (c, b) reads chunk c of both rows once with 16-byte
//     loads (4 f32 or 8 bf16 a lane) and keeps the values in registers:
//     the chunk max m, then l = sum exp(x - m) at one exponential a
//     value.  (m_slm, l_slm, m_llm, l_llm) go to an f32 scratch (B, C, 4).
//  2. write: CTA (c, b) merges its row's C partials: M = max m_c, then
//     L = sum l_c exp(m_c - M), the terms added in ascending chunk order
//     by one thread.  It reads its chunk again (from L2 at these sizes),
//     forms 1 / L once and writes w exp(s - M_s) / L_s + (1 - w)
//     exp(l - M_l) / L_l with 16-byte stores.
// Every CTA of a row merges the same partials in the same order, and no
// sum uses atomics: a call repeats bit for bit.  The exponential is the
// accurate expf: the kernel is bytes-bound, and the 1e-5 per-element
// limit leaves no room for __expf's argument rounding at logit spreads of
// +-30.  When V is no multiple of the 16-byte vector or a row pointer is
// not 16-byte aligned, values move element by element instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElems = 32;      // values of a row a thread holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes at p as f32 values (4 f32 or 8 bf16)
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The thread's values of row[lo, hi): vector k at lo + (tid + k *
// kThreads) * VEC; -inf past hi.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int lo, int hi,
                                           bool vec, float (&v)[kElems]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kElems / VEC; ++k) {
    const int e = lo + (threadIdx.x + k * kThreads) * VEC;
    if (vec && e < hi) {
      load16(row + e, &v[k * VEC]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        v[k * VEC + i] = e + i < hi ? to_f32(row[e + i]) : -INFINITY;
    }
  }
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Reduce (a, b) over the block; every thread gets the same bits.
template <typename Op>
__device__ __forceinline__ void block_reduce2(float& a, float& b, Op op) {
  __shared__ float red[2][kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = op(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = op(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    a = op(a, red[0][i]);
    b = op(b, red[1][i]);
  }
  __syncthreads();     // red may be written again by the next call
}

// grid (C, B), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
fuse_stats(const T* __restrict__ slm, const T* __restrict__ llm,
           float4* __restrict__ part, int vocab, int chunk, bool vec) {
  const int c = blockIdx.x, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * vocab;
  const int lo = c * chunk, hi = min(lo + chunk, vocab);
  float vs[kElems], vl[kElems];
  load_chunk(slm + row, lo, hi, vec, vs);
  load_chunk(llm + row, lo, hi, vec, vl);
  float ms = -INFINITY, ml = -INFINITY;
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    ms = fmaxf(ms, vs[i]);
    ml = fmaxf(ml, vl[i]);
  }
  block_reduce2(ms, ml, Max());
  // a chunk of -inf logits weighs 0 (and its l is not exp(-inf + inf))
  float ls = 0.f, ll = 0.f;
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    ls = __fadd_rn(ls, ms == -INFINITY ? 0.f : expf(vs[i] - ms));
    ll = __fadd_rn(ll, ml == -INFINITY ? 0.f : expf(vl[i] - ml));
  }
  block_reduce2(ls, ll, Sum());
  if (threadIdx.x == 0)
    part[static_cast<size_t>(b) * gridDim.x + c] = make_float4(ms, ls, ml, ll);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fuse_write(const T* __restrict__ slm, const T* __restrict__ llm,
           const float* __restrict__ w, long long w_stride,
           const uint8_t* __restrict__ arrived, long long a_stride,
           const float4* __restrict__ part, float* __restrict__ out,
           int vocab, int chunk, bool vec) {
  __shared__ float terms[2][kThreads];
  __shared__ float stat[2];
  const int c = blockIdx.x, b = blockIdx.y, C = gridDim.x;
  const int tid = threadIdx.x;
  const float4* p = part + static_cast<size_t>(b) * C;

  float mrow_s = -INFINITY, mrow_l = -INFINITY;
  for (int i = tid; i < C; i += kThreads) {
    const float4 v = p[i];
    mrow_s = fmaxf(mrow_s, v.x);
    mrow_l = fmaxf(mrow_l, v.z);
  }
  block_reduce2(mrow_s, mrow_l, Max());
  float sum_s = 0.f, sum_l = 0.f;    // thread 0 and thread 32
  for (int base = 0; base < C; base += kThreads) {
    if (base + tid < C) {
      const float4 v = p[base + tid];
      terms[0][tid] = __fmul_rn(v.y, expf(v.x - mrow_s));
      terms[1][tid] = __fmul_rn(v.w, expf(v.z - mrow_l));
    }
    __syncthreads();
    const int n = min(kThreads, C - base);
    if (tid == 0)
      for (int i = 0; i < n; ++i) sum_s = __fadd_rn(sum_s, terms[0][i]);
    if (tid == 32)
      for (int i = 0; i < n; ++i) sum_l = __fadd_rn(sum_l, terms[1][i]);
    __syncthreads();
  }
  if (tid == 0) stat[0] = sum_s;
  if (tid == 32) stat[1] = sum_l;
  __syncthreads();

  const bool in = arrived == nullptr || arrived[b * a_stride] != 0;
  const float wr = in ? round_to(w[b * w_stride], T()) : 1.f;
  const float fs = __fmul_rn(wr, 1.f / stat[0]);
  const float fl = __fmul_rn(1.f - wr, 1.f / stat[1]);

  const size_t row = static_cast<size_t>(b) * vocab;
  const int lo = c * chunk, hi = min(lo + chunk, vocab);
  float vs[kElems], vl[kElems];
  load_chunk(slm + row, lo, hi, vec, vs);
  load_chunk(llm + row, lo, hi, vec, vl);
  constexpr int VEC = 16 / sizeof(T);
  float* o = out + row;
#pragma unroll
  for (int k = 0; k < kElems / VEC; ++k) {
    const int e = lo + (tid + k * kThreads) * VEC;
    if (e >= hi) continue;
    float r[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int j = k * VEC + i;
      r[i] = fmaf(fs, expf(vs[j] - mrow_s),
                  __fmul_rn(fl, expf(vl[j] - mrow_l)));
    }
    if (vec) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(o + e + i) =
            make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (e + i < hi) o[e + i] = r[i];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* slm, const void* llm, const float* w,
           long long w_stride, const uint8_t* arrived, long long a_stride,
           float* part, float* out, int batch, int vocab, int chunks,
           int chunk, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (batch <= 0 || batch > 65535 || vocab <= 0 || chunks <= 0 ||
      chunk <= 0 || chunk % 8 != 0 || chunk > kThreads * kElems ||
      static_cast<long long>(chunks) * chunk < vocab ||
      static_cast<long long>(chunks - 1) * chunk >= vocab || !aligned16(part))
    return cudaErrorInvalidValue;
  const bool vec = vocab % VEC == 0 && aligned16(slm) && aligned16(llm) &&
                   aligned16(out);
  const dim3 grid(chunks, batch);
  fuse_stats<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(slm), static_cast<const T*>(llm),
      reinterpret_cast<float4*>(part), vocab, chunk, vec);
  fuse_write<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(slm), static_cast<const T*>(llm), w, w_stride,
      arrived, a_stride, reinterpret_cast<const float4*>(part), out, vocab,
      chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slm/llm (batch, vocab) contiguous, f32 or bf16 (the entry's name); w
// (batch,) f32 at element stride w_stride; arrived (batch,) bool at
// a_stride, or null for all rows arrived; part an f32 scratch of
// batch * chunks * 4 values, 16-byte aligned; out (batch, vocab) f32.
// Chunk c covers [c * chunk, min((c + 1) * chunk, vocab)): chunk a
// multiple of 8 and at most 8,192, chunks = ceil(vocab / chunk).
// Returns 0 or a cudaError_t.
extern "C" int fuse_logits_f32(const void* slm, const void* llm,
                               const float* w, long long w_stride,
                               const uint8_t* arrived, long long a_stride,
                               float* part, float* out, int batch, int vocab,
                               int chunks, int chunk, cudaStream_t stream) {
  return launch<float>(slm, llm, w, w_stride, arrived, a_stride, part, out,
                       batch, vocab, chunks, chunk, stream);
}

extern "C" int fuse_logits_bf16(const void* slm, const void* llm,
                                const float* w, long long w_stride,
                                const uint8_t* arrived, long long a_stride,
                                float* part, float* out, int batch, int vocab,
                                int chunks, int chunk, cudaStream_t stream) {
  return launch<bf16>(slm, llm, w, w_stride, arrived, a_stride, part, out,
                      batch, vocab, chunks, chunk, stream);
}
