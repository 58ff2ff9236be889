// Fused logit-level LLM-SLM fusion (paper Eq. 15 + the Sec. IV-D mask).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/logit_fusion/kernel.py::fuse_logits (_fusion_kernel):
// per row, out = w * softmax(z_slm) + (1 - w) * softmax(z_llm), with w
// forced to 1 where arrived == 0.
//
// Bound on the H100: memory.  A row of V = 256,000 logits needs two reads
// of V values and one f32 write of V values (12 bytes x V in f32, about
// 3.1 MB, about 0.92 us at 3.35 TB/s); the arithmetic (two exps a value)
// is far below the card's rate.  A row is 1 MB per input, far above the
// 227 KB of shared memory a block may hold, so the TPU kernel's
// one-block-in-VMEM softmax does not carry over.
//
// Design (simple first): one block of 1024 threads per row.  Pass 1 keeps
// an online (max, sum) pair per thread for both logit rows over a strided
// walk of V, merged across the block with warp shuffles and shared
// memory.  Pass 2 re-reads both rows (from L2 at this size) and writes the
// fused probabilities.  At B = 1 this occupies one SM of 132; splitting V
// across blocks is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Merge the online-softmax pair (m2, l2) into (m, l); -inf maxima are
// empty pairs.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fuse_logits_kernel(const T* __restrict__ slm, const T* __restrict__ llm,
                   const float* __restrict__ w,
                   const int* __restrict__ arrived,
                   float* __restrict__ out, int vocab) {
  __shared__ float red[4][kWarps];
  __shared__ float stats[4];
  const size_t base = static_cast<size_t>(blockIdx.x) * vocab;
  const T* s = slm + base;
  const T* l = llm + base;
  float* o = out + base;

  float ms = -INFINITY, ls = 0.f, ml = -INFINITY, ll = 0.f;
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    merge(ms, ls, to_float(s[i]), 1.f);
    merge(ml, ll, to_float(l[i]), 1.f);
  }
  warp_merge(ms, ls);
  warp_merge(ml, ll);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = ms;
    red[1][warp] = ls;
    red[2][warp] = ml;
    red[3][warp] = ll;
  }
  __syncthreads();
  if (warp == 0) {
    ms = red[0][lane];
    ls = red[1][lane];
    ml = red[2][lane];
    ll = red[3][lane];
    warp_merge(ms, ls);
    warp_merge(ml, ll);
    if (lane == 0) {
      stats[0] = ms;
      stats[1] = ls;
      stats[2] = ml;
      stats[3] = ll;
    }
  }
  __syncthreads();
  ms = stats[0];
  ls = stats[1];
  ml = stats[2];
  ll = stats[3];

  const float wr = arrived[blockIdx.x] != 0 ? w[blockIdx.x] : 1.f;
  const float wl = 1.f - wr;
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    const float ps = expf(to_float(s[i]) - ms) / ls;
    const float pl = expf(to_float(l[i]) - ml) / ll;
    o[i] = wr * ps + wl * pl;
  }
}

template <typename T>
int launch(const void* slm, const void* llm, const float* w,
           const int* arrived, float* out, int batch, int vocab,
           cudaStream_t stream) {
  if (batch <= 0 || vocab <= 0) return cudaErrorInvalidValue;
  fuse_logits_kernel<T><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(slm), static_cast<const T*>(llm), w, arrived,
      out, vocab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fuse_logits_f32(const void* slm, const void* llm,
                               const float* w, const int* arrived,
                               float* out, int batch, int vocab,
                               cudaStream_t stream) {
  return launch<float>(slm, llm, w, arrived, out, batch, vocab, stream);
}

extern "C" int fuse_logits_bf16(const void* slm, const void* llm,
                                const float* w, const int* arrived,
                                float* out, int batch, int vocab,
                                cudaStream_t stream) {
  return launch<__nv_bfloat16>(slm, llm, w, arrived, out, batch, vocab,
                               stream);
}
