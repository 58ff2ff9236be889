// Causal (+ sliding-window) GQA flash attention for prefill, bf16 in/out.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_attn_kernel): q (B, H, S, D), k/v (B, KVH, S, D) -> (B, H, S, D), an
// online softmax in f32 over KV tiles, query head h reading KV head
// h / (H / KVH), masks k_pos <= q_pos (causal) and k_pos > q_pos - window,
// masked scores at NEG_INF = -2**30.
//
// Bound on the H100: at S = 2048, H = 16, D = 256, causal, the work is
// about 2 * S^2 * D * H = 34 GFLOP of bf16 products (35 us at the 989
// TFLOP/s dense peak) against about 67 MB of q/k/v/o traffic (20 us at
// 3.35 TB/s), so a fast kernel is bound by the tensor cores; at a short
// prompt (S = 31) it is bound by launch latency.
//
// Design (simple first, tensor cores through the portable WMMA API):
// one CTA of 8 warps per (b, h, 64-row query tile).  The CTA loads its Q
// tile into shared memory once, then walks the KV tiles that the causal
// and window masks leave visible (whole masked tiles are skipped).  Per
// tile: S = Q K^T on 16x16x16 bf16 WMMA fragments with f32 accumulation
// into shared memory; four threads per query row apply scale and masks,
// update the running max m and denominator l and write P = exp(s - m) as
// bf16; the f32 output accumulator O lives in shared memory, is rescaled
// by exp(m_old - m_new) and gets P V added by WMMA.  The epilogue writes
// O / max(l, 1e-30) as bf16.  Rows and columns past S (a prompt is
// exactly its own length, so S is ragged) are zero-filled on load, masked
// in the scores and never stored.  With D = 256 the tiles take about
// 191 KB of shared memory (Q, K, V 64x264 bf16 each, O 64x260 f32, S and
// P), so the kernel opts into more than 48 KB of dynamic shared memory
// and runs one CTA per SM.  wgmma, TMA and a register-resident O are for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kNegInf = -1073741824.f;  // -2**30, as the reference
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = kBK + 4;  // f32 scores, padded against bank conflicts
constexpr int kLdP = kBK + 8;  // bf16 probabilities

template <int D>
struct Smem {
  static constexpr int kLdX = D + 8;  // bf16 rows of Q, K, V
  static constexpr int kLdO = D + 4;  // f32 rows of O
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * kBQ * kLdX;
  static constexpr size_t v = k + sizeof(bf16) * kBK * kLdX;
  static constexpr size_t s = v + sizeof(bf16) * kBK * kLdX;
  static constexpr size_t p = s + sizeof(float) * kBQ * kLdS;
  static constexpr size_t o = p + sizeof(bf16) * kBQ * kLdP;
  static constexpr size_t m = o + sizeof(float) * kBQ * kLdO;
  static constexpr size_t l = m + sizeof(float) * kBQ;
  static constexpr size_t alpha = l + sizeof(float) * kBQ;
  static constexpr size_t bytes = alpha + sizeof(float) * kBQ;
};

// Copy rows [row0, row0 + 64) of a (S, D) bf16 matrix into shared memory
// with a padded stride, 16 bytes a thread, zero-filling rows past S.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int seq) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    reinterpret_cast<uint4*>(dst + r * Smem<D>::kLdX)[c] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int heads, int kv_heads, int seq, int causal,
                       int window, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const bf16* qp = q + ((size_t)b * heads + h) * seq * D;
  const bf16* kp = k + ((size_t)b * kv_heads + kvh) * seq * D;
  const bf16* vp = v + ((size_t)b * kv_heads + kvh) * seq * D;
  bf16* op = out + ((size_t)b * heads + h) * seq * D;
  const int tid = threadIdx.x, warp = tid >> 5;

  load_tile<D>(sQ, qp, q0, seq);
  for (int idx = tid; idx < kBQ * L::kLdO; idx += kThreads) sO[idx] = 0.f;
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // KV tiles any row of this query tile can see.
  const int kv_end = causal ? min(seq, q0 + kBQ) : seq;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  // Softmax work split: four adjacent threads per query row, 16 columns each.
  const int row = tid >> 2, part = tid & 3;
  const int q_pos = q0 + row;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's P V is done with sK, sV, sP
    load_tile<D>(sK, kp, k0, seq);
    load_tile<D>(sV, vp, k0, seq);
    __syncthreads();

    // S = Q K^T: 4 x 4 fragments of 16 x 16, two per warp.
    for (int f = warp; f < 16; f += kWarps) {
      const int fr = f >> 2, fc = f & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + fr * 16 * L::kLdX + kk, L::kLdX);
        wmma::load_matrix_sync(fb, sK + fc * 16 * L::kLdX + kk, L::kLdX);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + fr * 16 * kLdS + fc * 16, acc, kLdS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax on this tile's scores.
    float sc[16];
    unsigned ok = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = part * 16 + j;
      const int k_pos = k0 + c;
      bool vis = k_pos < seq;
      if (causal) vis = vis && k_pos <= q_pos;
      if (window > 0) vis = vis && k_pos > q_pos - window;
      sc[j] = vis ? sS[row * kLdS + c] * scale : kNegInf;
      ok |= (vis ? 1u : 0u) << j;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_prev = sM[row];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = ((ok >> j) & 1u) ? expf(sc[j] - m_new) : 0.f;
      sum += p;
      sP[row * kLdP + part * 16 + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    __syncwarp();
    if (part == 0) {
      const float alpha = expf(m_prev - m_new);
      sAlpha[row] = alpha;
      sL[row] = sL[row] * alpha + sum;
      sM[row] = m_new;
    }
    __syncthreads();

    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      sO[r * L::kLdO + c] *= sAlpha[r];
    }
    __syncthreads();

    // O += P V: 4 x (D / 16) fragments spread over the warps.
    for (int f = warp; f < 4 * (D / 16); f += kWarps) {
      const int fr = f / (D / 16), fc = f % (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_frag = sO + fr * 16 * L::kLdO + fc * 16;
      wmma::load_matrix_sync(acc, o_frag, L::kLdO, wmma::mem_row_major);
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + fr * 16 * kLdP + kk, kLdP);
        wmma::load_matrix_sync(fb, sV + kk * L::kLdX + fc * 16, L::kLdX);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_frag, acc, L::kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    if (q0 + r < seq)
      op[(size_t)(q0 + r) * D + c] =
          __float2bfloat16(sO[r * L::kLdO + c] / fmaxf(sL[r], 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, int heads, int kv_heads, int seq, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), heads, kv_heads,
      seq, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, S, D), k/v (B, KVH, S, D), out (B, H, S, D): contiguous bf16.
// head_dim 256 is the 2b pair at full width, 32 its reduced configs.
// Returns 0 or the cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int heads, int kv_heads, int seq,
                                    int head_dim, int causal, int window,
                                    float scale, cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, batch, heads, kv_heads, seq, causal,
                        window, scale, stream);
    case 256:
      return launch<256>(q, k, v, out, batch, heads, kv_heads, seq, causal,
                         window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
