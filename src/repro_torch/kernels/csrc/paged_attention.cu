// One-token GQA decode attention over a paged KV pool, bf16 in/out.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::paged_decode_attention
// (_paged_kernel): q (B, H, hd), pools (P, ps, KV, hd), a per-row block
// table (B, nb) of page ids and per-row positions pos (B,) -> (B, H, hd).
// Query head h reads KV head h / (H / KV).  Slot j of a row lives at page
// table[b, j / ps], offset j % ps; a sentinel page id (NO_PAGE = 2**20)
// is clamped onto page P - 1 and masked by position.  Plain mode masks
// slot > pos; window mode (table = the row's ring-local table) maps slot
// i to the absolute position pos - (pos - i) mod window and masks it
// unless 0 <= kv_pos <= pos and i < window.  Masked scores are
// NEG_INF = -2**30, as the reference, so once a live slot has been seen
// they weigh exactly 0.
//
// Bound on the H100: bytes.  A decode step reads each live slot's K and
// V once, ps * KV * hd * 2 bytes * 2 per page, against 2 * G multiply-
// adds per K/V element (G = H / KV query heads per KV head, 1 or 8
// here): about 8 LLM rows at 1,552 live slots is 203 MB, 61 us at
// 3.35 TB/s.
//
// Design (simple first): one CTA of 4 warps per (row, KV head).  It
// holds the group's G query rows (f32, pre-scaled) and its f32 output
// accumulator in shared memory and walks the row's pages in order with an
// online (max, sum) in f32, as the Pallas grid walks its page axis.  Each
// page's K and V (ps x hd bf16, 8 KB each at hd 256) are loaded 16 bytes
// a thread into registers one page ahead, so the next page's loads are in
// flight while the current page is reduced, then staged in shared memory.
// Scores: one warp per (query head, slot) pair, lanes split hd, a
// shuffle reduction.  P V: each thread owns (head, d) accumulator entries.
// The loop covers min(nb, pos / ps + 1) pages in plain mode (a page past
// pos contributes exact zeros in the Pallas kernel, so skipping it
// changes nothing) and every ring page in window mode.  A parked row
// (pos >= FREED_POS = 2**30: a drained or never-admitted lane row) writes
// zeros and reads no page: the Pallas kernel walks all nb clamped pages
// for it, but the engine never reads a parked row's output.  Split-K over pages (the
// flash-decoding shape) is later work: the SLM at B = 8 has one KV head,
// so it runs only 8 CTAs on 132 SMs; the LLM (16 KV heads) runs 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1073741824.f;  // -2**30, as the reference
constexpr int kFreedPos = 1 << 30;        // a parked row's position
constexpr int kPS = 16;                   // slots per page
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int HD>
struct Tile {
  static constexpr int kVecPerRow = HD / 8;           // uint4 = 8 bf16
  static constexpr int kVecs = kPS * kVecPerRow;      // per K (or V) page
  static constexpr int kPerThread = (kVecs + kThreads - 1) / kThreads;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pool_k,
    const bf16* __restrict__ pool_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ pos, bf16* __restrict__ out, int heads,
    int kv_heads, int n_pool, int nb, int window, float scale) {
  using T = Tile<HD>;
  const int b = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);                  // kPS x HD
  bf16* sV = sK + kPS * HD;                                  // kPS x HD
  float* sQ = reinterpret_cast<float*>(sV + kPS * HD);       // G x HD
  float* sO = sQ + group * HD;                               // G x HD
  float* sP = sO + group * HD;                               // G x kPS
  float* sM = sP + group * kPS;                              // G
  float* sL = sM + group;                                    // G
  float* sA = sL + group;                                    // G

  const int p = pos[b];
  bf16* ob = out + ((size_t)b * heads + (size_t)kvh * group) * HD;
  if (p >= kFreedPos) {
    for (int i = tid; i < group * HD; i += kThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const bf16* qb = q + ((size_t)b * heads + (size_t)kvh * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads) {
    sQ[i] = __bfloat162float(qb[i]) * scale;
    sO[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  const int n_pages =
      window ? min(nb, (window + kPS - 1) / kPS) : min(nb, p / kPS + 1);
  const size_t slot_stride = (size_t)kv_heads * HD;  // elements per slot
  const int32_t* trow = table + (size_t)b * nb;

  uint4 rk[T::kPerThread], rv[T::kPerThread];
  auto load = [&](int j) {
    int pid = trow[j];
    pid = pid < 0 ? 0 : (pid > n_pool - 1 ? n_pool - 1 : pid);
    const size_t base = ((size_t)pid * kPS * kv_heads + kvh) * HD;
#pragma unroll
    for (int t = 0; t < T::kPerThread; ++t) {
      const int i = tid + t * kThreads;
      if (i < T::kVecs) {
        const int s = i / T::kVecPerRow, c = i % T::kVecPerRow;
        const size_t off = base + s * slot_stride + (size_t)c * 8;
        rk[t] = *reinterpret_cast<const uint4*>(pool_k + off);
        rv[t] = *reinterpret_cast<const uint4*>(pool_v + off);
      }
    }
  };
  if (n_pages > 0) load(0);
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
#pragma unroll
    for (int t = 0; t < T::kPerThread; ++t) {
      const int i = tid + t * kThreads;
      if (i < T::kVecs) {
        reinterpret_cast<uint4*>(sK)[i] = rk[t];
        reinterpret_cast<uint4*>(sV)[i] = rv[t];
      }
    }
    __syncthreads();
    if (j + 1 < n_pages) load(j + 1);  // in flight during this page

    // scores: one warp per (query head, slot), lanes split hd
    for (int pr = warp; pr < group * kPS; pr += kWarps) {
      const int g = pr / kPS, s = pr % kPS;
      float acc = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32)
        acc += sQ[g * HD + d] * __bfloat162float(sK[s * HD + d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int slot = j * kPS + s;
        bool live;
        if (window) {
          const int kv_pos = p - ((p - slot) % window + window) % window;
          live = kv_pos >= 0 && kv_pos <= p && slot < window;
        } else {
          live = slot <= p;
        }
        sP[g * kPS + s] = live ? acc : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one thread per query head of the group
    for (int g = tid; g < group; g += kThreads) {
      const float m_prev = sM[g];
      float m_new = m_prev;
#pragma unroll
      for (int s = 0; s < kPS; ++s) m_new = fmaxf(m_new, sP[g * kPS + s]);
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kPS; ++s) {
        const float e = expf(sP[g * kPS + s] - m_new);
        sP[g * kPS + s] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      sL[g] = sL[g] * alpha + sum;
      sM[g] = m_new;
      sA[g] = alpha;
    }
    __syncthreads();

    // O = alpha * O + P V
    for (int i = tid; i < group * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float o = sO[i] * sA[g];
#pragma unroll
      for (int s = 0; s < kPS; ++s)
        o += sP[g * kPS + s] * __bfloat162float(sV[s * HD + d]);
      sO[i] = o;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * HD; i += kThreads)
    ob[i] = __float2bfloat16(sO[i] / fmaxf(sL[i / HD], 1e-30f));
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* table, const void* pos, void* out, int batch,
           int heads, int kv_heads, int n_pool, int nb, int window,
           float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  const size_t smem = sizeof(bf16) * 2 * kPS * HD +
                      sizeof(float) * (2 * group * HD + group * kPS + 3 * group);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<HD><<<batch * kv_heads, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool_k),
      static_cast<const bf16*>(pool_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<bf16*>(out), heads,
      kv_heads, n_pool, nb, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, hd), pool_k/pool_v (P, ps, KV, hd), out (B, H, hd): contiguous
// bf16; table (B, nb) and pos (B,): contiguous int32.  page_size must be
// 16; head_dim 256 is the 2b pair at full width, 32 its reduced configs.
// Returns 0 or the cudaError_t of the launch.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* pos, void* out, int batch, int heads, int kv_heads,
    int head_dim, int n_pool, int page_size, int nb, int window, float scale,
    cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || n_pool <= 0 ||
      nb <= 0 || page_size != kPS || window < 0 ||
      (window && nb * kPS < window))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return launch<32>(q, pool_k, pool_v, table, pos, out, batch, heads,
                        kv_heads, n_pool, nb, window, scale, stream);
    case 256:
      return launch<256>(q, pool_k, pool_v, table, pos, out, batch, heads,
                         kv_heads, n_pool, nb, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
