// One-token GQA decode attention over a paged KV pool, bf16 in/out.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::paged_decode_attention
// (_paged_kernel): q (B, H, hd), pools (P, ps, KV, hd), a per-row block
// table (B, nb) of page ids and per-row positions pos (B,) -> (B, H, hd).
// Query head h reads KV head h / (H / KV).  Slot j of a row lives at page
// table[b, j / ps], offset j % ps; a sentinel page id (NO_PAGE = 2**20)
// is clamped onto page P - 1 and masked by position.  Three modes:
//  * plain (window 0): masks slot > pos;
//  * ring (window > 0, ring = 1; table = the row's ring-local table):
//    maps slot i to the absolute position pos - (pos - i) mod window
//    and masks it unless 0 <= kv_pos <= pos and i < window;
//  * full-length window (window > 0, ring = 0; table = the row's whole
//    block table, slot j = position j): masks slots below
//    pos - window + 1 and above pos, and walks only the pages those
//    live slots touch, [max(0, pos - window + 1) / ps, pos / ps].
// Masked scores are NEG_INF = -2**30, as the reference, so once a live
// slot has been seen they weigh exactly 0.
//
// Bound on the H100: bytes.  A decode step reads each live slot's K and
// V once, ps * KV * hd * 2 bytes * 2 per page, against 2 * G multiply-
// adds per K/V element (G = H / KV query heads per KV head, 1 or 8
// here): about 8 LLM rows at 1,552 live slots is 203 MB, 61 us at
// 3.35 TB/s.
//
// Design: split-K over pages (flash-decoding), two launches.
//  1. split pass, grid (splits, B * KV), 4 warps a CTA.  CTA (s, b, kvh)
//     takes pages base + [s * pps, (s + 1) * pps) of row b, clipped to
//     the row's live pages (row_pages): base 0 and min(cover, pos / ps
//     + 1) pages, cover = nb, or the ring's ceil(window / ps) pages (a
//     ring row younger than its window holds live slots 0..pos only;
//     older, every slot < window); in full-length window mode base =
//     max(0, pos - window + 1) / ps and pos / ps - base + 1 pages, at
//     most cover = ceil((window - 1) / ps) + 1 (33 at window 512).  A
//     page past pos contributes exact zeros in the Pallas kernel, so
//     skipping it changes nothing; a CTA whose range lies wholly past
//     the live pages, or whose row is parked (pos >= FREED_POS = 2**30),
//     exits at once.  pps and the split count come from B, KV, nb and
//     the window alone (split_layout): about 8 x 132 CTAs, at least 2
//     pages each, never from pos or the table, so the launch is the
//     same at every step and never syncs.
//     Inside a split, warp w owns slots 4w .. 4w + 3 of every page and
//     keeps its own online softmax (m, l, O) over them: no CTA barrier in
//     the page loop.  Each warp streams its slots of K and V through a
//     private 4-page ring in shared memory by cp.async (16 bytes a
//     lane, three pages in flight while one is reduced) and needs only
//     __syncwarp.  A lane owns hd / 32 elements of d: the 4 G partial
//     scores of a page are reduce-scattered over the warp (31 shuffles
//     at G = 8) and broadcast back (32 more); every lane
//     then updates (m, l) of the G heads the same way and its slice of
//     O (f32 SIMT: at <= 16 flops per byte the bytes set the pace).  At
//     the end the four warps' states are merged in warp order through
//     shared memory and the split writes its partial (m, l) and
//     unnormalised O per query head, f32, to scratch the wrapper
//     allocates.
//  2. combine pass, grid (B * KV, G), 256 threads: over the live
//     splits, w_s = exp(m_s - m_row), l = sum w_s l_s in split order, o =
//     sum w_s O_s (threads take every 8th split at hd 256, every 64th at
//     hd 32, and their sums are added in thread order); out = o / l in
//     bf16, zeros for a parked row.  Splits past the live pages
//     are not read, so an empty split weighs exactly 0; a split whose
//     slots all exist but are masked (m_s = NEG_INF) weighs
//     exp(-2**30 - m_row) = 0 against a live row maximum.  Fixed orders
//     and no atomics: a run repeats bit for bit.
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
constexpr int kSlotsPerWarp = kPS / kWarps;
constexpr int kStages = 4;                // pages in a warp's ring
constexpr int kSMs = 132;
constexpr int kMinPages = 2;              // pages per split, at least
constexpr int kMaxDevices = 64;

// The pages the row's live slots touch: from page `base` of its table,
// `n` of them (0 when the row is parked).  Full-length window mode
// (window > 0, ring 0) starts at the page of pos - window + 1.
struct RowPages {
  int base, n;
};
__device__ __forceinline__ RowPages row_pages(int p, int cover, int window,
                                              int ring) {
  if (p >= kFreedPos) return {0, 0};
  if (window && !ring) {
    const int base = max(0, p - window + 1) / kPS;
    return {base, min(cover, p / kPS - base + 1)};
  }
  return {0, min(cover, p / kPS + 1)};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// lane's hd / 32 consecutive elements of a bf16 row at `row`, as f32
template <int DPL>
__device__ __forceinline__ void load_slice(const bf16* row, float v[DPL]) {
  if constexpr (DPL == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) v[i] = __bfloat162float(row[i]);
  }
}

// v[0 .. N) hold this lane's partial sums of N values (N a power of two
// <= 32); leaves in v[0] the full sum over the warp of value lane >> (5 -
// log2 N).  Each exchange at distance O halves the values while N > 1;
// the remaining distances add the rest of the warp.  Every lane of a
// group ends with the same bits (a + b == b + a).
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float lo = v[i], hi = v[i + N / 2];
        const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
        v[i] = __fadd_rn(up ? hi : lo, got);
      }
      reduce_scatter<N / 2, O / 2>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

template <int N>
constexpr int log2i() {
  if constexpr (N <= 1)
    return 0;
  else
    return 1 + log2i<N / 2>();
}

template <int HD, int G>
struct Split {
  static constexpr int kDPL = HD / 32;                    // d per lane
  static constexpr int kVecRow = HD / 8;                  // 16-byte units
  static constexpr int kVecs = 2 * kSlotsPerWarp * kVecRow;  // K and V
  static constexpr int kPerLane = (kVecs + 31) / 32;
  static constexpr int kStage = 2 * kSlotsPerWarp * HD;   // bf16 a stage
  static constexpr int kV = G * kSlotsPerWarp;            // scores a page
  static constexpr int kShift = 5 - log2i<kV>();
  // ring: kWarps x kStages stages; merge area reuses it after the loop
  static constexpr size_t kRingBytes =
      sizeof(bf16) * kWarps * kStages * kStage;
  static constexpr size_t kMergeBytes =
      sizeof(float) * kWarps * G * (HD + 2);
  static constexpr size_t kSmem =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

template <int HD, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const bf16* __restrict__ q, const bf16* __restrict__ pool_k,
    const bf16* __restrict__ pool_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ pos, float* __restrict__ part_o,
    float2* __restrict__ part_ml, int kv_heads, int n_pool, int nb,
    int cover, int pps, int window, int ring_table, float scale) {
  using S = Split<HD, G>;
  constexpr int DPL = S::kDPL;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bk = blockIdx.y;                       // b * KV + kvh
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const int p = pos[b];
  const RowPages rp = row_pages(p, cover, window, ring_table);
  const int page_lo = rp.base + split * pps;
  const int page_hi = min(page_lo + pps, rp.base + rp.n);
  if (page_lo >= page_hi) return;                  // empty or parked
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * DPL;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * kStages * S::kStage;

  float qv[G][DPL];
  {
    const bf16* qb = q + (static_cast<size_t>(b) * kv_heads * G +
                          static_cast<size_t>(kvh) * G) * HD;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_slice<DPL>(qb + g * HD + d0, qv[g]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[g][i] *= scale;
    }
  }
  float m[G], l[G], o[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[g][i] = 0.f;
  }

  const size_t slot_stride = static_cast<size_t>(kv_heads) * HD;
  const int32_t* trow = table + static_cast<size_t>(b) * nb;
  const int n = page_hi - page_lo;
  // this warp's slots 4w .. 4w + 3 of page j, K then V, into stage st
  auto fetch = [&](int j, int st) {
    int pid = trow[page_lo + j];
    pid = pid < 0 ? 0 : (pid > n_pool - 1 ? n_pool - 1 : pid);
    const size_t base =
        (static_cast<size_t>(pid) * kPS + warp * kSlotsPerWarp) *
            slot_stride +
        static_cast<size_t>(kvh) * HD;
    bf16* dst = ring + st * S::kStage;
#pragma unroll
    for (int t = 0; t < S::kPerLane; ++t) {
      const int i = lane + 32 * t;
      if (i < S::kVecs) {
        const int tensor = i / (kSlotsPerWarp * S::kVecRow);
        const int r = i % (kSlotsPerWarp * S::kVecRow);
        const int s = r / S::kVecRow, c = r % S::kVecRow;
        const bf16* src = (tensor ? pool_v : pool_k) + base +
                          s * slot_stride + c * 8;
        cp_async16(dst + tensor * kSlotsPerWarp * HD + s * HD + c * 8, src);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n) fetch(t, t);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    __syncwarp();                       // stage (j - 1) % kStages is read
    if (j + kStages - 1 < n)
      fetch(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // page j has landed
    __syncwarp();
    const bf16* sk = ring + (j % kStages) * S::kStage;
    const bf16* sv = sk + kSlotsPerWarp * HD;

    // partial scores over this lane's d, value index g * 4 + s
    float sc[S::kV];
#pragma unroll
    for (int s = 0; s < kSlotsPerWarp; ++s) {
      float kv[DPL];
      load_slice<DPL>(sk + s * HD + d0, kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc = __fmaf_rn(qv[g][i], kv[i], acc);
        sc[g * kSlotsPerWarp + s] = acc;
      }
    }
    reduce_scatter<S::kV, 16>(sc, lane);
    const float mine = sc[0];
#pragma unroll
    for (int v = 0; v < S::kV; ++v)
      sc[v] = __shfl_sync(0xffffffffu, mine, v << S::kShift);

    // masks and the online softmax, the same in every lane; sc becomes
    // the page's probabilities
    const int slot0 = (page_lo + j) * kPS + warp * kSlotsPerWarp;
    bool live[kSlotsPerWarp];
#pragma unroll
    for (int s = 0; s < kSlotsPerWarp; ++s) {
      const int slot = slot0 + s;
      if (window && ring_table) {
        const int kv_pos = p - ((p - slot) % window + window) % window;
        live[s] = kv_pos >= 0 && kv_pos <= p && slot < window;
      } else if (window) {
        live[s] = slot <= p && slot > p - window;
      } else {
        live[s] = slot <= p;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* x = sc + g * kSlotsPerWarp;
      float m_new = m[g];
#pragma unroll
      for (int s = 0; s < kSlotsPerWarp; ++s) {
        x[s] = live[s] ? x[s] : kNegInf;
        m_new = fmaxf(m_new, x[s]);
      }
      const float alpha = expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kSlotsPerWarp; ++s) {
        x[s] = expf(x[s] - m_new);
        sum += x[s];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[g][i] *= alpha;
    }
    // O += P V, slot by slot
#pragma unroll
    for (int s = 0; s < kSlotsPerWarp; ++s) {
      float vv[DPL];
      load_slice<DPL>(sv + s * HD + d0, vv);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          o[g][i] = __fmaf_rn(sc[g * kSlotsPerWarp + s], vv[i], o[g][i]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // every ring is done: reuse it

  // merge the four warps' states in warp order
  float* mo = reinterpret_cast<float*>(smem);      // [kWarps][G][HD]
  float* mml = mo + kWarps * G * HD;               // [kWarps][G][2]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) mo[(warp * G + g) * HD + d0 + i] = o[g][i];
    if (lane == 0) {
      mml[(warp * G + g) * 2] = m[g];
      mml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  const size_t out_row = (static_cast<size_t>(bk) * n_splits + split) * G;
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mml[(w * G + g) * 2]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(mml[(w * G + g) * 2] - mx);
      acc = __fmaf_rn(c, mo[(w * G + g) * HD + d], acc);
      lsum = __fmaf_rn(c, mml[(w * G + g) * 2 + 1], lsum);
    }
    part_o[(out_row + g) * HD + d] = acc;
    if (d == 0) part_ml[out_row + g] = make_float2(mx, lsum);
  }
}

// grid (B * KV, G), kCombineThreads: out[b, kvh * G + g, :].  The
// live splits' maxima and weights w_s = exp(m_s - m_row) are staged in
// shared memory; thread (lane of splits sl, 8 elements of d) then sums
// w_s O_s over splits sl, sl + kSL, ... (its loads all independent), and
// the kSL sums are added in order of sl.
constexpr int kCombineThreads = 256;

template <int HD>
__global__ void __launch_bounds__(kCombineThreads) paged_decode_combine(
    const float* __restrict__ part_o, const float2* __restrict__ part_ml,
    const int32_t* __restrict__ pos, bf16* __restrict__ out, int kv_heads,
    int n_splits, int cover, int pps, int window, int ring) {
  constexpr int kDL = HD / 8;                      // 8 elements of d each
  constexpr int kSL = kCombineThreads / kDL;       // lanes of splits
  extern __shared__ __align__(16) float cs[];
  float* red = cs;                                 // [kSL][HD]
  float* sm = red + kSL * HD;                      // [n_splits] m_s
  float* sw = sm + n_splits;                       // [n_splits] w_s
  float* sl_ = sw + n_splits;                      // [n_splits] l_s
  const int bk = blockIdx.x, g = blockIdx.y, G = gridDim.y;
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const int tid = threadIdx.x;
  bf16* ob = out + ((static_cast<size_t>(b) * kv_heads + kvh) * G + g) * HD;
  const int live = (row_pages(pos[b], cover, window, ring).n + pps - 1) / pps;
  if (live == 0) {                      // parked: zeros, no page read
    for (int d = tid; d < HD; d += kCombineThreads)
      ob[d] = __float2bfloat16(0.f);
    return;
  }
  const size_t row = static_cast<size_t>(bk) * n_splits * G + g;
  for (int s = tid; s < live; s += kCombineThreads) {
    const float2 ml = part_ml[row + s * G];
    sm[s] = ml.x;
    sl_[s] = ml.y;
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, sm[s]);
  for (int s = tid; s < live; s += kCombineThreads) sw[s] = expf(sm[s] - mx);
  __syncthreads();
  const int sl = tid / kDL, d0 = (tid % kDL) * 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int s = sl; s < live; s += kSL) {
    const float w = sw[s];
    const float* po = part_o + (row + s * G) * HD + d0;
    const float4 lo = *reinterpret_cast<const float4*>(po);
    const float4 hi = *reinterpret_cast<const float4*>(po + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = __fmaf_rn(w, v[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[sl * HD + d0 + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < HD; d += kCombineThreads) {
    float o = 0.f, lsum = 0.f;
    for (int i = 0; i < kSL; ++i) o = __fadd_rn(o, red[i * HD + d]);
    for (int s = 0; s < live; ++s) lsum = __fmaf_rn(sw[s], sl_[s], lsum);
    ob[d] = __float2bfloat16(o / fmaxf(lsum, 1e-30f));
  }
}

// Pages each row covers, pages per split and the split count, from the
// static shapes alone: about 8 CTAs per SM over all (row, KV head)
// pairs, at least kMinPages pages a split.  A full-length window of w
// slots touches at most ceil((w - 1) / ps) + 1 pages of the table.
void split_layout(int batch, int kv_heads, int nb, int window, int ring,
                  int* cover, int* pps, int* splits) {
  if (!window)
    *cover = nb;
  else if (ring)
    *cover = (window + kPS - 1) / kPS;
  else
    *cover = min(nb, (window + kPS - 2) / kPS + 1);
  const int pairs = batch * kv_heads;
  const int want = (8 * kSMs + pairs - 1) / pairs;
  *pps = max(kMinPages, (*cover + want - 1) / want);
  *splits = (*cover + *pps - 1) / *pps;
}

template <int HD, int G>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* table, const void* pos, void* scratch, void* out,
           int batch, int kv_heads, int n_pool, int nb, int window, int ring,
           float scale, cudaStream_t stream) {
  using S = Split<HD, G>;
  int cover, pps, splits;
  split_layout(batch, kv_heads, nb, window, ring, &cover, &pps, &splits);
  const size_t rows = static_cast<size_t>(batch) * kv_heads * splits * G;
  float* part_o = static_cast<float*>(scratch);
  float2* part_ml = reinterpret_cast<float2*>(part_o + rows * HD);
  // the shared-memory attribute once per device (a call on the host
  // costs about as much as the launch)
  static bool attr_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !attr_set[device]) {
    err = cudaFuncSetAttribute(paged_decode_split<HD, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) attr_set[device] = true;
  }
  paged_decode_split<HD, G>
      <<<dim3(splits, batch * kv_heads), kThreads, S::kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(pool_k),
          static_cast<const bf16*>(pool_v),
          static_cast<const int32_t*>(table),
          static_cast<const int32_t*>(pos), part_o, part_ml, kv_heads, n_pool,
          nb, cover, pps, window, ring, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t combine_smem =
      sizeof(float) * (kCombineThreads / (HD / 8) * HD + 3 * splits);
  paged_decode_combine<HD>
      <<<dim3(batch * kv_heads, G), kCombineThreads, combine_smem, stream>>>(
          part_o, part_ml, static_cast<const int32_t*>(pos),
          static_cast<bf16*>(out), kv_heads, splits, cover, pps, window,
          ring);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int group, const void* q, const void* pool_k,
              const void* pool_v, const void* table, const void* pos,
              void* scratch, void* out, int batch, int kv_heads, int n_pool,
              int nb, int window, int ring, float scale,
              cudaStream_t stream) {
  switch (group) {
    case 1:
      return launch<HD, 1>(q, pool_k, pool_v, table, pos, scratch, out, batch,
                           kv_heads, n_pool, nb, window, ring, scale, stream);
    case 2:
      return launch<HD, 2>(q, pool_k, pool_v, table, pos, scratch, out, batch,
                           kv_heads, n_pool, nb, window, ring, scale, stream);
    case 4:
      return launch<HD, 4>(q, pool_k, pool_v, table, pos, scratch, out, batch,
                           kv_heads, n_pool, nb, window, ring, scale, stream);
    case 8:
      return launch<HD, 8>(q, pool_k, pool_v, table, pos, scratch, out, batch,
                           kv_heads, n_pool, nb, window, ring, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Splits of the split pass for these static shapes (the wrapper sizes
// its scratch from it): f32 scratch of splits * B * H * (hd + 2) floats.
extern "C" int paged_decode_splits(int batch, int kv_heads, int nb,
                                   int window, int ring) {
  int cover, pps, splits;
  split_layout(batch, kv_heads, nb, window, ring, &cover, &pps, &splits);
  return splits;
}

// q (B, H, hd), pool_k/pool_v (P, ps, KV, hd), out (B, H, hd): contiguous
// bf16; table (B, nb) and pos (B,): contiguous int32; scratch: f32,
// 16-byte aligned, paged_decode_splits(...) * B * H * (hd + 2) floats.
// page_size must be 16, H / KV one of 1, 2, 4, 8; head_dim 256 is the 2b
// pair at full width, 32 its reduced configs.  window > 0 with ring 1
// reads a ring-local table, with ring 0 a full-length block table.
// Returns 0 or the cudaError_t of the launch.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* pos, void* scratch, void* out, int batch, int heads,
    int kv_heads, int head_dim, int n_pool, int page_size, int nb,
    int window, int ring, float scale, cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || n_pool <= 0 ||
      nb <= 0 || page_size != kPS || window < 0 ||
      (window && ring && nb * kPS < window))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / kv_heads;
  switch (head_dim) {
    case 32:
      return launch_hd<32>(group, q, pool_k, pool_v, table, pos, scratch,
                           out, batch, kv_heads, n_pool, nb, window, ring,
                           scale, stream);
    case 256:
      return launch_hd<256>(group, q, pool_k, pool_v, table, pos, scratch,
                            out, batch, kv_heads, n_pool, nb, window, ring,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
