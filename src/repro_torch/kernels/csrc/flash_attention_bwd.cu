// K8: the backward of causal GQA attention (dQ, dK, dV), bf16 in/out,
// written for Hopper (sm_90a) with WMMA bf16 tensor-core tiles.
//
// Replaces no Pallas kernel: the reference trains through
// jax.value_and_grad of chunked_causal_attention
// (src/repro/models/attention.py:82), a jnp function, and none of its
// Pallas kernels has a VJP.  The port's forward of a client step runs
// K3 (csrc/flash_attention.cu), which writes each row's log-sum-exp
// (natural log, f32, (B, H, S)) through its optional LSE pointer; this
// kernel takes q, k, v, the forward output o, dO and that LSE:
//   P  = exp(q k^T * scale - lse)      (recomputed, masked causally)
//   dV = sum over the group's heads of P^T dO
//   dP = dO v^T,  D_i = sum_d dO_i o_i,  dS = P * (dP - D_i)
//   dQ = dS k * scale,  dK = sum over the group's heads of dS^T q * scale
// q (B, H, S, D), k/v (B, KVH, S, D), query head h reading KV head
// h / (H / KVH).  The mask is K3's: key k_pos visible from query q_pos
// iff k_pos <= q_pos (causal) and, with a window w > 0, k_pos > q_pos - w
// (the reference's chunked_causal_attention, models/attention.py:82-120,
// which gemma3's sliding-window layers train through).
//
// Bound on the H100: the least work is 10 * D products-and-adds per
// visible (query, key, head) pair, bf16 on the tensor cores; at B = 1,
// H = 8, KVH = 1, S = 2048, D = 256 that is about 43 GFLOP (44 us at the
// 989 TFLOP/s dense peak) against about 42 MB of q/k/v/o/dO/dq/dk/dv
// traffic (13 us at 3.35 TB/s): bound by operations.  At a client step
// (B = 4, S = 40) it is bound by launch latency.  With a window only the
// visible pairs count: S * w - w (w - 1) / 2 of them a head past the
// window, so gemma3's window of 512 at S = 2,048 needs 44% of the causal
// work.
//
// Design (simple first; wgmma and TMA are later work):
//  - Three or four launches on the caller's stream: D_i = rowsum(dO * o)
//    (one warp a row); dK/dV with one CTA per (b, KV head, 32-key tile,
//    part of the group's heads) that loops over its heads and the query
//    tiles of 64 rows that can see its keys (with a window, only the
//    tiles that reach back to them), accumulating dK and dV in
//    WMMA fragments (registers); when the heads are split over several
//    CTAs (so that about two CTAs an SM run: at B = 1, S = 2,048 the
//    64 key tiles alone would leave half the card idle), each writes
//    its f32 part and a fourth launch adds the parts in order; dQ with
//    one CTA per (b, head, 64-row query tile) that loops over the key
//    tiles from the window's edge to the causal edge.  Tiles wholly
//    outside the window are skipped, not masked, as K3 skips them; the
//    diagonal and window-edge tiles apply the element mask.  Every sum
//    runs in a fixed order: no atomics, and two calls on the same
//    inputs return the same bits.
//  - Tiles are staged in shared memory with plain 16-byte loads (rows
//    past S zero-filled), rows padded by 8 bf16 against bank conflicts:
//    q, dO (64 x D), k, v (32 x D), the 64 x 32 S and dP in f32 and P
//    and dS in bf16, 130,560 B at D = 256.  At zamba2's D = 112 (7 x 16,
//    whole WMMA tiles) a padded row is 120 bf16 = 240 B, a multiple of
//    16, and the tiles take 75,264 B.  Its shared block is multi-head
//    (H = KVH = 32, a group of one), so head_splits leaves the dK/dV
//    pass unsplit: B x 32 x ceil(S / 32) CTAs, 1,536 at S = 1,536 and
//    256 at a client step (4 x 40), enough to fill 132 SMs without parts.  S = q k^T and dP = dO v^T
//    are 16 x 16 x 16 WMMA products with f32 accumulators; P and dS are
//    rounded to bf16 as the A operand of the next products, as a flash
//    backward rounds them.
//  - The final dK * scale, dV and dQ * scale go through an f32 staging
//    tile in the q/dO region to bf16 and are written with the outputs'
//    strides: q, k, v, o, dO and the outputs may be strided views, as
//    the model hands K3 (B, H, S, D) views of (B, S, H, D) projections.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;   // query rows a tile
constexpr int kBK = 32;   // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

struct Str {
  long long b, h, s;  // element strides over batch, head, position
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, S) natural log
  float* di;         // (B, H, S) scratch: D_i
  float* parts;      // (splits, 2, B, KVH, S, D) f32 scratch when split
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, seq, causal, window, splits;
  float scale;
};

// CTAs of the dK/dV pass a wave should hold; the heads of a group are
// split until the pass has about this many.
constexpr int kTargetCtas = 264;

// Head splits of the dK/dV pass: the largest count up to the group size
// that keeps the pass near kTargetCtas.
int head_splits(int batch, int heads, int kv_heads, int seq) {
  const int group = heads / kv_heads;
  const long long tiles =
      static_cast<long long>(batch) * kv_heads * ((seq + kBK - 1) / kBK);
  long long s = (kTargetCtas + tiles - 1) / tiles;
  return static_cast<int>(s < 1 ? 1 : (s > group ? group : s));
}

template <int D>
struct Cfg {
  static constexpr int kLd = D + 8;     // bf16 pitch of a D-wide tile
  static constexpr int kLdP = kBK + 8;  // bf16 pitch of a 64 x 32 tile
  static constexpr int kLdF = kBK + 4;  // f32 pitch of a 64 x 32 tile
  static constexpr int kLdO = D + 4;    // f32 pitch of the staging tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kBQ * kLd * 2;
  static constexpr int kK = kDO + kBQ * kLd * 2;
  static constexpr int kV = kK + kBK * kLd * 2;
  static constexpr int kS = kV + kBK * kLd * 2;
  static constexpr int kDP = kS + kBQ * kLdF * 4;
  static constexpr int kP = kDP + kBQ * kLdF * 4;
  static constexpr int kDS = kP + kBQ * kLdP * 2;
  static constexpr int kLse = kDS + kBQ * kLdP * 2;
  static constexpr int kDi = kLse + kBQ * 4;
  static constexpr int kBytes = kDi + kBQ * 4;
  // output fragments a warp owns: dK and dV (32 x D), dQ (64 x D)
  static constexpr int kFragKV = (kBK / 16) * (D / 16);
  static constexpr int kFragQ = (kBQ / 16) * (D / 16);
  static constexpr int kPerWarpKV = (kFragKV + kWarps - 1) / kWarps;
  static constexpr int kPerWarpQ = (kFragQ + kWarps - 1) / kWarps;
  static_assert(D % 16 == 0, "head_dim");
  static_assert(2 * kBK * kLdO * 4 <= 2 * kBQ * kLd * 2, "dK/dV staging");
  static_assert(kBQ * kLdO * 4 <= 2 * kBQ * kLd * 2, "dQ staging");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ long long at(Str st, int b, int h, int s) {
  return b * st.b + h * st.h + static_cast<long long>(s) * st.s;
}

// Rows [r0, r0 + R) of (b, h) into a shared tile of pitch kLd, rows at or
// past seq zero-filled.
template <int D, int R>
__device__ void load_tile(bf16* dst, const bf16* src, Str st, int b, int h,
                          int r0, int seq) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < R * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + at(st, b, h, r0 + r) + c);
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::kLd + c) = val;
  }
}

// C (64 x 32 f32, pitch kLdF) = A (64 x D) B^T with B (32 x D): one
// 16 x 16 fragment a warp.
template <int D>
__device__ void product_nt(float* c, const bf16* a, const bf16* bm) {
  constexpr int kLd = Cfg<D>::kLd;
  const int w = threadIdx.x / 32;
  const int rb = w / (kBK / 16), cb = w % (kBK / 16);
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    FragBT fb;
    wmma::load_matrix_sync(fa, a + rb * 16 * kLd + kk, kLd);
    wmma::load_matrix_sync(fb, bm + cb * 16 * kLd + kk, kLd);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(c + rb * 16 * Cfg<D>::kLdF + cb * 16, acc,
                          Cfg<D>::kLdF, wmma::mem_row_major);
}

// P and dS of one (64 query, 32 key) tile from S and dP in shared memory:
// query rows q0.., keys k0..; rows or keys at or past seq, keys past the
// causal edge and keys at or before q_pos - window give exact zeros.
template <int D>
__device__ void softmax_grad_tile(unsigned char* sm, int q0, int k0, int seq,
                                  int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  const float* s = reinterpret_cast<const float*>(sm + C::kS);
  const float* dp = reinterpret_cast<const float*>(sm + C::kDP);
  const float* lse = reinterpret_cast<const float*>(sm + C::kLse);
  const float* di = reinterpret_cast<const float*>(sm + C::kDi);
  bf16* p = reinterpret_cast<bf16*>(sm + C::kP);
  bf16* ds = reinterpret_cast<bf16*>(sm + C::kDS);
  for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
    const int j = e / kBK, i = e % kBK;
    const int qp = q0 + j, kp = k0 + i;
    const bool ok = qp < seq && kp < seq && (!causal || kp <= qp) &&
                    (window <= 0 || kp > qp - window);
    const float pv = ok ? exp2f(s[j * C::kLdF + i] * scale_log2 - lse[j]) : 0.f;
    const float dsv = pv * (dp[j * C::kLdF + i] - di[j]);
    p[j * C::kLdP + i] = __float2bfloat16(pv);
    ds[j * C::kLdP + i] = __float2bfloat16(dsv);
  }
}

// The 64 rows' LSE (in log2 units) and D_i from q0 on, zeros past seq.
__device__ void load_row_stats(float* lse_s, float* di_s, const Args& a,
                               int b, int h, int q0) {
  for (int j = threadIdx.x; j < kBQ; j += kThreads) {
    const int qp = q0 + j;
    const long long r =
        (static_cast<long long>(b) * a.heads + h) * a.seq + qp;
    lse_s[j] = qp < a.seq ? a.lse[r] * kLog2e : 0.f;
    di_s[j] = qp < a.seq ? a.di[r] : 0.f;
  }
}

// D_i = sum_d dO[i, d] * o[i, d] in f32: one warp a row.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rowdot(Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.batch) * a.heads * a.seq) return;
  const int s = static_cast<int>(row % a.seq);
  const int h = static_cast<int>((row / a.seq) % a.heads);
  const int b = static_cast<int>(row / (static_cast<long long>(a.seq) * a.heads));
  const bf16* po = a.o + at(a.so, b, h, s);
  const bf16* pd = a.dout + at(a.sdo, b, h, s);
  float acc = 0.f;
  for (int d = lane * 8; d < D; d += 32 * 8) {
    const uint4 vo = *reinterpret_cast<const uint4*>(po + d);
    const uint4 vd = *reinterpret_cast<const uint4*>(pd + d);
    const bf16* eo = reinterpret_cast<const bf16*>(&vo);
    const bf16* ed = reinterpret_cast<const bf16*>(&vd);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc += __bfloat162float(eo[i]) * __bfloat162float(ed[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.di[row] = acc;
}

// dK and dV of one 32-key tile of (b, KV head), summed over the group's
// heads and the query tiles that see the keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv(Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* qs = reinterpret_cast<bf16*>(sm + C::kQ);
  bf16* dos = reinterpret_cast<bf16*>(sm + C::kDO);
  bf16* ks = reinterpret_cast<bf16*>(sm + C::kK);
  bf16* vs = reinterpret_cast<bf16*>(sm + C::kV);
  float* sf = reinterpret_cast<float*>(sm + C::kS);
  float* dpf = reinterpret_cast<float*>(sm + C::kDP);
  const bf16* pb = reinterpret_cast<const bf16*>(sm + C::kP);
  const bf16* dsb = reinterpret_cast<const bf16*>(sm + C::kDS);
  float* lse_s = reinterpret_cast<float*>(sm + C::kLse);
  float* di_s = reinterpret_cast<float*>(sm + C::kDi);

  const int n_kt = (a.seq + kBK - 1) / kBK;
  const int part = blockIdx.x % a.splits;
  const int tile = blockIdx.x / a.splits;
  const int kt = tile % n_kt;
  const int kvh = (tile / n_kt) % a.kv_heads;
  const int b = tile / (n_kt * a.kv_heads);
  const int k0 = kt * kBK;
  const int group = a.heads / a.kv_heads;
  const int g_begin = part * group / a.splits;
  const int g_end = (part + 1) * group / a.splits;
  const float scale_log2 = a.scale * kLog2e;
  const int w = threadIdx.x / 32;

  load_tile<D, kBK>(ks, a.k, a.sk, b, kvh, k0, a.seq);
  load_tile<D, kBK>(vs, a.v, a.sv, b, kvh, k0, a.seq);

  FragC dk[C::kPerWarpKV], dv[C::kPerWarpKV];
#pragma unroll
  for (int f = 0; f < C::kPerWarpKV; ++f) {
    wmma::fill_fragment(dk[f], 0.f);
    wmma::fill_fragment(dv[f], 0.f);
  }
  // query tiles that can see a key of [k0, k0 + kBK): from the causal
  // edge to the last query within the window of the tile's last key
  const int qt_begin = a.causal ? k0 / kBQ : 0;
  const int n_qt = (a.seq + kBQ - 1) / kBQ;
  const int qt_end =
      a.window > 0 ? min(n_qt, (k0 + kBK - 1 + a.window - 1) / kBQ + 1)
                   : n_qt;
  for (int g = g_begin; g < g_end; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      load_tile<D, kBQ>(qs, a.q, a.sq, b, h, q0, a.seq);
      load_tile<D, kBQ>(dos, a.dout, a.sdo, b, h, q0, a.seq);
      load_row_stats(lse_s, di_s, a, b, h, q0);
      __syncthreads();
      product_nt<D>(sf, qs, ks);    // S = q k^T
      product_nt<D>(dpf, dos, vs);  // dP = dO v^T
      __syncthreads();
      softmax_grad_tile<D>(sm, q0, k0, a.seq, a.causal, a.window,
                           scale_log2);
      __syncthreads();
      // dV += P^T dO and dK += dS^T q: A is the transpose of a row-major
      // 64 x 32 tile (col-major), B a row-major 64 x D tile
#pragma unroll
      for (int f = 0; f < C::kPerWarpKV; ++f) {
        const int frag = w + kWarps * f;
        if (frag < C::kFragKV) {
          const int mb = frag / (D / 16), nb = frag % (D / 16);
#pragma unroll
          for (int kb = 0; kb < kBQ / 16; ++kb) {
            FragAT fa;
            FragB fb;
            wmma::load_matrix_sync(fa, pb + kb * 16 * C::kLdP + mb * 16,
                                   C::kLdP);
            wmma::load_matrix_sync(fb, dos + kb * 16 * C::kLd + nb * 16,
                                   C::kLd);
            wmma::mma_sync(dv[f], fa, fb, dv[f]);
            wmma::load_matrix_sync(fa, dsb + kb * 16 * C::kLdP + mb * 16,
                                   C::kLdP);
            wmma::load_matrix_sync(fb, qs + kb * 16 * C::kLd + nb * 16,
                                   C::kLd);
            wmma::mma_sync(dk[f], fa, fb, dk[f]);
          }
        }
      }
      __syncthreads();
    }
  }
  // stage dK * scale and dV in f32 over the q/dO region, then write bf16
  float* stk = reinterpret_cast<float*>(sm + C::kQ);
  float* stv = stk + kBK * C::kLdO;
#pragma unroll
  for (int f = 0; f < C::kPerWarpKV; ++f) {
    const int frag = w + kWarps * f;
    if (frag < C::kFragKV) {
      const int mb = frag / (D / 16), nb = frag % (D / 16);
#pragma unroll
      for (int t = 0; t < dk[f].num_elements; ++t) dk[f].x[t] *= a.scale;
      wmma::store_matrix_sync(stk + mb * 16 * C::kLdO + nb * 16, dk[f],
                              C::kLdO, wmma::mem_row_major);
      wmma::store_matrix_sync(stv + mb * 16 * C::kLdO + nb * 16, dv[f],
                              C::kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (a.splits > 1) {
    // this part's f32 dK and dV, added in order by attn_bwd_sum
    const long long plane =
        static_cast<long long>(a.batch) * a.kv_heads * a.seq * D;
    const long long row0 =
        ((static_cast<long long>(b) * a.kv_heads + kvh) * a.seq + k0) * D;
    float* pk = a.parts + 2 * part * plane + row0;
    float* pv = pk + plane;
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      if (k0 + r >= a.seq) continue;
      pk[static_cast<long long>(r) * D + c] = stk[r * C::kLdO + c];
      pv[static_cast<long long>(r) * D + c] = stv[r * C::kLdO + c];
    }
    return;
  }
  for (int e = threadIdx.x; e < kBK * (D / 2); e += kThreads) {
    const int r = e / (D / 2), c = (e % (D / 2)) * 2;
    if (k0 + r >= a.seq) continue;
    const __nv_bfloat162 vk = __floats2bfloat162_rn(
        stk[r * C::kLdO + c], stk[r * C::kLdO + c + 1]);
    const __nv_bfloat162 vv = __floats2bfloat162_rn(
        stv[r * C::kLdO + c], stv[r * C::kLdO + c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(a.dk + at(a.sdk, b, kvh, k0 + r) + c) =
        vk;
    *reinterpret_cast<__nv_bfloat162*>(a.dv + at(a.sdv, b, kvh, k0 + r) + c) =
        vv;
  }
}

// dK and dV from the dK/dV pass's f32 parts, added in split order, to
// bf16 with the outputs' strides: one thread a pair of elements.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_sum(Args a) {
  const long long plane =
      static_cast<long long>(a.batch) * a.kv_heads * a.seq * D;
  const long long e = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * 2;
  if (e >= plane) return;
  float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
  for (int p = 0; p < a.splits; ++p) {
    const float* pk = a.parts + 2 * p * plane + e;
    k0 += pk[0];
    k1 += pk[1];
    v0 += pk[plane];
    v1 += pk[plane + 1];
  }
  const int c = static_cast<int>(e % D);
  const long long row = e / D;
  const int s = static_cast<int>(row % a.seq);
  const int kvh = static_cast<int>((row / a.seq) % a.kv_heads);
  const int b = static_cast<int>(row / (static_cast<long long>(a.seq) *
                                        a.kv_heads));
  *reinterpret_cast<__nv_bfloat162*>(a.dk + at(a.sdk, b, kvh, s) + c) =
      __floats2bfloat162_rn(k0, k1);
  *reinterpret_cast<__nv_bfloat162*>(a.dv + at(a.sdv, b, kvh, s) + c) =
      __floats2bfloat162_rn(v0, v1);
}

// dQ of one 64-row query tile of (b, head), over the key tiles up to the
// causal edge.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq(Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* qs = reinterpret_cast<bf16*>(sm + C::kQ);
  bf16* dos = reinterpret_cast<bf16*>(sm + C::kDO);
  bf16* ks = reinterpret_cast<bf16*>(sm + C::kK);
  bf16* vs = reinterpret_cast<bf16*>(sm + C::kV);
  float* sf = reinterpret_cast<float*>(sm + C::kS);
  float* dpf = reinterpret_cast<float*>(sm + C::kDP);
  const bf16* dsb = reinterpret_cast<const bf16*>(sm + C::kDS);
  float* lse_s = reinterpret_cast<float*>(sm + C::kLse);
  float* di_s = reinterpret_cast<float*>(sm + C::kDi);

  const int n_qt = (a.seq + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % a.heads;
  const int b = blockIdx.x / (n_qt * a.heads);
  const int kvh = h / (a.heads / a.kv_heads);
  const int q0 = qt * kBQ;
  const float scale_log2 = a.scale * kLog2e;
  const int w = threadIdx.x / 32;

  load_tile<D, kBQ>(qs, a.q, a.sq, b, h, q0, a.seq);
  load_tile<D, kBQ>(dos, a.dout, a.sdo, b, h, q0, a.seq);
  load_row_stats(lse_s, di_s, a, b, h, q0);

  FragC dq[C::kPerWarpQ];
#pragma unroll
  for (int f = 0; f < C::kPerWarpQ; ++f) wmma::fill_fragment(dq[f], 0.f);
  // key tiles any row of the tile sees: from the window's edge of its
  // first row to the causal edge of its last
  const int kv_end = a.causal ? min(a.seq, q0 + kBQ) : a.seq;
  const int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBK * kBK
                                    : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    load_tile<D, kBK>(ks, a.k, a.sk, b, kvh, k0, a.seq);
    load_tile<D, kBK>(vs, a.v, a.sv, b, kvh, k0, a.seq);
    __syncthreads();
    product_nt<D>(sf, qs, ks);
    product_nt<D>(dpf, dos, vs);
    __syncthreads();
    softmax_grad_tile<D>(sm, q0, k0, a.seq, a.causal, a.window, scale_log2);
    __syncthreads();
    // dQ += dS k: A row-major 64 x 32, B row-major 32 x D
#pragma unroll
    for (int f = 0; f < C::kPerWarpQ; ++f) {
      const int frag = w + kWarps * f;
      if (frag < C::kFragQ) {
        const int mb = frag / (D / 16), nb = frag % (D / 16);
#pragma unroll
        for (int kb = 0; kb < kBK / 16; ++kb) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, dsb + mb * 16 * C::kLdP + kb * 16,
                                 C::kLdP);
          wmma::load_matrix_sync(fb, ks + kb * 16 * C::kLd + nb * 16, C::kLd);
          wmma::mma_sync(dq[f], fa, fb, dq[f]);
        }
      }
    }
    __syncthreads();
  }
  float* st = reinterpret_cast<float*>(sm + C::kQ);
#pragma unroll
  for (int f = 0; f < C::kPerWarpQ; ++f) {
    const int frag = w + kWarps * f;
    if (frag < C::kFragQ) {
      const int mb = frag / (D / 16), nb = frag % (D / 16);
#pragma unroll
      for (int t = 0; t < dq[f].num_elements; ++t) dq[f].x[t] *= a.scale;
      wmma::store_matrix_sync(st + mb * 16 * C::kLdO + nb * 16, dq[f],
                              C::kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBQ * (D / 2); e += kThreads) {
    const int r = e / (D / 2), c = (e % (D / 2)) * 2;
    if (q0 + r >= a.seq) continue;
    *reinterpret_cast<__nv_bfloat162*>(a.dq + at(a.sdq, b, h, q0 + r) + c) =
        __floats2bfloat162_rn(st[r * C::kLdO + c], st[r * C::kLdO + c + 1]);
  }
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = Cfg<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      attn_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.batch) * a.heads * a.seq;
  attn_bwd_rowdot<D><<<static_cast<int>((rows + kWarps - 1) / kWarps),
                       kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (a.seq + kBK - 1) / kBK;
  attn_bwd_dkdv<D><<<a.batch * a.kv_heads * n_kt * a.splits, kThreads, smem,
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.splits > 1) {
    const long long pairs =
        static_cast<long long>(a.batch) * a.kv_heads * a.seq * D / 2;
    attn_bwd_sum<D><<<static_cast<int>((pairs + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qt = (a.seq + kBQ - 1) / kBQ;
  attn_bwd_dq<D><<<a.batch * a.heads * n_qt, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, H, S, D); k, v, dk, dv (B, KVH, S, D): bf16 with a
// unit stride over D; strides[24] holds the element strides over (batch,
// head, position) of q, k, v, o, dout, dq, dk, dv in turn, each a
// multiple of 8, the pointers 16-byte aligned; window 0 (none) or the
// sliding window w > 0 of K3's mask.  lse (B, H, S) f32 is the
// forward's natural-log row log-sum-exp (K3's LSE output); di is (B, H,
// S) f32 scratch followed by flash_attention_bwd_scratch's floats for
// the dK/dV parts.  head_dim 256 (the 2b SLM), 112 (zamba2-7b's shared
// attention block) or 32 (their reduced configs).  Returns 0 or a
// cudaError_t.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, const long long* strides, int batch, int heads, int kv_heads,
    int seq, int head_dim, int causal, int window, float scale,
    cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      window < 0 ||
      (head_dim != 32 && head_dim != 112 && head_dim != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 24; ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.di = di;
  a.splits = head_splits(batch, heads, kv_heads, seq);
  a.parts = di + static_cast<long long>(batch) * heads * seq;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  Str* ss[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    *ss[i] = Str{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.batch = batch;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq = seq;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  switch (head_dim) {
    case 32:
      return launch<32>(a, stream);
    case 112:
      return launch<112>(a, stream);
    case 256:
      return launch<256>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of scratch flash_attention_bwd_bf16 takes through ``di``: D_i
// (B, H, S) and, when the dK/dV pass splits the heads, its f32 parts.
extern "C" long long flash_attention_bwd_scratch(int batch, int heads,
                                                 int kv_heads, int seq,
                                                 int head_dim) {
  const int splits = head_splits(batch, heads, kv_heads, seq);
  const long long di = static_cast<long long>(batch) * heads * seq;
  return di + (splits > 1 ? 2LL * splits * batch * kv_heads * seq * head_dim
                          : 0LL);
}
