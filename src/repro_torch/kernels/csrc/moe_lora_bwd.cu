// K9: the backward of the gated multi-LoRA delta (paper Eq. 8), written
// for Hopper (sm_90a) in f32 CUDA cores.
//
// Replaces no Pallas kernel: the reference trains through the autodiff
// of the einsum lora_delta (src/repro/models/layers.py:182-196), and its
// Pallas moe_lora_delta has no VJP.  The port's forward of a client step
// runs K5 (csrc/moe_lora.cu): y_t = sum_j B_j (g_tj A_j x_t); this kernel
// gives, for dy = dL/dy (T, n) f32,
//   u~_tj = g_tj A_j x_t  (recomputed),   v~_tj = g_tj B_j^T dy_t,
//   dB_j  = sum_t dy_t u~_tj^T,           dA_j  = sum_t v~_tj x_t^T,
//   dx_t  = sum_j A_j^T v~_tj,
// with x (T, k) bf16, A (E, r, k), B (E, n, r), gates (G, E), all f32, and
// row t reading gate row t / rows_per_gate.  The gates take no gradient.
// dA, dB are f32; dx takes x's type.
//
// Bound on the H100: 2 T E r (3k + 2n) f32 operations against one read
// of x, A, B, dy, gates and one write of dx, dA, dB; at a client step's
// mlp_in (T = 160, k = 2,048, n = 32,768, E r = 16) about 27 MB (8 us at
// 3.35 TB/s) against 0.37 GFLOP (5.5 us at 67 TFLOP/s f32): bound by
// bytes, of which dy is most.
//
// Design (simple first): five passes (seven to nine launches) on the
// caller's stream, every sum in a fixed order, no atomics (two calls on
// the same inputs return the same bits).
//  1. proj: U_part[s, t, c] = sum over split s's share of m of X[t, m]
//     W[c, m], c = j r + i, for (X, W) = (x, A) over m < k and (dy, B) over
//     m < n.  A CTA takes 8 rows of T and a contiguous run of 64-wide m
//     chunks, staging each chunk of X and W in shared memory (all of a
//     thread's loads in flight before its stores, and no integer
//     division an element, which had bound the first design's copies);
//     a thread sums 8 rows of one column over a share of the chunk.  The
//     split count fills about two CTAs an SM.
//  2. gate: U[t, c] = g[t / rpg, c / r] * sum_s U_part[s, t, c], splits in
//     order (u~ and v~).
//  3. outer: dB[j, m, i] = sum_t dy[t, m] u~[t, j r + i] and dA[j, i, m] =
//     sum_t v~[t, j r + i] x[t, m]: a thread owns one m of one expert and
//     loops over its split's share of t (16 rows of u~ or v~ a step in
//     shared memory), 16 ranks at a time in registers.  T splits into
//     contiguous shares so that about two CTAs an SM run (at k 2,048 a
//     split of m alone gives 8 CTAs an expert); with more than one share
//     each writes its partial sums to scratch.  (Holding all E r columns
//     of a thread at once, to read dy and x once, ran slower on the H100
//     at E 1 and 4.)
//  4. out = sum_s part[s], shares in order (only where T was split).
//  5. dx[t, m] = sum_c A[c, m] v~[t, c]: a thread owns one m for 8 rows,
//     v~'s rows in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRowsProj = 8;   // rows of T a proj CTA
static_assert(kRowsProj == 8, "proj reads a chunk's 8 rows as two float4");
constexpr int kChunk = 64;     // m a proj chunk
constexpr int kXLoads = kRowsProj * kChunk / kThreads;  // 2
constexpr int kBatch = 8;      // W loads a proj thread has in flight
constexpr int kRowsOuter = 16; // rows of T an outer step
constexpr int kRanks = 16;     // ranks an outer thread holds at once
constexpr int kMinRowsShare = 4;  // least rows of T an outer share
constexpr int kRowsDx = 8;     // rows of T a dx CTA
constexpr int kMaxBank = 384;  // E * r, as K5
constexpr int kGroups = (kMaxBank + kThreads - 1) / kThreads;  // proj
constexpr int kTargetProj = 264;   // CTAs of a proj pass
constexpr int kTargetOuter = 264;  // CTAs of an outer pass

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}

// Pass 1.  Grid (ceil(T / 8), splits); CTA (tile, s) covers chunks
// [s * per, min(n_chunks, (s + 1) * per)) of m.  Thread (c, q) = (tid %
// cols, tid / cols), cols = min(E r, 256), sums share q of each chunk's
// m for column c (and c + 256) over the tile's 8 rows, each an
// accumulator of its own; the shares are added in order at the end.
// W[c, m] stages as A's rows (c, kChunk + 1 floats apart) or as B's own
// (m, i) blocks, expert j's (kChunk + 1) r floats apart (kB: c = j r +
// i): either way copies with no division an element, and 32 columns of
// a warp fall in distinct banks.
template <typename TX, bool kB>
__global__ void __launch_bounds__(kThreads)
proj(const TX* __restrict__ x, const float* __restrict__ w, float* part,
     int t_rows, int len, int r, int c_n, int per) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                          // kChunk x kRowsProj, m-major
  float* ws = sm + kRowsProj * kChunk;     // c_n (kChunk + 1)
  const int t0 = blockIdx.x * kRowsProj;
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.y * per;
  const int c_end = min(n_chunks, c_begin + per);
  const int cols = min(c_n, kThreads);
  const int shares = kThreads / cols;
  const int q = threadIdx.x / cols, c0 = threadIdx.x % cols;
  const int span = (kChunk + shares - 1) / shares;
  const int mm0 = q * span, mm1 = q < shares ? min(kChunk, mm0 + span) : 0;
  const int q4 = r / 4;  // runs of 256 floats in B's chunk of an expert
  // where column c0 + g cols starts in ws, and its step from m to m + 1
  int w_base[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int c = c0 + g * cols;
    w_base[g] = kB ? (c / r) * (kChunk + 1) * r + c % r : c * (kChunk + 1);
  }
  const int w_step = kB ? r : 1;
  float acc[kGroups][kRowsProj];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int t = 0; t < kRowsProj; ++t) acc[g][t] = 0.f;
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int m0 = ch * kChunk;
    // every load of a thread's share of the chunk in flight before its
    // stores: X's kXLoads, then W's in batches of kBatch
    float xv[kXLoads];
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int t = e / kChunk, mm = e % kChunk;
      xv[u] = (t0 + t < t_rows && m0 + mm < len)
                  ? ld(x, static_cast<long long>(t0 + t) * len + m0 + mm)
                  : 0.f;
    }
    // W: runs of 256 floats, kBatch of them in flight a thread; B's
    // chunk of expert j is kChunk r contiguous floats, r / 4 runs
    const int runs = c_n * kChunk / kThreads;
    const bool full = m0 + kChunk <= len;
    for (int u0 = 0; u0 < runs; u0 += kBatch) {
      float wv[kBatch];
      // B: run u0 + u is run v of expert j (one division a batch)
      int j = kB ? u0 / q4 : 0, v = kB ? u0 - j * q4 : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        wv[u] = 0.f;
        if (u0 + u < runs) {
          const int e = (u0 + u) * kThreads + threadIdx.x;
          if (kB) {
            const int off = v * kThreads + threadIdx.x;
            if (full || m0 + off / r < len)
              wv[u] = w[(static_cast<long long>(j) * len + m0) * r + off];
            if (++v == q4) {
              v = 0;
              ++j;
            }
          } else {
            const int c = e / kChunk, mm = e % kChunk;
            if (full || m0 + mm < len)
              wv[u] = w[static_cast<long long>(c) * len + m0 + mm];
          }
        }
      }
      j = kB ? u0 / q4 : 0;
      v = kB ? u0 - j * q4 : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u0 + u >= runs) break;
        if (kB) {
          ws[j * (kChunk + 1) * r + v * kThreads + threadIdx.x] = wv[u];
          if (++v == q4) {
            v = 0;
            ++j;
          }
        } else {
          const int e = (u0 + u) * kThreads + threadIdx.x;
          ws[(e / kChunk) * (kChunk + 1) + e % kChunk] = wv[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      xs[(e % kChunk) * kRowsProj + e / kChunk] = xv[u];
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = c0 + g * cols;
      if (g > 0 && c >= c_n) break;
      for (int mm = mm0; mm < mm1; ++mm) {
        const float wv = ws[w_base[g] + mm * w_step];
        const float4 lo = *reinterpret_cast<const float4*>(
            xs + mm * kRowsProj);
        const float4 hi = *reinterpret_cast<const float4*>(
            xs + mm * kRowsProj + 4);
        acc[g][0] += lo.x * wv;
        acc[g][1] += lo.y * wv;
        acc[g][2] += lo.z * wv;
        acc[g][3] += lo.w * wv;
        acc[g][4] += hi.x * wv;
        acc[g][5] += hi.y * wv;
        acc[g][6] += hi.z * wv;
        acc[g][7] += hi.w * wv;
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.y) * t_rows * c_n;
  if (shares == 1) {
    if (q > 0) return;  // past the columns: no share
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = c0 + g * cols;
      if (c >= c_n) break;
#pragma unroll
      for (int t = 0; t < kRowsProj; ++t)
        if (t0 + t < t_rows)
          out[static_cast<long long>(t0 + t) * c_n + c] = acc[g][t];
    }
    return;
  }
  // shares > 1 means c_n <= 128: one group; add the shares in order
  float* red = sm;  // shares x kRowsProj x c_n
  if (q < shares) {
#pragma unroll
    for (int t = 0; t < kRowsProj; ++t)
      red[(q * kRowsProj + t) * c_n + c0] = acc[0][t];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRowsProj * c_n; o += kThreads) {
    const int t = o / c_n, c = o % c_n;
    float sum = 0.f;
    for (int p = 0; p < shares; ++p) sum += red[(p * kRowsProj + t) * c_n + c];
    if (t0 + t < t_rows)
      out[static_cast<long long>(t0 + t) * c_n + c] = sum;
  }
}

// Pass 2: out[t, c] = g[t / rpg, c / r] * sum_s part[s, t, c].
__global__ void __launch_bounds__(kThreads)
gate_sum(const float* __restrict__ part, const float* __restrict__ gates,
         float* out, int t_rows, int c_n, int r, int e_n, int rpg,
         int splits) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (o >= static_cast<long long>(t_rows) * c_n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p)
    s += part[static_cast<long long>(p) * t_rows * c_n + o];
  const int t = static_cast<int>(o / c_n), c = static_cast<int>(o % c_n);
  out[o] = gates[static_cast<long long>(t / rpg) * e_n + c / r] * s;
}

// Pass 3.  Grid (ceil(len / 256), E, shares): thread m of expert j sums
// the rows [s * per, min(T, (s + 1) * per)) of share s into
// out[s][j, i, m] (kB false: dA, (E, r, k)) or out[s][j, m, i] (kB true:
// dB, (E, n, r)) = sum_t X[t, m] Y[t, j r + i]; out[s] lies E r len
// floats after out[s - 1].
template <typename TX, bool kB>
__global__ void __launch_bounds__(kThreads)
outer(const TX* __restrict__ x, const float* __restrict__ y, float* out,
      int t_rows, int len, int r, int c_n, int per) {
  __shared__ __align__(16) float ys[kRowsOuter * kMaxBank];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int t_begin = blockIdx.z * per;
  const int t_end = min(t_rows, t_begin + per);
  out += static_cast<long long>(blockIdx.z) * c_n * len;
  for (int i0 = 0; i0 < r; i0 += kRanks) {
    float acc[kRanks];
#pragma unroll
    for (int i = 0; i < kRanks; ++i) acc[i] = 0.f;
    for (int t0 = t_begin; t0 < t_end; t0 += kRowsOuter) {
      const int nt = min(kRowsOuter, t_end - t0);
      __syncthreads();
      for (int e = threadIdx.x; e < nt * r; e += kThreads)
        ys[e] = y[static_cast<long long>(t0 + e / r) * c_n + j * r + e % r];
      __syncthreads();
      if (m < len) {
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float xv = ld(x, static_cast<long long>(t0 + t) * len + m);
          // r % 4 == 0: four ranks are all in or all past r
          const float4* y4 = reinterpret_cast<const float4*>(ys + t * r + i0);
#pragma unroll
          for (int i = 0; i < kRanks / 4; ++i) {
            if (i0 + 4 * i >= r) break;
            const float4 yv = y4[i];
            acc[4 * i] += xv * yv.x;
            acc[4 * i + 1] += xv * yv.y;
            acc[4 * i + 2] += xv * yv.z;
            acc[4 * i + 3] += xv * yv.w;
          }
        }
      }
    }
    if (m < len) {
#pragma unroll
      for (int i = 0; i < kRanks; ++i) {
        if (i0 + i >= r) continue;
        const long long o =
            kB ? (static_cast<long long>(j) * len + m) * r + i0 + i
               : (static_cast<long long>(j) * r + i0 + i) * len + m;
        out[o] = acc[i];
      }
    }
  }
}

// Pass 4: out[o] = sum_s part[s * count + o], shares in order.
__global__ void __launch_bounds__(kThreads)
share_sum(const float* __restrict__ part, float* out, long long count,
          int shares) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (o >= count) return;
  float s = 0.f;
  for (int p = 0; p < shares; ++p) s += part[p * count + o];
  out[o] = s;
}

// Pass 5.  Grid (ceil(k / 256), ceil(T / 8)): dx[t, m] = sum_c A[c, m]
// v~[t, c] for 8 rows.
__global__ void __launch_bounds__(kThreads)
dx_pass(const float* __restrict__ a, const float* __restrict__ vt, bf16* dx,
        int t_rows, int k, int c_n) {
  __shared__ float vs[kRowsDx * kMaxBank];
  const int t0 = blockIdx.y * kRowsDx;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  for (int e = threadIdx.x; e < kRowsDx * c_n; e += kThreads) {
    const int t = e / c_n;
    vs[e] = t0 + t < t_rows
                ? vt[static_cast<long long>(t0 + t) * c_n + e % c_n]
                : 0.f;
  }
  __syncthreads();
  if (m >= k) return;
  float acc[kRowsDx];
#pragma unroll
  for (int t = 0; t < kRowsDx; ++t) acc[t] = 0.f;
#pragma unroll 8
  for (int c = 0; c < c_n; ++c) {
    const float av = a[static_cast<long long>(c) * k + m];
#pragma unroll
    for (int t = 0; t < kRowsDx; ++t) acc[t] += av * vs[t * c_n + c];
  }
#pragma unroll
  for (int t = 0; t < kRowsDx; ++t)
    if (t0 + t < t_rows)
      dx[static_cast<long long>(t0 + t) * k + m] = __float2bfloat16(acc[t]);
}

// Splits of the proj pass over m: about kTargetProj CTAs in all.
void split_plan(int t_rows, int len, int* splits, int* per) {
  const int tiles = (t_rows + kRowsProj - 1) / kRowsProj;
  const int n_chunks = (len + kChunk - 1) / kChunk;
  int s = (kTargetProj + tiles - 1) / tiles;
  s = max(1, min(s, n_chunks));
  *per = (n_chunks + s - 1) / s;
  *splits = (n_chunks + *per - 1) / *per;
}

// Shares of T in the outer pass over len: about kTargetOuter CTAs in all,
// at least kMinRowsShare rows a share.
void share_plan(int t_rows, int len, int e, int* shares, int* per) {
  const int ctas = (len + kThreads - 1) / kThreads * e;
  int s = (kTargetOuter + ctas - 1) / ctas;
  s = max(1, min(s, (t_rows + kMinRowsShare - 1) / kMinRowsShare));
  *per = (t_rows + s - 1) / s;
  *shares = (t_rows + *per - 1) / *per;
}

// Partial sums of an outer pass: none when T is not split.
long long share_floats(int t, int len, int r, int e) {
  int s, per;
  share_plan(t, len, e, &s, &per);
  return s > 1 ? static_cast<long long>(s) * e * r * len : 0;
}

long long scratch_floats(int t, int k, int n, int r, int e) {
  int sa, sb, per;
  split_plan(t, k, &sa, &per);
  split_plan(t, n, &sb, &per);
  const long long tc = static_cast<long long>(t) * e * r;
  return tc * (sa + sb) + 2 * tc + share_floats(t, n, r, e) +
         share_floats(t, k, r, e);
}

// Pass 3 (and 4 where T is split) into out (E r len floats).
template <typename TX, bool kB>
void outer_launch(const TX* x, const float* y, float* out, float* part,
                  int t, int len, int r, int e, cudaStream_t stream) {
  int shares, per;
  share_plan(t, len, e, &shares, &per);
  const dim3 grid((len + kThreads - 1) / kThreads, e, shares);
  outer<TX, kB><<<grid, kThreads, 0, stream>>>(
      x, y, shares > 1 ? part : out, t, len, r, e * r, per);
  if (shares > 1) {
    const long long count = static_cast<long long>(e) * r * len;
    share_sum<<<static_cast<int>((count + kThreads - 1) / kThreads),
                kThreads, 0, stream>>>(part, out, count, shares);
  }
}

}  // namespace

// Floats of scratch moe_lora_delta_bwd_f32 needs at (T, k, n, r, E).
extern "C" long long moe_lora_delta_bwd_scratch(int t, int k, int n, int r,
                                                int e) {
  return scratch_floats(t, k, n, r, e);
}

// x (T, k) bf16; a (E, r, k), b (E, n, r), gates (G, E), dy (T, n) f32,
// T = G * rows_per_gate; outputs dx (T, k) bf16, da (E, r, k) and db (E, n,
// r) f32; scratch of moe_lora_delta_bwd_scratch floats.  Every pointer
// contiguous.  E * r <= 384, r % 4 == 0.  Returns 0 or a cudaError_t.
extern "C" int moe_lora_delta_bwd_f32(const void* x, const float* a,
                                      const float* b, const float* gates,
                                      const float* dy, float* scratch,
                                      void* dx, float* da, float* db, int t,
                                      int k, int n, int r, int e,
                                      int rows_per_gate, cudaStream_t stream) {
  if (t <= 0 || k <= 0 || n <= 0 || r <= 0 || r % 4 != 0 || e <= 0 ||
      e * r > kMaxBank || rows_per_gate <= 0 || t % rows_per_gate != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_n = e * r;
  const long long tc = static_cast<long long>(t) * c_n;
  int sa, pa, sb, pb;
  split_plan(t, k, &sa, &pa);
  split_plan(t, n, &sb, &pb);
  float* part_u = scratch;
  float* part_v = part_u + tc * sa;
  float* ut = part_v + tc * sb;  // u~ (T, E r)
  float* vt = ut + tc;           // v~ (T, E r)
  float* part_db = vt + tc;      // outer shares of dB, then of dA
  float* part_da = part_db + share_floats(t, n, r, e);
  const int shares = kThreads / min(c_n, kThreads);
  const int smem = max(kRowsProj * kChunk + c_n * (kChunk + 1),
                       shares > 1 ? shares * kRowsProj * c_n : 0) * 4;
  cudaError_t err;
  err = cudaFuncSetAttribute(proj<bf16, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(proj<float, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t + kRowsProj - 1) / kRowsProj;
  const bf16* xb = static_cast<const bf16*>(x);
  proj<bf16, false><<<dim3(tiles, sa), kThreads, smem, stream>>>(
      xb, a, part_u, t, k, r, c_n, pa);
  proj<float, true><<<dim3(tiles, sb), kThreads, smem, stream>>>(
      dy, b, part_v, t, n, r, c_n, pb);
  const int gblocks = static_cast<int>((tc + kThreads - 1) / kThreads);
  gate_sum<<<gblocks, kThreads, 0, stream>>>(part_u, gates, ut, t, c_n, r, e,
                                             rows_per_gate, sa);
  gate_sum<<<gblocks, kThreads, 0, stream>>>(part_v, gates, vt, t, c_n, r, e,
                                             rows_per_gate, sb);
  outer_launch<float, true>(dy, ut, db, part_db, t, n, r, e, stream);
  outer_launch<bf16, false>(xb, vt, da, part_da, t, k, r, e, stream);
  dx_pass<<<dim3((k + kThreads - 1) / kThreads, (t + kRowsDx - 1) / kRowsDx),
            kThreads, 0, stream>>>(a, vt, static_cast<bf16*>(dx), t, k, c_n);
  return static_cast<int>(cudaGetLastError());
}
