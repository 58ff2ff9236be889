// Merged multi-LoRA deltas (paper Eq. 8), activations bf16, bank and
// output f32.
//
// K5 replaces src/repro/kernels/moe_lora/kernel.py::moe_lora_delta:
//   out[t] = sum_j g[t / rows_per_gate, j] * (x[t] A_j^T) B_j^T
// with x (T, k), A (E, r, k), B (E, n, r), gates (T / rows_per_gate, E).
// K4 replaces src/repro/kernels/moe_lora/kernel.py::moe_lora_delta_slots:
//   out[t] = (x[t] A_s^T) B_s^T, s = slots[t / rows_per_slot],
// an exact 0 where s < 0; s >= E is clamped onto E - 1 as the Pallas
// kernel's expert_map clips it.
//
// Bound on the H100: bytes at decode (T = 8 rows against a bank of E
// experts: every A and B float read once, 2 * 8 multiply-adds per float),
// f32 operations at an admission prefill (T = 8 x 1,552 rows reuse each
// bank float thousands of times: 2 T E r (k + n) operations against the
// 67 TFLOP/s of the SIMT f32 units; A and B stay f32, so no tensor-core
// rate applies without rounding them).
//
// Design: two launches per call, both in this file.
// At decode (T < 64, and every K4 call), a latency-bound shape: T = 8
// rows against a few MB of bank, so the design spreads the bank's bytes
// over many CTAs.
//  1. down: k is cut into up to 16 parts of 256-column steps
//     (decode_parts); CTA (part z, expert j, 4 ranks) reads its ranks of
//     A_j over part z once and applies them to every row that reads
//     expert j (K5: all rows; K4: the rows whose slot is j, the
//     segmented form: a slot shared by several rows is read once), 8
//     rows at a time.  Lane l of a warp takes columns [8 l + 256 m, 8 l +
//     256 m + 8) in order of m, fmaf in order, then a butterfly; the
//     part's sums land in an f32 scratch (parts, T, E, r) (K4: (parts,
//     T, r)).  128 CTAs at k = 2,048 and 256 at k = 16,384 for E = 4,
//     r = 16.
//  2. up: a CTA of 256 threads takes 64 output columns of up to 8 rows
//     (up_rows picks the rows so the grid holds about two CTAs an SM:
//     32 CTAs at n = 256, 256 at n = 2,048, 512 at n = 32,768, T = 8).
//     It stages u = part_0 + part_1 + ... (times the gate for K5) in
//     shared memory, then four threads share a column: each reads a
//     quarter of B_j[c, :] as float4, so a warp reads 512 contiguous
//     bytes, keeps a chain per row over experts ascending and ranks
//     ascending, and a two-step butterfly adds the quarters.
// K4 and K5 run these routines (lora_down, lora_up) in the same order
// over k, parts, r and the quarters; a gate of exactly 1.0 multiplies
// nothing away and a gate of 0.0 adds exact zeros, so K5 on one-hot gate
// rows returns K4's output bit for bit.  No atomics: a run repeats bit
// for bit.
// At an admission prefill (K5 with T >= 64) both passes are
// register-tiled SIMT f32 GEMMs (A and B stay f32: TF32 would fail the
// 1e-5 limit, so no tensor cores):
//  1. down: P_z (T, E r) = X (T, k_z) A^T (k_z, E r) over split z of k.
//     A CTA of 256 threads computes 128 rows x 64 columns, each thread
//     an 8 x 4 micro-tile (rows 4 rg.. and 64 + 4 rg.., so a warp's
//     shared-memory reads are conflict-free); k-slices of 16 are loaded
//     into registers (x widened from bf16 to f32) while the previous
//     slice is computed, then stored transposed into the other of two
//     shared buffers.  k is split into as many parts (at most 8) as it
//     takes for the CTAs to fill whole waves of two per SM (5 parts at
//     T = 12,416: 485 CTAs); the parts land in the scratch and are added
//     in a fixed order by the up pass: no atomics, a run repeats bit for
//     bit.
//  2. up: OUT (T, n) = U (T, E r) B' (E r, n), u = (P_0 + P_1 + ...) *
//     gate added and scaled while the U tile is staged.  A CTA holds the
//     U tile of 128 rows once and walks every 8th tile of 128 output
//     columns; each thread computes 8 x 8 outputs.  U and B' sit K-major
//     in shared memory (64 inner columns a row, B' XOR-swizzled by 16
//     bytes so the reads are conflict-free), the next B' tile arrives by
//     cp.async while the current one is computed, each B' float is read
//     from L2 once per 128 rows, and outputs are stored 16 bytes a
//     thread with the streaming hint (they are not read again).
// Registers and shared memory of the admission GEMMs (ptxas, sm_90a,
// nvcc 12.9): down 109 registers, 25,600 B; up 128 registers (the cap of
// two CTAs of 256 per SM), 98,304 B dynamic + 400 B; no spills in either.
// Zero gates: where all rows of a tile share one gate row (rows_per_gate
// >= the tile, as at admission), an expert whose gate is exactly 0 is
// skipped in both passes: the down pass writes 0 for its columns and the
// up pass leaves its r inner columns out of the sum.  Leaving out
// fmaf(0, b, acc) keeps the sum bit-identical for finite B, and the
// order of every sum depends on k, r and the experts kept alone, so a
// gate of 0 gives the output of a bank without that expert.  A tile that
// straddles two gate rows computes every expert.  3xTF32 tensor cores
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSMs = 132;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 consecutive bf16 (16 bytes) widened to f32.
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ---- Decode (T < 64, and every K4 call): k split over CTAs ----

constexpr int kDecStep = 256;     // k columns a warp takes per step
constexpr int kDecMaxParts = 16;  // parts k is split into, at most
constexpr int kDecRows = 8;       // rows a warp (down) or CTA (up) holds
constexpr int kDownWarps = 4;     // ranks per CTA of the down pass
constexpr int kUpThreads = 256;   // 64 columns x 4 quarters of r
constexpr int kUpCols = kUpThreads / 4;

// Parts of k and their width (a multiple of kDecStep): ceil(k / 256)
// parts of 256 up to 16 parts.
void decode_parts(int k, int* parts, int* k_part) {
  const int steps = (k + kDecStep - 1) / kDecStep;
  const int want = min(kDecMaxParts, steps);
  *k_part = (steps + want - 1) / want * kDecStep;
  *parts = (k + *k_part - 1) / *k_part;
}

// Rows per CTA of the up pass: enough row blocks that the grid holds
// about two CTAs per SM, at most kDecRows rows a CTA.
int up_rows(int T, int n) {
  const int col_ctas = (n + kUpCols - 1) / kUpCols;
  const int want = (2 * kSMs + col_ctas - 1) / col_ctas;
  return max(1, min(kDecRows, (T + want - 1) / want));
}

// The expert row t reads: K5, every expert; K4, its slot (clamped onto
// E - 1), or -1 for a row without an adapter.
template <bool kSlots>
__device__ __forceinline__ int slot_of(const int32_t* slots, int t,
                                       int rows_per, int E) {
  if constexpr (kSlots) {
    const int s = slots[t / rows_per];
    return s < 0 ? -1 : min(s, E - 1);
  } else {
    return 0;
  }
}

// acc = fmaf(u[i], b[i], acc) for i = 0 .. 3 in order.
__device__ __forceinline__ float up4(float4 u, float4 b, float acc) {
  acc = __fmaf_rn(u.x, b.x, acc);
  acc = __fmaf_rn(u.y, b.y, acc);
  acc = __fmaf_rn(u.z, b.z, acc);
  return __fmaf_rn(u.w, b.w, acc);
}

// Down pass, grid (parts, E * ceil(r / 4)), 4 warps.  Warp w of CTA (z,
// j * rb + q) owns rank i = 4 q + w of expert j and part z of k, [z
// k_part, (z + 1) k_part): for each row that reads expert j (K5: every
// row; K4: the rows whose slot is j, so A_j is read once a call however
// many rows share it) it writes
//   part[z][t][j'][i] = sum over the part of x[t, c] A_j[i, c],
// j' = j (K5) or 0 (K4, E' = 1).  Lane l takes columns [8 l + 256 m,
// 8 l + 256 m + 8) of the part in order of m, fmaf in order, then a
// butterfly over the warp: the order depends on k alone, the same in K4
// and K5.  Rows go 8 at a time, so A's 8 floats a lane serve 8 rows.
template <bool kSlots>
__global__ void __launch_bounds__(kDownWarps * 32) lora_down(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const int32_t* __restrict__ slots, float* __restrict__ part, int T,
    int k, int r, int E, int rows_per, int k_part) {
  const int rb = (r + kDownWarps - 1) / kDownWarps;
  const int j = blockIdx.y / rb;
  const int i = (blockIdx.y % rb) * kDownWarps + (threadIdx.x >> 5);
  if (i >= r) return;
  const int lane = threadIdx.x & 31, z = blockIdx.x;
  const int k_lo = z * k_part, k_hi = min(k, k_lo + k_part);
  const int el = kSlots ? 1 : E, jl = kSlots ? 0 : j;
  const float* arow = a + (static_cast<size_t>(j) * r + i) * k;
  for (int t0 = 0; t0 < T; t0 += kDecRows) {
    bool use[kDecRows];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kDecRows; ++q) {
      const int t = t0 + q;
      use[q] = t < T &&
               (!kSlots || slot_of<kSlots>(slots, t, rows_per, E) == j);
      any |= use[q];
    }
    if (!any) continue;
    float acc[kDecRows];
#pragma unroll
    for (int q = 0; q < kDecRows; ++q) acc[q] = 0.f;
    for (int kk = k_lo + lane * 8; kk < k_hi; kk += kDecStep) {
      float av[8];
      load8(arow + kk, av);
#pragma unroll
      for (int q = 0; q < kDecRows; ++q) {
        if (!use[q]) continue;
        float xv[8];
        load8(x + static_cast<size_t>(t0 + q) * k + kk, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q] = __fmaf_rn(xv[e], av[e], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kDecRows; ++q) {
      if (!use[q]) continue;                    // the same in every lane
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0)
        part[((static_cast<size_t>(z) * T + t0 + q) * el + jl) * r + i] = v;
    }
  }
}

// Up pass, grid (ceil(n / 64), ceil(T / rows)), 256 threads, rows * E'
// * r floats of dynamic shared memory.  The CTA first stages u for its
// rows, u = part_0 + part_1 + ... in part order (times the gate for
// K5).  Thread (column c, quarter qr) then reads B_j[c, 4 qr + 16 m ..
// + 4] as float4 (four threads cover a column's r floats, so a warp
// reads 8 whole columns, 512 contiguous bytes, per load) and keeps a
// chain per row over experts j ascending (K5) or the row's slot (K4),
// ranks ascending; the four quarters are added by a butterfly.  A K5
// row whose gates are one-hot adds exact zeros for the other experts,
// so it equals K4's row bit for bit; a K4 row without an adapter is 0.
template <bool kSlots>
__global__ void __launch_bounds__(kUpThreads) lora_up(
    const float* __restrict__ part, const float* __restrict__ b,
    const float* __restrict__ gates, const int32_t* __restrict__ slots,
    float* __restrict__ out, int T, int n, int r, int E, int rows_per,
    int parts, int rows) {
  extern __shared__ __align__(16) float su[];   // rows x E' x r
  const int el = kSlots ? 1 : E, er = el * r;
  const int t0 = blockIdx.y * rows;
  const int nrows = min(rows, T - t0);
  for (int v = threadIdx.x; v < nrows * er; v += kUpThreads) {
    const int t = t0 + v / er;
    const size_t at = static_cast<size_t>(t) * er + v % er;
    float u = 0.f;
    if (!kSlots || slot_of<kSlots>(slots, t, rows_per, E) >= 0) {
      u = part[at];
      for (int z = 1; z < parts; ++z)
        u = __fadd_rn(u, part[static_cast<size_t>(z) * T * er + at]);
      if (!kSlots)
        u = __fmul_rn(u, gates[static_cast<size_t>(t / rows_per) * E +
                               (v % er) / r]);
    }
    su[v] = u;
  }
  __syncthreads();
  const int c = blockIdx.x * kUpCols + threadIdx.x / 4;
  const int qr = threadIdx.x % 4;
  float acc[kDecRows];
#pragma unroll
  for (int q = 0; q < kDecRows; ++q) acc[q] = 0.f;
  if (c >= n) {
    // past the last column: only joins the butterfly below
  } else if constexpr (kSlots) {
#pragma unroll
    for (int q = 0; q < kDecRows; ++q) {
      if (q >= nrows) continue;
      const int s = slot_of<kSlots>(slots, t0 + q, rows_per, E);
      if (s < 0) continue;
      const float* bs = b + (static_cast<size_t>(s) * n + c) * r;
      for (int i = 4 * qr; i < r; i += 16)
        acc[q] = up4(*reinterpret_cast<const float4*>(su + q * r + i),
                     *reinterpret_cast<const float4*>(bs + i), acc[q]);
    }
  } else {
    for (int j = 0; j < E; ++j) {
      const float* bj = b + (static_cast<size_t>(j) * n + c) * r;
      for (int i = 4 * qr; i < r; i += 16) {
        const float4 bv = *reinterpret_cast<const float4*>(bj + i);
#pragma unroll
        for (int q = 0; q < kDecRows; ++q)
          if (q < nrows)
            acc[q] = up4(*reinterpret_cast<const float4*>(su + q * er +
                                                          j * r + i),
                         bv, acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kDecRows; ++q) {
    float v = acc[q];
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (q < nrows && qr == 0 && c < n)
      out[static_cast<size_t>(t0 + q) * n + c] = v;
  }
}

// ---- K5 at an admission prefill (T >= 64): register-tiled f32 GEMMs ----

constexpr int kGemmRows = 128;   // rows of a CTA tile, both passes
constexpr int kDownCols = 64;    // columns of E r per CTA of the down pass
constexpr int kDownK = 16;       // k-slice of the down pass
constexpr int kTileCols = 128;   // output columns of an up-pass tile
constexpr int kUpK = 64;         // inner columns staged per up-pass step
constexpr int kUpGroups = 8;     // column groups of the up pass's grid
constexpr int kPad = 4;          // floats of padding per shared row
constexpr int kMaxExperts = 96;  // E r <= 384 (check_dims) and r >= 4

// Parts the down pass splits k into: the fewest (at most 8, each at
// least 256 of k) whose CTAs fill whole waves of two per SM to 90%, else
// the best of those.
int down_splits(int T, int k, int er) {
  const int tiles = ((T + kGemmRows - 1) / kGemmRows) *
                    ((er + kDownCols - 1) / kDownCols);
  const int slots = 2 * kSMs;
  int best = 1;
  double best_fill = 0.;
  for (int s = 1; s <= 8 && (s == 1 || k / s >= 256); ++s) {
    const int ctas = tiles * s;
    const double fill =
        static_cast<double>(ctas) / (((ctas + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
    if (fill >= 0.9) break;
  }
  return best;
}

// Whether every row of the tile [t0, t0 + kGemmRows) shares gate row
// *g (then an expert whose gate is 0 is skipped).
__device__ __forceinline__ bool uniform_gate(int t0, int T,
                                             int rows_per_gate, int* g) {
  *g = t0 / rows_per_gate;
  return *g == (min(t0 + kGemmRows, T) - 1) / rows_per_gate;
}

// Down pass: grid (ceil(T / 128), ceil(E r / 64), splits).  CTA (bx, by,
// z) writes part[z][t][c] = sum over k in split z of x[t, k] A[c, k] for
// its 128 rows and 64 columns c of E r.  Thread (warp w, lane l) owns
// columns 4 cg .. 4 cg + 3, cg = 4 (w % 4) + l % 4 (one expert, r % 4 ==
// 0), and rows 4 rg .. and 64 + 4 rg .., rg = 8 (w / 4) + l / 4.
__global__ void __launch_bounds__(kThreads, 2) k5_gemm_down(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ gates, float* __restrict__ part, int T, int k,
    int r, int E, int rows_per_gate, int k_split) {
  __shared__ __align__(16) float sx[2][kDownK][kGemmRows + kPad];
  __shared__ __align__(16) float sa[2][kDownK][kDownCols + kPad];
  const int er = E * r;
  const int t0 = blockIdx.x * kGemmRows, c0 = blockIdx.y * kDownCols;
  const int k_lo = blockIdx.z * k_split;
  const int k_hi = min(k, k_lo + k_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = (warp % 4) * 4 + lane % 4, rg = (warp / 4) * 8 + lane / 4;
  const int col = c0 + cg * 4;
  int g;
  const bool uniform = uniform_gate(t0, T, rows_per_gate, &g);
  const bool busy = col < er &&
                    !(uniform && gates[static_cast<size_t>(g) * E + col / r] ==
                                     0.f);
  // this thread's share of a slice: 8 x values of row tid / 2 and 4 A
  // values of column tid / 4
  const int xr = tid >> 1, xk = (tid & 1) * 8;
  const int ac = tid >> 2, ak = (tid & 3) * 4;
  const bf16* xp = x + static_cast<size_t>(t0 + xr) * k;
  const float* ap = a + static_cast<size_t>(c0 + ac) * k;
  const bool x_ok = t0 + xr < T, a_ok = c0 + ac < er;
  float xv[8], av[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = 0.f;
    if (x_ok && k0 + xk < k_hi) load8(xp + k0 + xk, xv);
    if (a_ok && k0 + ak < k_hi) {
      const float4 v = *reinterpret_cast<const float4*>(ap + k0 + ak);
      av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sx[buf][xk + i][xr] = xv[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) sa[buf][ak + i][ac] = av[i];
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int n_slices = k_hi > k_lo ? (k_hi - k_lo + kDownK - 1) / kDownK : 0;
  if (n_slices > 0) {
    fetch(k_lo);
    stage(0);
  }
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) fetch(k_lo + (s + 1) * kDownK);
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < kDownK; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(&sx[buf][kk][rg * 4]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&sx[buf][kk][64 + rg * 4]);
        const float4 av4 = *reinterpret_cast<const float4*>(&sa[buf][kk][cg * 4]);
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float as[4] = {av4.x, av4.y, av4.z, av4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(xs[i], as[j], acc[i][j]);
      }
    }
    if (s + 1 < n_slices) stage(buf ^ 1);
    __syncthreads();
  }
  if (col >= er) return;
  float* pz = part + static_cast<size_t>(blockIdx.z) * T * er;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? rg * 4 + i : 64 + rg * 4 + i - 4);
    if (t < T)
      *reinterpret_cast<float4*>(pz + static_cast<size_t>(t) * er + col) =
          busy ? make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// su[row][q] = (part_0 + part_1 + ...)[t0 + row][column of kept inner
// column q0 + q] * the row's gate, for q < nq; 64 floats a row.
__device__ __forceinline__ void stage_u(float* su, const float* part,
                                        const float* gates, const int* kept,
                                        int q0, int nq, int t0, int T,
                                        int r, int E, int rows_per_gate,
                                        int splits) {
  const int er = E * r, nq4 = nq / 4;
  for (int v = threadIdx.x; v < kGemmRows * nq4; v += kThreads) {
    const int row = v / nq4, q = (v % nq4) * 4;
    const int j = kept[(q0 + q) / r];
    const int t = t0 + row;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) {
      const size_t at = static_cast<size_t>(t) * er + j * r + (q0 + q) % r;
      u = *reinterpret_cast<const float4*>(part + at);
      for (int z = 1; z < splits; ++z) {
        const float4 p = *reinterpret_cast<const float4*>(
            part + static_cast<size_t>(z) * T * er + at);
        u.x = __fadd_rn(u.x, p.x);
        u.y = __fadd_rn(u.y, p.y);
        u.z = __fadd_rn(u.z, p.z);
        u.w = __fadd_rn(u.w, p.w);
      }
      const float g = gates[static_cast<size_t>(t / rows_per_gate) * E + j];
      u.x = __fmul_rn(u.x, g);
      u.y = __fmul_rn(u.y, g);
      u.z = __fmul_rn(u.z, g);
      u.w = __fmul_rn(u.w, g);
    }
    *reinterpret_cast<float4*>(su + row * kUpK + q) = u;
  }
}

// cp.async the B' chunk of kept inner columns [q0, q0 + nq) for output
// columns [c0, c0 + 128) into sb (shared address): column col's 16-byte
// unit q4 lands at unit q4 ^ ((col / 4) % 8) of its 64-float row, so the
// compute loop's reads are free of bank conflicts.  Columns past n are
// zero-filled.  Commits one group.
__device__ __forceinline__ void load_b(uint32_t sb, const float* b,
                                       const int* kept, int q0, int nq,
                                       int c0, int n, int r) {
  const int nq4 = nq / 4;
  for (int v = threadIdx.x; v < kTileCols * nq4; v += kThreads) {
    const int col = v / nq4, q4 = v % nq4;
    const int q = q0 + q4 * 4;
    const bool ok = c0 + col < n;
    const float* src =
        ok ? b + (static_cast<size_t>(kept[q / r]) * n + c0 + col) * r + q % r
           : b;
    cp_async16(sb + 4 * (col * kUpK + ((q4 ^ ((col >> 2) & 7)) << 2)), src,
               ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Up pass: grid (ceil(T / 128), min(ceil(n / 128), kUpGroups)), 256
// threads, kUpSmem bytes of dynamic shared memory.  CTA (bx, by) holds
// the U tile of rows [128 bx, 128 bx + 128) and walks the output column
// tiles by, by + gridDim.y, ...: out[t, c] = sum over the kept inner
// columns q (experts ascending, ranks ascending) of u[t, q] B'[q, c].
// Both tiles are K-major in shared memory (64 inner columns a row); the
// next B chunk arrives by cp.async while the current one is computed.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. and 64 + 4
// ty .., columns 4 tx .. and 64 + 4 tx ...
constexpr int kUpSmem = static_cast<int>(sizeof(float)) * kUpK *
                        (kGemmRows + 2 * kTileCols);

__global__ void __launch_bounds__(kThreads, 2) k5_gemm_up(
    const float* __restrict__ part, const float* __restrict__ b,
    const float* __restrict__ gates, float* __restrict__ out, int T, int n,
    int r, int E, int rows_per_gate, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* su = smem;                                // [128][kUpK]
  float* sb = smem + kGemmRows * kUpK;             // [2][128][kUpK]
  const uint32_t sb_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sb));
  __shared__ int kept[kMaxExperts];
  __shared__ int n_kept;
  const int t0 = blockIdx.x * kGemmRows;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int g;
  const bool uniform = uniform_gate(t0, T, rows_per_gate, &g);
  if (tid == 0) {
    int m = 0;
    for (int j = 0; j < E; ++j)
      if (!uniform || gates[static_cast<size_t>(g) * E + j] != 0.f)
        kept[m++] = j;
    n_kept = m;
  }
  __syncthreads();
  const int inner = n_kept * r;
  const int n_chunks = (inner + kUpK - 1) / kUpK;
  const int n_tiles = (n + kTileCols - 1) / kTileCols;
  const int my_tiles =
      (n_tiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int steps = my_tiles * n_chunks;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto store = [&](int ct) {
    const int c0 = ct * kTileCols;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + (i & 3) + ty * 4 + (i >> 2) * 64;
      if (t < T) {
        float* orow = out + static_cast<size_t>(t) * n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + h * 64 + tx * 4;
          if (n % 4 == 0 && c + 3 < n) {
            __stcs(reinterpret_cast<float4*>(orow + c),   // streamed out
                   make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                               acc[i][4 * h + 2], acc[i][4 * h + 3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < n) orow[c + j] = acc[i][4 * h + j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  };
  if (steps == 0) {                  // every expert of the tile skipped
    for (int m = 0; m < my_tiles; ++m) store(blockIdx.y + m * gridDim.y);
    return;
  }
  if (n_chunks == 1)
    stage_u(su, part, gates, kept, 0, inner, t0, T, r, E, rows_per_gate,
            splits);
  load_b(sb_addr, b, kept, 0, min(kUpK, inner), blockIdx.y * kTileCols, n,
         r);
  const int sw = tx & 7;
  for (int s = 0; s < steps; ++s) {
    const int ct = blockIdx.y + (s / n_chunks) * gridDim.y;
    const int ch = s % n_chunks;
    const int q0 = ch * kUpK, nq = min(kUpK, inner - q0);
    if (s + 1 < steps) {
      const int ct1 = blockIdx.y + ((s + 1) / n_chunks) * gridDim.y;
      const int q1 = ((s + 1) % n_chunks) * kUpK;
      load_b(sb_addr + ((s + 1) & 1) * kTileCols * kUpK * 4, b, kept, q1,
             min(kUpK, inner - q1), ct1 * kTileCols, n, r);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    if (n_chunks > 1)
      stage_u(su, part, gates, kept, q0, nq, t0, T, r, E, rows_per_gate,
              splits);
    __syncthreads();
    const float* sbc = sb + (s & 1) * kTileCols * kUpK;
    for (int kq = 0; kq < nq / 4; ++kq) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 bv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bv[jj] = *reinterpret_cast<const float4*>(
              sbc + (h * 64 + tx * 4 + jj) * kUpK + ((kq ^ sw) << 2));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 uv = *reinterpret_cast<const float4*>(
              su + ((i & 3) + ty * 4 + (i >> 2) * 64) * kUpK + kq * 4);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float& a = acc[i][4 * h + jj];
            a = __fmaf_rn(uv.x, bv[jj].x, a);
            a = __fmaf_rn(uv.y, bv[jj].y, a);
            a = __fmaf_rn(uv.z, bv[jj].z, a);
            a = __fmaf_rn(uv.w, bv[jj].w, a);
          }
        }
      }
    }
    if (ch == n_chunks - 1) store(ct);
    __syncthreads();
  }
}

// E r <= 384: the admission up pass keeps the kept experts' list in
// kMaxExperts entries.
int check_dims(int T, int k, int n, int r, int E, int rows_per) {
  if (T <= 0 || k <= 0 || n <= 0 || r <= 0 || E <= 0 || rows_per <= 0 ||
      k % 8 != 0 || r % 4 != 0 || E * r > 384)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The decode design's two launches (K4 with kSlots, K5 below 64 rows).
template <bool kSlots>
int launch_decode(const void* x, const void* a, const void* b,
                  const void* sel, void* u, void* out, int T, int k, int n,
                  int r, int E, int rows_per, cudaStream_t stream) {
  int parts, k_part;
  decode_parts(k, &parts, &k_part);
  const float* gp = kSlots ? nullptr : static_cast<const float*>(sel);
  const int32_t* sp = kSlots ? static_cast<const int32_t*>(sel) : nullptr;
  float* up = static_cast<float*>(u);
  dim3 grid(parts, E * ((r + kDownWarps - 1) / kDownWarps));
  lora_down<kSlots><<<grid, kDownWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), sp, up, T,
      k, r, E, rows_per, k_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = up_rows(T, n);
  dim3 grid_up((n + kUpCols - 1) / kUpCols, (T + rows - 1) / rows);
  const size_t smem = sizeof(float) * rows * (kSlots ? 1 : E) * r;
  lora_up<kSlots><<<grid_up, kUpThreads, smem, stream>>>(
      up, static_cast<const float*>(b), gp, sp, static_cast<float*>(out), T,
      n, r, E, rows_per, parts, rows);
  return static_cast<int>(cudaGetLastError());
}

int launch_k5(const void* x, const void* a, const void* b, const void* gates,
              void* u, void* out, int T, int k, int n, int r, int E,
              int rows_per_gate, cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const float* gp = static_cast<const float*>(gates);
  float* up = static_cast<float*>(u);
  float* op = static_cast<float*>(out);
  if (T < 64)
    return launch_decode<false>(x, a, b, gates, u, out, T, k, n, r, E,
                                rows_per_gate, stream);
  const int er = E * r;
  const int splits = down_splits(T, k, er);
  const int k_split =
      ((k + splits - 1) / splits + kDownK - 1) / kDownK * kDownK;
  dim3 grid_down((T + kGemmRows - 1) / kGemmRows,
                 (er + kDownCols - 1) / kDownCols, splits);
  k5_gemm_down<<<grid_down, kThreads, 0, stream>>>(
      xp, ap, gp, up, T, k, r, E, rows_per_gate, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(k5_gemm_up,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kUpSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_up((T + kGemmRows - 1) / kGemmRows,
               min((n + kTileCols - 1) / kTileCols, kUpGroups));
  k5_gemm_up<<<grid_up, kThreads, kUpSmem, stream>>>(
      up, bp, gp, op, T, n, r, E, rows_per_gate, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of f32 scratch K5 needs: the down pass's parts (parts, T, E,
// r), at decode (T < 64) of the k split of decode_parts, at an
// admission prefill of down_splits.
extern "C" long long moe_lora_delta_scratch(int T, int k, int r, int E) {
  const long long er = static_cast<long long>(E) * r;
  int parts, k_part;
  decode_parts(k, &parts, &k_part);
  return (T < 64 ? parts : down_splits(T, k, static_cast<int>(er))) * T * er;
}

// Floats of f32 scratch K4 needs: the down pass's parts (parts, T, r).
extern "C" long long moe_lora_delta_slots_scratch(int T, int k, int r) {
  int parts, k_part;
  decode_parts(k, &parts, &k_part);
  return static_cast<long long>(parts) * T * r;
}

// x (T, k) contiguous bf16, 16-byte aligned; a (E, r, k), b (E, n, r),
// gates (T / rows_per_gate, E), out (T, n): contiguous f32; u: f32
// scratch of moe_lora_delta_scratch(T, k, r, E) floats.  k % 8 == 0,
// r % 4 == 0, E * r <= 384.  Returns 0 or a cudaError_t.
extern "C" int moe_lora_delta_f32(const void* x, const void* a,
                                  const void* b, const void* gates, void* u,
                                  void* out, int T, int k, int n, int r,
                                  int E, int rows_per_gate,
                                  cudaStream_t stream) {
  if (int bad = check_dims(T, k, n, r, E, rows_per_gate)) return bad;
  return launch_k5(x, a, b, gates, u, out, T, k, n, r, E, rows_per_gate,
                   stream);
}

// As moe_lora_delta_f32 with slots (T / rows_per_slot,) int32 in place
// of the gates and a u scratch of moe_lora_delta_slots_scratch(T, k, r)
// floats; every T takes the decode design.
extern "C" int moe_lora_delta_slots_f32(const void* x, const void* a,
                                        const void* b, const void* slots,
                                        void* u, void* out, int T, int k,
                                        int n, int r, int E,
                                        int rows_per_slot,
                                        cudaStream_t stream) {
  if (int bad = check_dims(T, k, n, r, E, rows_per_slot)) return bad;
  return launch_decode<true>(x, a, b, slots, u, out, T, k, n, r, E,
                             rows_per_slot, stream);
}
