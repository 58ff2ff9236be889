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
// At decode (T < 64, and every K4 call):
//  1. down: u[t, j, :] = x[t] A_j^T (times the gate for K5), into an f32
//     scratch (T, E, r) (K4: (T, r)).  A CTA of 8 warps takes one row
//     and 8 ranks of one expert; one warp per rank, its lanes stride over
//     k 8 elements a lane at a time and accumulate with fmaf in order,
//     then a butterfly over the warp.  The row's x is staged through
//     shared memory 256 columns at a time (one 16-byte load a thread), so
//     the 8 warps read it from L2 once; rows, experts and ranks spread
//     over SMs.
//  2. up: out[t, c] = sum_j sum_i u[t, j, i] B_j[c, i], one thread per
//     output column c for 32 rows, u of the rows in shared memory: for
//     each expert, four ranks of B_j[c, :] are loaded once (16 bytes) and
//     applied to every row, j outer, i inner, fmaf in order.
// Both kernels run the same routines (down_block, up4) in the same order
// over k and over r, so a gate of exactly 1.0 multiplies nothing away and
// a gate of 0.0 adds exact zeros: K5 on one-hot gate rows returns K4's
// output bit for bit.
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
// Registers and shared memory (ptxas, sm_90a, nvcc 12.9): down 109
// registers, 25,600 B; up 128 registers (the cap of two CTAs of 256 per
// SM), 98,304 B dynamic + 400 B; no spills in either.
// Zero gates: where all rows of a tile share one gate row (rows_per_gate
// >= the tile, as at admission), an expert whose gate is exactly 0 is
// skipped in both passes: the down pass writes 0 for its columns and the
// up pass leaves its r inner columns out of the sum.  Leaving out
// fmaf(0, b, acc) keeps the sum bit-identical for finite B, and the
// order of every sum depends on k, r and the experts kept alone, so a
// gate of 0 gives the output of a bank without that expert.  A tile that
// straddles two gate rows computes every expert.  Grouping rows by slot
// (a segmented GEMM) and 3xTF32 tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;    // x columns staged per step of the down pass
constexpr int kUpRows = 32;    // rows per CTA of the up pass
constexpr int kUpCols = kThreads;

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

// x . a over k for one row x, computed by one warp, x staged through sx
// (shared, kChunk); every lane returns the full sum.  Lane l takes
// elements [8 l + 256 m, 8 l + 256 m + 8) in order of m, so the order of
// the sum depends on k alone.  Every thread of the CTA must call it (it
// stages x with barriers); a warp with no rank passes a == nullptr and
// only helps stage.
__device__ __forceinline__ float down_block(const bf16* __restrict__ x,
                                            int k,
                                            const float* __restrict__ a,
                                            bf16* sx) {
  constexpr int kVec = 8;                       // bf16 per 16 bytes
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int c = threadIdx.x * kVec; c < kChunk; c += kThreads * kVec)
      if (k0 + c < k)
        *reinterpret_cast<uint4*>(sx + c) =
            *reinterpret_cast<const uint4*>(x + k0 + c);
    __syncthreads();
    const int kk = k0 + lane * 8;
    if (a != nullptr && kk < k) {
      float av[8], xv[8];
      load8(a + kk, av);
      load8(sx + lane * 8, xv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = __fmaf_rn(xv[i], av[i], acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

// acc = fmaf(u[i], b[i], acc) for i = 0 .. 3 in order: four ranks of one
// expert's share of an output.
__device__ __forceinline__ float up4(float4 u, float4 b, float acc) {
  acc = __fmaf_rn(u.x, b.x, acc);
  acc = __fmaf_rn(u.y, b.y, acc);
  acc = __fmaf_rn(u.z, b.z, acc);
  return __fmaf_rn(u.w, b.w, acc);
}

// K5 down at decode: grid (T, E * ceil(r / kWarps)); warp w of CTA
// (t, j * rb + q) computes rank q * kWarps + w of expert j for row t.
// u (T, E, r) = gate * x A_j^T.
__global__ void __launch_bounds__(kThreads) k5_down(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ gates, float* __restrict__ u, int k, int r,
    int E, int rows_per_gate) {
  __shared__ __align__(16) bf16 sm[kChunk];
  const int rb = (r + kWarps - 1) / kWarps;
  const int j = blockIdx.y / rb;
  const int rr = (blockIdx.y % rb) * kWarps + (threadIdx.x >> 5);
  const int t = blockIdx.x;
  const float acc = down_block(
      x + static_cast<size_t>(t) * k, k,
      rr < r ? a + (static_cast<size_t>(j) * r + rr) * k : nullptr, sm);
  if (rr >= r || (threadIdx.x & 31) != 0) return;
  const float g = gates[static_cast<size_t>(t / rows_per_gate) * E + j];
  u[(static_cast<size_t>(t) * E + j) * r + rr] = __fmul_rn(acc, g);
}

// K4 down: grid (T, ceil(r / kWarps)); u (T, r) = x[t] A_s^T, nothing
// for a row whose slot is negative.
__global__ void __launch_bounds__(kThreads) k4_down(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const int32_t* __restrict__ slots, float* __restrict__ u, int k, int r,
    int E, int rows_per_slot) {
  __shared__ __align__(16) bf16 sm[kChunk];
  const int t = blockIdx.x;
  const int rr = blockIdx.y * kWarps + (threadIdx.x >> 5);
  int s = slots[t / rows_per_slot];
  if (s < 0) return;                            // the whole CTA
  s = min(s, E - 1);
  const float acc = down_block(
      x + static_cast<size_t>(t) * k, k,
      rr < r ? a + (static_cast<size_t>(s) * r + rr) * k : nullptr, sm);
  if (rr < r && (threadIdx.x & 31) == 0)
    u[static_cast<size_t>(t) * r + rr] = acc;
}

// K5 up: grid (ceil(n / kUpCols), ceil(T / kUpRows)).
__global__ void __launch_bounds__(kThreads) k5_up(
    const float* __restrict__ u, const float* __restrict__ b,
    float* __restrict__ out, int T, int n, int r, int E) {
  extern __shared__ __align__(16) float su[];   // kUpRows x E x r
  const int t0 = blockIdx.y * kUpRows;
  const int nrows = min(kUpRows, T - t0);
  const int er = E * r;
  for (int i = threadIdx.x; i < nrows * er; i += kThreads)
    su[i] = u[static_cast<size_t>(t0) * er + i];
  __syncthreads();
  const int c = blockIdx.x * kUpCols + threadIdx.x;
  if (c >= n) return;
  float acc[kUpRows];
#pragma unroll
  for (int t = 0; t < kUpRows; ++t) acc[t] = 0.f;
  for (int j = 0; j < E; ++j) {
    const float* bj = b + (static_cast<size_t>(j) * n + c) * r;
    for (int i = 0; i < r; i += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(bj + i);
#pragma unroll
      for (int t = 0; t < kUpRows; ++t)
        if (t < nrows)
          acc[t] = up4(*reinterpret_cast<const float4*>(su + t * er + j * r +
                                                        i),
                       bv, acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kUpRows; ++t)
    if (t < nrows) out[static_cast<size_t>(t0 + t) * n + c] = acc[t];
}

// K4 up: grid (ceil(n / kUpCols), ceil(T / kUpRows)).
__global__ void __launch_bounds__(kThreads) k4_up(
    const float* __restrict__ u, const float* __restrict__ b,
    const int32_t* __restrict__ slots, float* __restrict__ out, int T, int n,
    int r, int E, int rows_per_slot) {
  extern __shared__ __align__(16) float su[];   // kUpRows x r
  const int t0 = blockIdx.y * kUpRows;
  const int nrows = min(kUpRows, T - t0);
  for (int i = threadIdx.x; i < nrows * r; i += kThreads) {
    const int t = t0 + i / r;
    // a row without an adapter has no u; keep its garbage out of shared
    su[i] = slots[t / rows_per_slot] < 0 ? 0.f
                                         : u[static_cast<size_t>(t0) * r + i];
  }
  __syncthreads();
  const int c = blockIdx.x * kUpCols + threadIdx.x;
  if (c >= n) return;
  for (int t = 0; t < nrows; ++t) {
    const int s = slots[(t0 + t) / rows_per_slot];
    float acc = 0.f;
    if (s >= 0) {
      const float* bs = b + (static_cast<size_t>(min(s, E - 1)) * n + c) * r;
      for (int i = 0; i < r; i += 4)
        acc = up4(*reinterpret_cast<const float4*>(su + t * r + i),
                  *reinterpret_cast<const float4*>(bs + i), acc);
    }
    out[static_cast<size_t>(t0 + t) * n + c] = acc;
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
constexpr int kSMs = 132;
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

int check_dims(int T, int k, int n, int r, int E, int rows_per) {
  if (T <= 0 || k <= 0 || n <= 0 || r <= 0 || E <= 0 || rows_per <= 0 ||
      k % 8 != 0 || r % 4 != 0 ||
      static_cast<size_t>(kUpRows) * E * r * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
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
  if (T < 64) {
    dim3 grid(T, E * ((r + kWarps - 1) / kWarps));
    k5_down<<<grid, kThreads, 0, stream>>>(xp, ap, gp, up, k, r, E,
                                           rows_per_gate);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid_up((n + kUpCols - 1) / kUpCols, (T + kUpRows - 1) / kUpRows);
    const size_t smem = sizeof(float) * kUpRows * E * r;
    k5_up<<<grid_up, kThreads, smem, stream>>>(up, bp, op, T, n, r, E);
    return static_cast<int>(cudaGetLastError());
  }
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

int launch_k4(const void* x, const void* a, const void* b, const void* slots,
              void* u, void* out, int T, int k, int n, int r, int E,
              int rows_per_slot, cudaStream_t stream) {
  const int32_t* sp = static_cast<const int32_t*>(slots);
  float* up = static_cast<float*>(u);
  dim3 grid(T, (r + kWarps - 1) / kWarps);
  k4_down<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), sp, up, k, r,
      E, rows_per_slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_up((n + kUpCols - 1) / kUpCols, (T + kUpRows - 1) / kUpRows);
  const size_t smem = sizeof(float) * kUpRows * r;
  k4_up<<<grid_up, kThreads, smem, stream>>>(
      up, static_cast<const float*>(b), sp, static_cast<float*>(out), T, n, r,
      E, rows_per_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of f32 scratch K5 needs: u (T, E, r) at decode, the down pass's
// parts (splits, T, E, r) at an admission prefill.
extern "C" long long moe_lora_delta_scratch(int T, int k, int r, int E) {
  const long long er = static_cast<long long>(E) * r;
  return (T < 64 ? 1 : down_splits(T, k, static_cast<int>(er))) * T * er;
}

// x (T, k) contiguous bf16, 16-byte aligned; a (E, r, k), b (E, n, r),
// gates (T / rows_per_gate, E), out (T, n): contiguous f32; u: f32
// scratch of moe_lora_delta_scratch(T, k, r, E) floats.  k % 8 == 0,
// r % 4 == 0, 32 * E * r floats must fit 48 KB.  Returns 0 or a
// cudaError_t.
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
// of the gates and a u scratch of T * r floats.
extern "C" int moe_lora_delta_slots_f32(const void* x, const void* a,
                                        const void* b, const void* slots,
                                        void* u, void* out, int T, int k,
                                        int n, int r, int E,
                                        int rows_per_slot,
                                        cudaStream_t stream) {
  if (int bad = check_dims(T, k, n, r, E, rows_per_slot)) return bad;
  return launch_k4(x, a, b, slots, u, out, T, k, n, r, E, rows_per_slot,
                   stream);
}
