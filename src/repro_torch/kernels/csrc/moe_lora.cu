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
// Design (simple first): two launches per call, both in this file.
//  1. down: u[t, j, :] = x[t] A_j^T (times the gate for K5), into an f32
//     scratch (T, E, r) (K4: (T, r)).  A CTA of 8 warps takes NR rows
//     and 8 ranks of one expert; one warp per rank, its lanes stride over
//     k 8 elements a lane at a time and accumulate with fmaf in order,
//     then a butterfly over the warp.  The rows' x is staged through
//     shared memory 256 columns at a time (one 16-byte load a thread), so
//     the 8 warps read it from L2 once.  K5 takes NR = 16 rows when T is
//     large, so each A row is read once for 16 rows; at decode (and in
//     K4, where rows differ in slot) NR = 1, spreading the rows, experts
//     and ranks over SMs.
//  2. up: out[t, c] = sum_j sum_i u[t, j, i] B_j[c, i], one thread per
//     output column c for 32 rows, u of the rows in shared memory: for
//     each expert, four ranks of B_j[c, :] are loaded once (16 bytes) and
//     applied to every row, j outer, i inner, fmaf in order.
// Both kernels run the same routines (down_block, up4) in the same order
// over k and over r, so a gate of exactly 1.0 multiplies nothing away and
// a gate of 0.0 adds exact zeros: K5 on one-hot gate rows returns K4's
// output bit for bit, whatever T.  Grouping rows by slot (a segmented
// GEMM) and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;    // x columns staged per step of the down pass
constexpr int kDownRows = 16;  // rows per CTA of K5's down pass at large T
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

// acc[t] = x[t] . a over k for NR rows of x (row stride k), computed by
// one warp, x staged through sx (shared, NR x kChunk); every lane
// returns the full sums.  Lane l takes elements
// [8 l + 256 m, 8 l + 256 m + 8) in order of m; rows past nrows are
// skipped.  The order of every sum depends on k alone.  Every thread of
// the CTA must call it (it stages x with barriers); a warp with no rank
// passes a == nullptr and only helps stage.
template <int NR>
__device__ __forceinline__ void down_block(const bf16* __restrict__ x,
                                           int nrows, int k,
                                           const float* __restrict__ a,
                                           bf16* sx, float acc[NR]) {
  constexpr int kVec = 8;                       // bf16 per 16 bytes
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NR; ++t) acc[t] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int v = threadIdx.x; v < NR * kChunk / kVec; v += kThreads) {
      const int t = v * kVec / kChunk, c = v * kVec % kChunk;
      if (t < nrows && k0 + c < k)
        *reinterpret_cast<uint4*>(sx + t * kChunk + c) =
            *reinterpret_cast<const uint4*>(x + static_cast<size_t>(t) * k +
                                            k0 + c);
    }
    __syncthreads();
    const int kk = k0 + lane * 8;
    if (a != nullptr && kk < k) {
      float av[8];
      load8(a + kk, av);
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        if (t < nrows) {
          float xv[8];
          load8(sx + t * kChunk + lane * 8, xv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[t] = __fmaf_rn(xv[i], av[i], acc[t]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < NR; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[t] = __fadd_rn(acc[t], __shfl_xor_sync(0xffffffffu, acc[t], off));
  }
}

// acc = fmaf(u[i], b[i], acc) for i = 0 .. 3 in order: four ranks of one
// expert's share of an output.
__device__ __forceinline__ float up4(float4 u, float4 b, float acc) {
  acc = __fmaf_rn(u.x, b.x, acc);
  acc = __fmaf_rn(u.y, b.y, acc);
  acc = __fmaf_rn(u.z, b.z, acc);
  return __fmaf_rn(u.w, b.w, acc);
}

// K5 down: grid (ceil(T / NR), E * ceil(r / kWarps)); warp w of CTA
// (tb, j * rb + q) computes rank q * kWarps + w of expert j for rows
// [tb NR, tb NR + NR).  u (T, E, r) = gate * x A_j^T.
template <int NR>
__global__ void __launch_bounds__(kThreads) k5_down(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ gates, float* __restrict__ u, int T, int k,
    int r, int E, int rows_per_gate) {
  __shared__ __align__(16) bf16 sm[NR * kChunk];
  const int rb = (r + kWarps - 1) / kWarps;
  const int j = blockIdx.y / rb;
  const int rr = (blockIdx.y % rb) * kWarps + (threadIdx.x >> 5);
  const int t0 = blockIdx.x * NR;
  const int nrows = min(NR, T - t0);
  float acc[NR];
  down_block<NR>(x + static_cast<size_t>(t0) * k, nrows, k,
                 rr < r ? a + (static_cast<size_t>(j) * r + rr) * k : nullptr,
                 sm, acc);
  if (rr >= r || (threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int t = 0; t < NR; ++t) {
    if (t < nrows) {
      const int row = t0 + t;
      const float g = gates[static_cast<size_t>(row / rows_per_gate) * E + j];
      u[(static_cast<size_t>(row) * E + j) * r + rr] = __fmul_rn(acc[t], g);
    }
  }
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
  float acc[1];
  down_block<1>(x + static_cast<size_t>(t) * k, 1, k,
                rr < r ? a + (static_cast<size_t>(s) * r + rr) * k : nullptr,
                sm, acc);
  if (rr < r && (threadIdx.x & 31) == 0)
    u[static_cast<size_t>(t) * r + rr] = acc[0];
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
  const int rb = (r + kWarps - 1) / kWarps;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* gp = static_cast<const float*>(gates);
  float* up = static_cast<float*>(u);
  if (T >= 64) {
    dim3 grid((T + kDownRows - 1) / kDownRows, E * rb);
    k5_down<kDownRows><<<grid, kThreads, 0, stream>>>(
        xp, ap, gp, up, T, k, r, E, rows_per_gate);
  } else {
    dim3 grid(T, E * rb);
    k5_down<1><<<grid, kThreads, 0, stream>>>(xp, ap, gp, up, T, k, r, E,
                                              rows_per_gate);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_up((n + kUpCols - 1) / kUpCols, (T + kUpRows - 1) / kUpRows);
  const size_t smem = sizeof(float) * kUpRows * E * r;
  k5_up<<<grid_up, kThreads, smem, stream>>>(
      up, static_cast<const float*>(b), static_cast<float*>(out), T, n, r, E);
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

// x (T, k) contiguous bf16, 16-byte aligned; a (E, r, k), b (E, n, r),
// gates (T / rows_per_gate, E), out (T, n): contiguous f32; u: f32
// scratch of T * E * r.  k % 8 == 0, r % 4 == 0, 32 * E * r floats must
// fit 48 KB.  Returns 0 or a cudaError_t.
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
