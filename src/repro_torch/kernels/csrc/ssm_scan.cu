// Mamba-1 selective scan (K6), f32 arithmetic.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::ssm_scan (_ssm_kernel):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   h_0 = 0,
//   y_t = sum_n C_t[n] * h_t[:, n],
// with dt (Bt, S, di) f32, x (Bt, S, di), B and C (Bt, S, N), A (di, N)
// f32; returns y (Bt, S, di) in x's type and h_final (Bt, di, N) f32.
// x, B, C and y are all bf16 or all f32.  dt, x and y are contiguous; B
// and C are read in place with their own batch and sequence strides (unit
// stride over N): in the model they are column slices of x_proj's output
// (Bt, S, dt_rank + 2 N).
//
// Bound on the H100, two floors.  Bytes: at the serving shape (Bt 1,
// S 1,536, di 8,192, N 16) dt, x and y move ~101 MB, 0.030 ms at
// 3.35 TB/s.  Exponentials: the scan needs S * di * N = 201 M of them,
// and the special-function units (MUFU) give 16 a clock per SM: ~0.048
// ms on 132 SMs at 1,980 MHz.  The second floor is the higher, and the
// design spends one MUFU op per state-step and nothing else on that unit
// (moving exponentials onto the FMA pipe as polynomials would lower the
// floor; not done).  It does not reach the floor: with di * N = 131,072
// chains a request (the recurrence is sequential in t) there are 8 warps
// an SM, and ablations on the card put the rest of the time in
// instruction issue, shared-memory reads and the per-chunk barriers, not
// in the exponentials.
//
// Design:
//  - A thread owns 4 consecutive states of one channel in registers, so
//    a channel takes N / 4 lanes (4 at N = 16, 2 at N = 8) and a CTA of
//    128 threads 32 (64) channels: 256 CTAs at the serving shape, two on
//    each of 132 SMs.  The 4 recurrences of a thread are independent
//    chains, which gives the ILP that the few warps per SM do not.
//  - The decay is ex2.approx.ftz(dt * A log2 e), with A log2 e formed once
//    per (d, n); dt * x is formed in the scan.  The update is h =
//    fmaf(decay, h, (dt x) * B_t).
//  - y: a lane sums h * C over its 4 states in state order (P_q); the
//    N / 4 lanes of a channel then reduce-scatter the partials of N / 4
//    consecutive steps (3 shuffles per 4 steps at N = 16, 1 per 2 at
//    N = 8), so lane q ends with step q's y = (P0 + P2) + (P1 + P3)
//    (P0 + P1 at N = 8) and writes it to shared memory.
//  - The sequence runs in chunks of kSteps rows (64 at the serving shape;
//    fewer where the buffers below would pass 48 KB).  While chunk k is
//    scanned, chunk k + 1's dt, x, B and C rows are copied by 16-byte
//    cp.async into the other of two shared-memory buffers; then chunk
//    k's y rows go back with 16-byte stores.  B and C stay in their own
//    type there (bf16: half the bytes each thread reads a step) and are
//    widened in registers.  When di is no multiple of 8 or a pointer or
//    stride is not 16-byte aligned, a second instantiation moves the rows
//    element by element instead (no serving shape needs it).
//  - Rows past S are zeros: dt = 0 makes the decay exactly 1 and the
//    input 0, so a step over them leaves h as it is and the scan runs
//    whole groups of N / 4 steps.
//  - Chunk states (optional, for the backward K10, csrc/ssm_scan_bwd.cu):
//    with hc not null, the state entering every chunk of `chunk` steps,
//    h_{cC - 1} (zeros for c = 0), is written to hc (Bt, ceil(S / C), di,
//    N) f32 as the scan reaches step cC, from the registers that carry
//    it, at the start of a staged chunk (C is a multiple of kSteps).  With
//    hc null, as on every serving path, nothing else changes: y and
//    h_final are the same bits either way.
//  - No atomics and a fixed order of every sum: a call repeats bit for
//    bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bf16 values travel as their bits, so shared arrays hold plain types
using bf16bits = uint16_t;

constexpr int kThreads = 128;
constexpr int kStates = 4;       // states a thread
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16bits from_f32<bf16bits>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// kStates consecutive values at p (16-byte aligned f32, 8-byte bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[kStates]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load4(const bf16bits* p,
                                      float (&v)[kStates]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16 bytes from src, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// p[0 .. G) hold this lane's partial y of G consecutive steps (G = N / 4
// lanes a channel, consecutive lanes); returns the full y of step
// lane % G.  Every sum is (P0 + P2) + (P1 + P3) (G = 4) or P0 + P1
// (G = 2) whichever lane forms it, since a + b == b + a.
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&p)[G], int q) {
  if constexpr (G == 4) {
    const bool up = (q & 2) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float got = __shfl_xor_sync(0xffffffffu, up ? p[i] : p[i + 2], 2);
      p[i] = __fadd_rn(up ? p[i + 2] : p[i], got);
    }
  }
  const bool up = (q & 1) != 0;
  const float got = __shfl_xor_sync(0xffffffffu, up ? p[0] : p[1], 1);
  return __fadd_rn(up ? p[1] : p[0], got);
}

// Rows a chunk: 64, halved until the double-buffered dt, x, B and C
// tiles and the y tile fit in 48 KB of static shared memory.
template <typename T, int N>
__host__ __device__ constexpr int chunk_rows() {
  constexpr int kCh = kThreads / (N / kStates);
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kRowBytes =
      2 * (kCh * 4 + kCh * kSize + 2 * N * kSize) + kCh * kSize;
  int rows = 64;
  while (rows * kRowBytes > 48 * 1024) rows /= 2;
  return rows;
}

// grid (ceil(di / kCh), Bt), block kThreads; T is float or bf16bits.
// kVec: di % 8 == 0, and dt, x, y, B and C (pointers and strides)
// 16-byte aligned: rows move by 16-byte cp.async and stores; otherwise
// element by element.  The bound of 3 CTAs an SM (two run at the serving
// shape) is a register budget under which nvcc keeps more of the scan's
// loads in flight; on the H100 it ran faster than no bound.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 3) ssm_scan_kernel(
    const float* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const float* __restrict__ a, T* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ hc, int chunk, int S,
    int di, long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  constexpr int G = N / kStates;              // lanes a channel
  constexpr int kCh = kThreads / G;           // channels a CTA
  constexpr int kSteps = chunk_rows<T, N>();
  constexpr int kPerT = 16 / sizeof(T);       // values of T in 16 bytes
  __shared__ __align__(16) float s_dt[2][kSteps][kCh];
  __shared__ __align__(16) T s_x[2][kSteps][kCh];
  __shared__ __align__(16) T s_b[2][kSteps][N];
  __shared__ __align__(16) T s_c[2][kSteps][N];
  __shared__ __align__(16) T s_y[kSteps][kCh];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = tid / G, q = tid % G;
  const int d = d0 + ch;
  const size_t base = static_cast<size_t>(bi) * S * di;   // dt, x, y
  const T* bp = bm + bi * b_sb;
  const T* cp = cm + bi * c_sb;

  // dt, x, B and C rows [t0, t0 + kSteps) into buffer buf; rows past S
  // and channels past di are zeros
  auto stage = [&](int buf, int t0) {
    if constexpr (kVec) {
      constexpr int kDtSeg = kCh / 4, kXSeg = kCh / kPerT;
      for (int i = tid; i < kSteps * kDtSeg; i += kThreads) {
        const int t = i / kDtSeg, c = (i % kDtSeg) * 4;
        const bool ok = t0 + t < S && d0 + c < di;
        cp_async16(&s_dt[buf][t][c],
                   ok ? dt + base + static_cast<size_t>(t0 + t) * di + d0 + c
                      : dt, ok);
      }
      for (int i = tid; i < kSteps * kXSeg; i += kThreads) {
        const int t = i / kXSeg, c = (i % kXSeg) * kPerT;
        const bool ok = t0 + t < S && d0 + c < di;
        cp_async16(&s_x[buf][t][c],
                   ok ? x + base + static_cast<size_t>(t0 + t) * di + d0 + c
                      : x, ok);
      }
      constexpr int kSeg = N / kPerT;
      for (int i = tid; i < 2 * kSteps * kSeg; i += kThreads) {
        const bool is_c = i >= kSteps * kSeg;
        const int r = is_c ? i - kSteps * kSeg : i;
        const int t = r / kSeg, c = (r % kSeg) * kPerT;
        const bool ok = t0 + t < S;
        const T* src =
            is_c ? cp + (t0 + t) * c_ss + c : bp + (t0 + t) * b_ss + c;
        cp_async16(is_c ? &s_c[buf][t][c] : &s_b[buf][t][c], ok ? src : bm,
                   ok);
      }
    } else {
      for (int i = tid; i < kSteps * kCh; i += kThreads) {
        const int t = i / kCh, c = i % kCh;
        const bool ok = t0 + t < S && d0 + c < di;
        const size_t off = base + static_cast<size_t>(t0 + t) * di + d0 + c;
        s_dt[buf][t][c] = ok ? dt[off] : 0.f;
        s_x[buf][t][c] = ok ? x[off] : T(0);
      }
      for (int i = tid; i < kSteps * N; i += kThreads) {
        const int t = i / N, n = i % N;
        const bool ok = t0 + t < S;
        s_b[buf][t][n] = ok ? bp[(t0 + t) * b_ss + n] : T(0);
        s_c[buf][t][n] = ok ? cp[(t0 + t) * c_ss + n] : T(0);
      }
    }
  };
  // y rows [t0, t0 + steps)
  auto write_y = [&](int t0, int steps) {
    if constexpr (kVec) {
      constexpr int kYSeg = kCh / kPerT;
      for (int i = tid; i < steps * kYSeg; i += kThreads) {
        const int t = i / kYSeg, c = (i % kYSeg) * kPerT;
        if (d0 + c < di)
          *reinterpret_cast<uint4*>(
              y + base + static_cast<size_t>(t0 + t) * di + d0 + c) =
              *reinterpret_cast<const uint4*>(&s_y[t][c]);
      }
    } else {
      for (int i = tid; i < steps * kCh; i += kThreads) {
        const int t = i / kCh, c = i % kCh;
        if (d0 + c < di)
          y[base + static_cast<size_t>(t0 + t) * di + d0 + c] =
              s_y[t][c];
      }
    }
  };

  float a2[kStates], h[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    a2[j] = d < di ? a[static_cast<size_t>(d) * N + q * kStates + j] * kLog2e
                   : 0.f;
    h[j] = 0.f;
  }

  const int chunks = (S + kSteps - 1) / kSteps;
  stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * kSteps;
    if (hc != nullptr && t0 % chunk == 0 && d < di) {
      const int n_c = (S + chunk - 1) / chunk;
      *reinterpret_cast<float4*>(
          hc + ((static_cast<size_t>(bi) * n_c + t0 / chunk) * di + d) * N +
          q * kStates) = make_float4(h[0], h[1], h[2], h[3]);
    }
    // buffer buf ^ 1 was last read by chunk k - 1's scan, before the
    // barrier that ended it
    if (k + 1 < chunks) stage(buf ^ 1, t0 + kSteps);
    cp_async_commit();
    cp_async_wait1();             // chunk k's rows have landed
    __syncthreads();
    const int steps = min(kSteps, S - t0);
#pragma unroll 2
    for (int t = 0; t < steps; t += G) {
      float p[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float dtv = s_dt[buf][t + j][ch];
        const float dx = __fmul_rn(dtv, to_f32(s_x[buf][t + j][ch]));
        float bv[kStates], cv[kStates];
        load4(&s_b[buf][t + j][q * kStates], bv);
        load4(&s_c[buf][t + j][q * kStates], cv);
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < kStates; ++m) {
          h[m] = fmaf(ex2(__fmul_rn(dtv, a2[m])), h[m], __fmul_rn(dx, bv[m]));
          s = m == 0 ? __fmul_rn(h[m], cv[m]) : fmaf(h[m], cv[m], s);
        }
        p[j] = s;
      }
      s_y[t + q][ch] = from_f32<T>(reduce_scatter<G>(p, q));
    }
    __syncthreads();
    write_y(t0, steps);
    // s_y is written again only after the next chunk's first barrier
  }
  if (d < di)
    *reinterpret_cast<float4*>(
        h_out + (static_cast<size_t>(bi) * di + d) * N + q * kStates) =
        make_float4(h[0], h[1], h[2], h[3]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, void* y, void* h, void* hc, int chunk, int batch,
             int S, int di, long long b_sb, long long b_ss, long long c_sb,
             long long c_ss, cudaStream_t stream) {
  constexpr int kCh = kThreads / (N / kStates);
  constexpr long long kPerT = 16 / sizeof(T);
  if (hc != nullptr &&
      (chunk <= 0 || chunk % chunk_rows<T, N>() != 0 || !aligned16(hc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = di % 8 == 0 && aligned16(dt) && aligned16(x) &&
                   aligned16(y) && aligned16(bm) && aligned16(cm) &&
                   b_sb % kPerT == 0 && b_ss % kPerT == 0 &&
                   c_sb % kPerT == 0 && c_ss % kPerT == 0;
  dim3 grid((di + kCh - 1) / kCh, batch);
  auto kernel =
      vec ? ssm_scan_kernel<T, N, true> : ssm_scan_kernel<T, N, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h), static_cast<float*>(hc), chunk, S, di, b_sb,
      b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, void* y, void* h, void* hc, int chunk, int batch,
           int S, int di, int N, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || di <= 0 || !aligned16(h))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {     // falcon-mamba-7b's state size and its reduced one
    case 8:
      return launch_n<T, 8>(dt, x, bm, cm, a, y, h, hc, chunk, batch, S, di,
                            b_sb, b_ss, c_sb, c_ss, stream);
    case 16:
      return launch_n<T, 16>(dt, x, bm, cm, a, y, h, hc, chunk, batch, S, di,
                             b_sb, b_ss, c_sb, c_ss, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dt (batch, S, di) f32 and x (batch, S, di) contiguous; B and C element
// [b, t, n] at b * b_sb + t * b_ss + n (likewise c_*); a (di, N) f32
// contiguous; y (batch, S, di) and h (batch, di, N) f32 written, h 16-byte
// aligned.  hc, when not null, receives the chunk states (batch,
// ceil(S / chunk), di, N) f32 (16-byte aligned; chunk a multiple of 64).
// N in {8, 16}; any S >= 1 and di >= 1.  Returns 0 or a cudaError_t.
extern "C" int ssm_scan_f32(const void* dt, const void* x, const void* bm,
                            const void* cm, const void* a, void* y, void* h,
                            void* hc, int chunk, int batch, int S, int di,
                            int N, long long b_sb, long long b_ss,
                            long long c_sb, long long c_ss,
                            cudaStream_t stream) {
  return launch<float>(dt, x, bm, cm, a, y, h, hc, chunk, batch, S, di, N,
                       b_sb, b_ss, c_sb, c_ss, stream);
}

// As ssm_scan_f32 with x, B, C and y in bf16.
extern "C" int ssm_scan_bf16(const void* dt, const void* x, const void* bm,
                             const void* cm, const void* a, void* y, void* h,
                             void* hc, int chunk, int batch, int S, int di,
                             int N, long long b_sb, long long b_ss,
                             long long c_sb, long long c_ss,
                             cudaStream_t stream) {
  return launch<bf16bits>(dt, x, bm, cm, a, y, h, hc, chunk, batch, S, di,
                          N, b_sb, b_ss, c_sb, c_ss, stream);
}
