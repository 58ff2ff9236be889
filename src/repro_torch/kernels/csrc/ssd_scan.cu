// Mamba-2 / SSD scan (K11), f32 arithmetic.
//
// Replaces the chunked SSD scan that the reference computes in jnp
// (src/repro/models/ssm.py:171-189, _ssd_chunk, driven at :228-240); it
// has no Pallas original.  The function is the recurrence the chunk form
// computes, per head h of P channels and N states:
//   h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * x_t (outer) B_t,   h_0 = 0,
//   y_t[p] = sum_n h_t[p, n] * C_t[n],
// with x (Bt, S, H, P) and B, C (Bt, S, G, N) in one type (bf16 or f32;
// head h reads group h / (H / G)), dt (Bt, S, H) and a (H,) f32; it
// returns y (Bt, S, H, P) f32 (the D skip is the caller's) and h_final
// (Bt, H, P, N) f32 for the decode cache; when the optional hc pointer is
// not null, also the state entering every chunk of 64 steps, hc (Bt,
// ceil(S / 64), H, P, N) f32, from which K12 (csrc/ssd_scan_bwd.cu)
// recomputes the states of the training backward.  Serving calls pass it
// null; y and h_final do not depend on it.  x, B and C are read in place
// with their own batch and sequence strides: in the model all three are
// column slices of the causal conv's output (Bt, S, H * P + 2 G N), so
// x's head stride is P and B's and C's group stride N, each with a unit
// stride over its last axis.
//
// Bound on the H100 at zamba2-7b's serving shape (Bt 1, S 1,536, H 112,
// P 64, N 64, G 1): bytes ~69 MB (x 22.0 MB bf16, y 44.0 MB f32, the
// rest small) over 3.35 TB/s = 0.021 ms; operations 3 FMAs a state-step
// (the decayed update, dt x B and y's product) over 704.6 M state-steps,
// 4.23 GFLOP over the 67 TFLOP/s f32 peak = 0.063 ms.  The second floor
// is the higher.  The decay is one exponential a (step, head), which the
// special-function units do not feel.
//
// Design (a simple one; a chunked tensor-core form is later work):
//  - One CTA of 128 threads per (row, head, slice of 32 channels): 224
//    CTAs at the serving shape.  Four consecutive lanes share a channel
//    p, and lane q owns the N / 4 consecutive states [q N / 4, (q + 1)
//    N / 4) of it in registers (16 at N = 64), independent FMA chains.
//  - The sequence runs in chunks of kSteps rows (32 at N = 64).  While
//    chunk k is scanned, chunk k + 1's dt, x, B and C rows are copied by
//    cp.async into the other of two shared-memory buffers (16-byte
//    copies for x, B and C, 4-byte ones for dt, whose rows are H apart);
//    B and C stay in their own type there and are widened in registers.
//    When a pointer or stride is not 16-byte aligned (or P, N not a
//    multiple of 8), a second instantiation moves them element by element.
//  - The decay exp(dt_t a_h) is formed once per (step, head), by one
//    thread a step after the chunk lands, into shared memory.
//  - y: a lane sums h * C over its states in state order (P_q); the four
//    lanes of a channel then reduce-scatter the partials of four
//    consecutive steps by warp shuffles, so lane q ends with step q's y =
//    (P0 + P2) + (P1 + P3) and writes it to shared memory; chunk k's y
//    rows go back with 16-byte stores.  No atomics and a fixed order of
//    every sum: a call repeats bit for bit.
//  - Rows past S are zeros: dt = 0 makes the decay exactly 1 and the
//    input 0, so a step over them leaves h as it is, and the scan runs
//    whole groups of four steps.  Channels past P do no work and write
//    nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16bits = uint16_t;

constexpr int kThreads = 128;
constexpr int kLanes = 4;                    // lanes a channel
constexpr int kChannels = kThreads / kLanes;  // channels a CTA
constexpr int kStateChunk = 64;              // steps between saved states

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// K consecutive values of T at p (aligned to K * sizeof(T) bytes, up to
// 16) widened to f32
template <int K>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      v[i] = r.x;
      v[i + 1] = r.y;
      v[i + 2] = r.z;
      v[i + 3] = r.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}
__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
template <int K>
__device__ __forceinline__ void load_vals(const bf16bits* p, float (&v)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(p + i);
      unpack2(r.x, v + i);
      unpack2(r.y, v + i + 2);
      unpack2(r.z, v + i + 4);
      unpack2(r.w, v + i + 6);
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2)
      unpack2(*reinterpret_cast<const uint32_t*>(p + i), v + i);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = to_f32(p[i]);
  }
}

// `bytes` (4 or 16) from src, or zeros when !valid (src is then not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// p[0..4) hold this lane's partial y of four consecutive steps (the four
// lanes of a channel are consecutive); returns the full y of step q =
// lane % 4, summed as (P0 + P2) + (P1 + P3) whichever lane forms it.
__device__ __forceinline__ float reduce_scatter4(float (&p)[4], int q) {
  const bool up2 = (q & 2) != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float got = __shfl_xor_sync(0xffffffffu, up2 ? p[i] : p[i + 2], 2);
    p[i] = __fadd_rn(up2 ? p[i + 2] : p[i], got);
  }
  const bool up1 = (q & 1) != 0;
  const float got = __shfl_xor_sync(0xffffffffu, up1 ? p[0] : p[1], 1);
  return __fadd_rn(up1 ? p[1] : p[0], got);
}

// Steps a chunk: 64, halved until the double-buffered dt, x, B and C
// rows, the decays and the y rows fit in 48 KB of static shared memory.
template <typename T, int N>
__host__ __device__ constexpr int chunk_steps() {
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kRowBytes =
      2 * (4 + 4 + kChannels * kSize + 2 * N * kSize) + kChannels * 4;
  int steps = 64;
  while (steps * kRowBytes > 48 * 1024) steps /= 2;
  return steps;
}

// grid (H * ceil(P / kChannels), Bt), block kThreads.  kVec: the 16-byte
// staging path (see launch_n); otherwise element by element.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a, float* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ hc, int S, int H, int P,
    int G, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss) {
  constexpr int kSt = N / kLanes;              // states a lane
  constexpr int kSteps = chunk_steps<T, N>();
  constexpr int kPerT = 16 / sizeof(T);        // values of T in 16 bytes
  __shared__ __align__(16) float s_dt[2][kSteps];
  __shared__ __align__(16) float s_dec[2][kSteps];
  __shared__ __align__(16) T s_x[2][kSteps][kChannels];
  __shared__ __align__(16) T s_b[2][kSteps][N];
  __shared__ __align__(16) T s_c[2][kSteps][N];
  __shared__ __align__(16) float s_y[kSteps][kChannels];

  const int tid = threadIdx.x;
  const int slices = (P + kChannels - 1) / kChannels;
  const int hh = blockIdx.x / slices;
  const int p0 = (blockIdx.x % slices) * kChannels;
  const int bi = blockIdx.y;
  const int grp = hh / (H / G);
  const int ch = tid / kLanes, q = tid % kLanes;
  const int p = p0 + ch;
  const float a_h = a[hh];
  const T* xp = x + bi * x_sb + static_cast<long long>(hh) * P + p0;
  const T* bp = bm + bi * b_sb + static_cast<long long>(grp) * N;
  const T* cp = cm + bi * c_sb + static_cast<long long>(grp) * N;
  const float* dtp = dt + static_cast<long long>(bi) * S * H + hh;
  const int width = min(kChannels, P - p0);    // live channels

  // dt, x, B and C rows [t0, t0 + kSteps) into buffer buf; rows past S
  // and channels past P are zeros
  auto stage = [&](int buf, int t0) {
    if constexpr (kVec) {
      for (int i = tid; i < kSteps; i += kThreads) {
        const bool ok = t0 + i < S;
        cp_async<4>(&s_dt[buf][i], ok ? dtp + static_cast<long long>(t0 + i) * H
                                      : dt, ok);
      }
      constexpr int kXSeg = kChannels / kPerT;
      for (int i = tid; i < kSteps * kXSeg; i += kThreads) {
        const int t = i / kXSeg, c = (i % kXSeg) * kPerT;
        const bool ok = t0 + t < S && c < width;
        cp_async<16>(&s_x[buf][t][c], ok ? xp + (t0 + t) * x_ss + c : x, ok);
      }
      constexpr int kSeg = N / kPerT;
      for (int i = tid; i < 2 * kSteps * kSeg; i += kThreads) {
        const bool is_c = i >= kSteps * kSeg;
        const int r = is_c ? i - kSteps * kSeg : i;
        const int t = r / kSeg, c = (r % kSeg) * kPerT;
        const bool ok = t0 + t < S;
        const T* src =
            is_c ? cp + (t0 + t) * c_ss + c : bp + (t0 + t) * b_ss + c;
        cp_async<16>(is_c ? &s_c[buf][t][c] : &s_b[buf][t][c],
                     ok ? src : bm, ok);
      }
    } else {
      for (int i = tid; i < kSteps; i += kThreads)
        s_dt[buf][i] =
            t0 + i < S ? dtp[static_cast<long long>(t0 + i) * H] : 0.f;
      for (int i = tid; i < kSteps * kChannels; i += kThreads) {
        const int t = i / kChannels, c = i % kChannels;
        const bool ok = t0 + t < S && c < width;
        s_x[buf][t][c] = ok ? xp[(t0 + t) * x_ss + c] : T(0);
      }
      for (int i = tid; i < kSteps * N; i += kThreads) {
        const int t = i / N, n = i % N;
        const bool ok = t0 + t < S;
        s_b[buf][t][n] = ok ? bp[(t0 + t) * b_ss + n] : T(0);
        s_c[buf][t][n] = ok ? cp[(t0 + t) * c_ss + n] : T(0);
      }
    }
  };
  // y rows [t0, t0 + steps) of the live channels
  auto write_y = [&](int t0, int steps) {
    float* yp = y + (static_cast<size_t>(bi) * S * H + hh) * P + p0;
    if (kVec && width == kChannels) {
      constexpr int kYSeg = kChannels / 4;
      for (int i = tid; i < steps * kYSeg; i += kThreads) {
        const int t = i / kYSeg, c = (i % kYSeg) * 4;
        *reinterpret_cast<float4*>(
            yp + static_cast<size_t>(t0 + t) * H * P + c) =
            *reinterpret_cast<const float4*>(&s_y[t][c]);
      }
    } else {
      for (int i = tid; i < steps * kChannels; i += kThreads) {
        const int t = i / kChannels, c = i % kChannels;
        if (c < width) yp[static_cast<size_t>(t0 + t) * H * P + c] = s_y[t][c];
      }
    }
  };

  float hs[kSt];
#pragma unroll
  for (int m = 0; m < kSt; ++m) hs[m] = 0.f;

  const int chunks = (S + kSteps - 1) / kSteps;
  const int n_hc = (S + kStateChunk - 1) / kStateChunk;
  static_assert(kStateChunk % kSteps == 0, "state chunk");
  stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * kSteps;
    if (hc != nullptr && t0 % kStateChunk == 0 && p < P) {
      // the state entering this 64-step chunk, K12's starting point
      const size_t chunk = static_cast<size_t>(bi) * n_hc + t0 / kStateChunk;
      float* hp = hc + ((chunk * H + hh) * P + p) * N + q * kSt;
#pragma unroll
      for (int m = 0; m < kSt; ++m) hp[m] = hs[m];
    }
    // buffer buf ^ 1 was last read by chunk k - 1's scan, before the
    // barrier that ended it
    if (k + 1 < chunks) stage(buf ^ 1, t0 + kSteps);
    cp_async_commit();
    cp_async_wait1();             // chunk k's rows have landed
    __syncthreads();
    for (int i = tid; i < kSteps; i += kThreads)
      s_dec[buf][i] = expf(s_dt[buf][i] * a_h);
    __syncthreads();
    const int steps = min(kSteps, S - t0);
    for (int t = 0; t < steps; t += kLanes) {
      float part[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const float dec = s_dec[buf][t + j];
        const float dx = __fmul_rn(s_dt[buf][t + j], to_f32(s_x[buf][t + j][ch]));
        float bv[kSt], cv[kSt];
        load_vals<kSt>(&s_b[buf][t + j][q * kSt], bv);
        load_vals<kSt>(&s_c[buf][t + j][q * kSt], cv);
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < kSt; ++m) {
          hs[m] = fmaf(dec, hs[m], __fmul_rn(dx, bv[m]));
          s = m == 0 ? __fmul_rn(hs[m], cv[m]) : fmaf(hs[m], cv[m], s);
        }
        part[j] = s;
      }
      s_y[t + q][ch] = reduce_scatter4(part, q);
    }
    __syncthreads();
    write_y(t0, steps);
    // s_y is written again only after the next chunk's barriers
  }
  if (p < P) {
    float* hp = h_out + ((static_cast<size_t>(bi) * H + hh) * P + p) * N +
                q * kSt;
#pragma unroll
    for (int m = 0; m < kSt; ++m) hp[m] = hs[m];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
int launch_n(const void* x, const void* bm, const void* cm, const void* dt,
             const void* a, void* y, void* h, void* hc, int batch, int S,
             int H, int P, int G, long long x_sb, long long x_ss,
             long long b_sb, long long b_ss, long long c_sb, long long c_ss,
             cudaStream_t stream) {
  constexpr long long kPerT = 16 / sizeof(T);
  // 16-byte rows: P a multiple of 4 for y's float4 rows and of kPerT for
  // x's copies (channel slices of 32 start 16-byte aligned then), every
  // pointer and stride of x, B, C and y 16-byte aligned
  const bool vec = P % kPerT == 0 && P % 4 == 0 && aligned16(x) &&
                   aligned16(bm) && aligned16(cm) && aligned16(y) &&
                   x_sb % kPerT == 0 && x_ss % kPerT == 0 &&
                   b_sb % kPerT == 0 && b_ss % kPerT == 0 &&
                   c_sb % kPerT == 0 && c_ss % kPerT == 0 &&
                   (static_cast<long long>(H) * P) % 4 == 0;
  dim3 grid(H * ((P + kChannels - 1) / kChannels), batch);
  auto kernel =
      vec ? ssd_scan_kernel<T, N, true> : ssd_scan_kernel<T, N, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h), static_cast<float*>(hc), S, H, P, G, x_sb,
      x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, void* y, void* h, void* hc, int batch, int S,
           int H, int P, int G, int N, long long x_sb, long long x_ss,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || P <= 0 ||
      G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {     // zamba2-7b's state size and its reduced one
    case 8:
      return launch_n<T, 8>(x, bm, cm, dt, a, y, h, hc, batch, S, H, P, G,
                            x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, stream);
    case 64:
      return launch_n<T, 64>(x, bm, cm, dt, a, y, h, hc, batch, S, H, P, G,
                             x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x element [b, t, h, p] at b * x_sb + t * x_ss + h * P + p; B element
// [b, t, g, n] at b * b_sb + t * b_ss + g * N + n (likewise C); dt
// (batch, S, H) and a (H,) f32 contiguous; y (batch, S, H, P) and h
// (batch, H, P, N) f32 written, contiguous; hc null, or (batch, ceil(S /
// 64), H, P, N) f32 written, contiguous: the state entering each chunk
// of 64 steps.  N in {8, 64}; H a multiple of G; any S, H, P >= 1.
// Returns 0 or a cudaError_t.
extern "C" int ssd_scan_f32(const void* x, const void* bm, const void* cm,
                            const void* dt, const void* a, void* y, void* h,
                            void* hc, int batch, int S, int H, int P, int G,
                            int N, long long x_sb, long long x_ss,
                            long long b_sb, long long b_ss, long long c_sb,
                            long long c_ss, cudaStream_t stream) {
  return launch<float>(x, bm, cm, dt, a, y, h, hc, batch, S, H, P, G, N,
                       x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, stream);
}

// As ssd_scan_f32 with x, B and C in bf16.
extern "C" int ssd_scan_bf16(const void* x, const void* bm, const void* cm,
                             const void* dt, const void* a, void* y, void* h,
                             void* hc, int batch, int S, int H, int P, int G,
                             int N, long long x_sb, long long x_ss,
                             long long b_sb, long long b_ss, long long c_sb,
                             long long c_ss, cudaStream_t stream) {
  return launch<bf16bits>(x, bm, cm, dt, a, y, h, hc, batch, S, H, P, G, N,
                          x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, stream);
}
