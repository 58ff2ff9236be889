// K10: the backward of the Mamba-1 selective scan (K6), f32 arithmetic.
//
// Replaces no Pallas kernel: the reference trains falcon-mamba through
// jax.value_and_grad of its jnp chunked scan (_mamba1_inner,
// src/repro/models/ssm.py:81-109), and its Pallas scan has no VJP.  The
// forward is K6 (csrc/ssm_scan.cu):
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t x_t) B_t,
//   y_t = sum_n C_t[n] h_t[:, n],
// over dt (Bt, S, di) f32, x (Bt, S, di), B and C (Bt, S, N), A (di, N)
// f32, h_{-1} = 0.  Given dy (Bt, S, di) and the chunk states K6 saved
// (hc (Bt, ceil(S / C), di, N) f32, the state entering each chunk of C
// steps), with g_t = dL/dh_t:
//   g_t = dy_t C_t + a_{t+1} g_{t+1}          (carried backwards)
//   dx_t = dt_t sum_n g_t B_t
//   d(dt)_t = sum_n a_t g_t A h_{t-1} + x_t sum_n g_t B_t
//   dB_t[n] = sum_d g_t[d, n] dt_t x_t,   dC_t[n] = sum_d dy_t h_t[d, n]
//   dA[d, n] = sum_{b, t} a_t g_t dt_t h_{t-1}
//
// Bound on the H100: at (Bt, S) = (1, 1,536), di 8,192, N 16 the inputs
// and outputs move ~189 MB (dt, x, dy read, d(dt), dx written: 176 MB;
// hc read: 13 MB; B, C, dB, dC), 0.056 ms at 3.35 TB/s.  The function
// needs one exponential a state-step (a_t serves both h_{t-1} -> h_t and
// a_t g_t), 201 M on the special-function units at 16 a clock per SM,
// ~0.048 ms on 132 SMs at 1,980 MHz, so the bytes set the bound.  This
// design spends two (the chunk's forward, then each block's recompute):
// ~0.096 ms of its time.
//
// Design (simple and deterministic first):
//  - As in K6 a thread owns 4 consecutive states of one channel, N / 4
//    lanes a channel, 128 threads (32 channels at N = 16) a CTA; grid
//    (ceil(di / channels), Bt).  Each CTA walks its chunks of C = 64
//    steps from the last to the first, staging the chunk's dt, x, dy, B
//    and C rows in shared memory.
//  - Inside a chunk it recomputes h from the chunk's saved state with
//    K6's own arithmetic (fmaf(ex2(dt * A log2 e), h, (dt x) B), so the
//    states are K6's bits; never by dividing by the decay), keeping the
//    state at the start of every block of 8 steps in shared memory; then
//    for each block from the last, it recomputes the block's 8 states
//    and decays into registers and runs its 8 steps backwards, carrying
//    a_t g_t (the next step's share of g) across blocks and chunks.
//  - Sums over N (dx, d(dt)) are butterfly shuffles over a channel's
//    lanes, which leave every lane the same bits.  dB and dC are sums
//    over d_inner, which crosses CTAs: the 8 (16 at N = 8) channels of a
//    warp reduce-scatter their 2 x 4 values a step in 7 (8) shuffles, so
//    each lane ends with one (step, n) sum; the CTA adds its 4 warps in
//    order and writes its part (ceil(di / channels), Bt, S, 2N) f32; a
//    second kernel adds the parts in CTA order.  dA is summed over t in
//    registers, written per batch row, and added over Bt in order by the
//    second kernel.  No atomics: two calls return the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16bits = uint16_t;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 4;    // states a thread
constexpr int kChunk = 64;    // steps between saved states (K6's chunk)
constexpr int kBlock = 8;     // steps recomputed into registers at a time
constexpr int kBlocks = kChunk / kBlock;
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

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Shared memory of one CTA: the chunk's inputs, the block-start states
// and the warps' dB / dC sums of the chunk's steps.
template <typename T, int N>
struct Smem {
  static constexpr int kCh = kThreads / (N / kStates);
  float dt[kChunk][kCh];
  T x[kChunk][kCh];
  T dy[kChunk][kCh];
  T b[kChunk][N];
  T c[kChunk][N];
  float4 blk[kBlocks][kThreads];
  float part[kWarps][kChunk][2 * N];
};

// The butterfly sum of v over the G lanes of a channel (lanes xor 1, 2):
// every lane gets the same bits, since a + b == b + a.
template <int G>
__device__ __forceinline__ float lane_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if constexpr (G == 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Reduce-scatter of 8 values over the channels of a warp (lane bits 16,
// 8, 4, and 2 at G = 2): the lane whose bits (16, 8, 4) read i ends with
// the warp's sum of value i; at G = 2 both lanes of a bit-2 pair hold it.
template <int G>
__device__ __forceinline__ float channel_scatter(float (&v)[8], int lane) {
  {
    const bool up = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float got =
          __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + 4], 16);
      v[i] = (up ? v[i + 4] : v[i]) + got;
    }
  }
  {
    const bool up = (lane & 8) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float got =
          __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + 2], 8);
      v[i] = (up ? v[i + 2] : v[i]) + got;
    }
  }
  {
    const bool up = (lane & 4) != 0;
    const float got = __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 4);
    v[0] = (up ? v[1] : v[0]) + got;
  }
  if constexpr (G == 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  return v[0];
}

// grid (ceil(di / kCh), Bt), block kThreads, dynamic shared memory
// sizeof(Smem<T, N>).  da_part is null when dA is not wanted.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(
    const float* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const float* __restrict__ a, const T* __restrict__ dy,
    const float* __restrict__ hc, float* __restrict__ ddt,
    T* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ da_part, int S, int di, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss) {
  constexpr int G = N / kStates;
  constexpr int kCh = kThreads / G;
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(raw);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int bi = blockIdx.y, cx = blockIdx.x, bt = gridDim.y;
  const int d0 = cx * kCh;
  const int ch = tid / G, q = tid % G;
  const int d = d0 + ch;
  const bool live = d < di;
  const size_t base = static_cast<size_t>(bi) * S * di;
  const T* bp = bm + bi * b_sb;
  const T* cp = cm + bi * c_sb;
  const int n_c = (S + kChunk - 1) / kChunk;

  float a2[kStates], av[kStates], carry[kStates], dA[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    av[j] = live ? a[static_cast<size_t>(d) * N + q * kStates + j] : 0.f;
    a2[j] = av[j] * kLog2e;
    carry[j] = 0.f;
    dA[j] = 0.f;
  }

  for (int c = n_c - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, S - t0);
    __syncthreads();     // the previous chunk is done with the buffers
    for (int i = tid; i < steps * kCh; i += kThreads) {
      const int t = i / kCh, cc = i % kCh;
      const bool ok = d0 + cc < di;
      const size_t off = base + static_cast<size_t>(t0 + t) * di + d0 + cc;
      sm.dt[t][cc] = ok ? dt[off] : 0.f;
      sm.x[t][cc] = ok ? x[off] : T(0);
      sm.dy[t][cc] = ok ? dy[off] : T(0);
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N, n = i % N;
      sm.b[t][n] = bp[(t0 + t) * b_ss + n];
      sm.c[t][n] = cp[(t0 + t) * c_ss + n];
    }
    float h[kStates] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 v = *reinterpret_cast<const float4*>(
          hc + ((static_cast<size_t>(bi) * n_c + c) * di + d) * N +
          q * kStates);
      h[0] = v.x;
      h[1] = v.y;
      h[2] = v.z;
      h[3] = v.w;
    }
    __syncthreads();
    // forward over the chunk, K6's arithmetic, keeping each block's
    // starting state
    const int n_blk = (steps + kBlock - 1) / kBlock;
    for (int k = 0; k < n_blk; ++k) {
      sm.blk[k][tid] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        const int t = k * kBlock + j;
        if (t < steps) {
          const float dtv = sm.dt[t][ch];
          const float dxv = __fmul_rn(dtv, to_f32(sm.x[t][ch]));
#pragma unroll
          for (int m = 0; m < kStates; ++m)
            h[m] = fmaf(ex2(__fmul_rn(dtv, a2[m])), h[m],
                        __fmul_rn(dxv, to_f32(sm.b[t][q * kStates + m])));
        }
      }
    }
    // the blocks backwards; each thread reads back only its own states
    for (int k = n_blk - 1; k >= 0; --k) {
      float hs[kBlock + 1][kStates], dec[kBlock][kStates];
      const float4 v = sm.blk[k][tid];
      hs[0][0] = v.x;
      hs[0][1] = v.y;
      hs[0][2] = v.z;
      hs[0][3] = v.w;
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        const int t = k * kBlock + j;
        const float dtv = t < steps ? sm.dt[t][ch] : 0.f;
        const float dxv = t < steps ? __fmul_rn(dtv, to_f32(sm.x[t][ch]))
                                    : 0.f;
#pragma unroll
        for (int m = 0; m < kStates; ++m) {
          const float bv = t < steps ? to_f32(sm.b[t][q * kStates + m]) : 0.f;
          dec[j][m] = ex2(__fmul_rn(dtv, a2[m]));
          hs[j + 1][m] = fmaf(dec[j][m], hs[j][m], __fmul_rn(dxv, bv));
        }
      }
#pragma unroll
      for (int j = kBlock - 1; j >= 0; --j) {
        const int t = k * kBlock + j;
        if (t >= steps) continue;      // uniform over the CTA
        const float dtv = sm.dt[t][ch];
        const float xv = to_f32(sm.x[t][ch]);
        const float dyv = to_f32(sm.dy[t][ch]);
        float gb = 0.f, gh = 0.f, vals[8];
#pragma unroll
        for (int m = 0; m < kStates; ++m) {
          const int n = q * kStates + m;
          const float bv = to_f32(sm.b[t][n]);
          const float g = fmaf(dyv, to_f32(sm.c[t][n]), carry[m]);
          carry[m] = dec[j][m] * g;                    // a_t g_t
          gb = fmaf(g, bv, gb);
          gh = fmaf(carry[m] * av[m], hs[j][m], gh);
          dA[m] = fmaf(carry[m] * dtv, hs[j][m], dA[m]);
          vals[m] = g * __fmul_rn(dtv, xv);            // dB share
          vals[kStates + m] = dyv * hs[j + 1][m];      // dC share
        }
        gb = lane_sum<G>(gb);
        gh = lane_sum<G>(gh);
        const float s = channel_scatter<G>(vals, lane);
        // lane bits (16, 8, 4) name the value it holds: i < 4 dB of state
        // q * 4 + i, else dC of state q * 4 + i - 4
        const int i = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                      ((lane >> 2) & 1);
        if (G == 4 || (lane & 2) == 0)
          sm.part[w][t][(i < 4 ? 0 : N) + q * kStates + (i & 3)] = s;
        if (q == 0 && live) {
          const size_t off = base + static_cast<size_t>(t0 + t) * di + d;
          ddt[off] = fmaf(xv, gb, gh);
          dx[off] = from_f32<T>(dtv * gb);
        }
      }
    }
    __syncthreads();
    // this CTA's dB / dC of the chunk's steps, its warps added in order
    for (int i = tid; i < steps * 2 * N; i += kThreads) {
      const int t = i / (2 * N), v = i % (2 * N);
      float s = sm.part[0][t][v];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) s += sm.part[ww][t][v];
      part[((static_cast<size_t>(cx) * bt + bi) * S + t0 + t) * 2 * N + v] =
          s;
    }
  }
  if (da_part != nullptr && live)
    *reinterpret_cast<float4*>(
        da_part + (static_cast<size_t>(bi) * di + d) * N + q * kStates) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
}

// dB, dC (Bt, S, N) in T from the CTAs' parts added in CTA order, then dA
// (di, N) f32 from the batch rows' parts added in row order: one thread an
// output element.
template <typename T, int N>
__global__ void __launch_bounds__(256) ssm_scan_bwd_sum(
    const float* __restrict__ part, const float* __restrict__ da_part,
    T* __restrict__ dbm, T* __restrict__ dcm, float* __restrict__ da,
    int n_cta, int bt, int S, int di) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long rows = static_cast<long long>(bt) * S * 2 * N;
  if (i < rows) {
    float s = 0.f;
    for (int cx = 0; cx < n_cta; ++cx) s += part[cx * rows + i];
    const long long bs = i / (2 * N);
    const int v = static_cast<int>(i % (2 * N));
    if (v < N)
      dbm[bs * N + v] = from_f32<T>(s);
    else
      dcm[bs * N + v - N] = from_f32<T>(s);
    return;
  }
  const long long j = i - rows;
  if (da == nullptr || j >= static_cast<long long>(di) * N) return;
  float s = 0.f;
  for (int b = 0; b < bt; ++b)
    s += da_part[static_cast<long long>(b) * di * N + j];
  da[j] = s;
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, const void* dy, const void* hc, void* ddt,
             void* dx, void* dbm, void* dcm, void* da, float* scratch,
             int batch, int S, int di, long long b_sb, long long b_ss,
             long long c_sb, long long c_ss, cudaStream_t stream) {
  constexpr int kCh = kThreads / (N / kStates);
  const int n_cta = (di + kCh - 1) / kCh;
  const int smem = static_cast<int>(sizeof(Smem<T, N>));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = scratch;
  float* da_part =
      da != nullptr ? scratch + static_cast<size_t>(n_cta) * batch * S * 2 * N
                    : nullptr;
  ssm_scan_bwd_kernel<T, N><<<dim3(n_cta, batch), kThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const T*>(dy),
      static_cast<const float*>(hc), static_cast<float*>(ddt),
      static_cast<T*>(dx), part, da_part, S, di, b_sb, b_ss, c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * S * 2 * N +
                          (da != nullptr ? static_cast<long long>(di) * N : 0);
  ssm_scan_bwd_sum<T, N><<<static_cast<int>((total + 255) / 256), 256, 0,
                           stream>>>(
      part, da_part, static_cast<T*>(dbm), static_cast<T*>(dcm),
      static_cast<float*>(da), n_cta, batch, S, di);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, const void* dy, const void* hc, void* ddt, void* dx,
           void* dbm, void* dcm, void* da, float* scratch, int batch, int S,
           int di, int N, int chunk, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || di <= 0 || chunk != kChunk ||
      !aligned16(hc) || !aligned16(a) || (da != nullptr && !aligned16(da)) ||
      !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 8:
      return launch_n<T, 8>(dt, x, bm, cm, a, dy, hc, ddt, dx, dbm, dcm, da,
                            scratch, batch, S, di, b_sb, b_ss, c_sb, c_ss,
                            stream);
    case 16:
      return launch_n<T, 16>(dt, x, bm, cm, a, dy, hc, ddt, dx, dbm, dcm, da,
                             scratch, batch, S, di, b_sb, b_ss, c_sb, c_ss,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dt (batch, S, di) f32, x and dy (batch, S, di) contiguous; B and C
// element [b, t, n] at b * b_sb + t * b_ss + n (likewise c_*); a (di, N)
// f32; hc (batch, ceil(S / chunk), di, N) f32, K6's chunk states, chunk
// 64.  Writes d(dt) (batch, S, di) f32, dx (batch, S, di), dB and dC
// (batch, S, N) contiguous, and, when da is not null, dA (di, N) f32.
// scratch holds ssm_scan_bwd_scratch's floats.  N in {8, 16}; x, B, C,
// dy, dx, dB and dC all f32 or all bf16.  Returns 0 or a cudaError_t.
extern "C" int ssm_scan_bwd_f32(const void* dt, const void* x, const void* bm,
                                const void* cm, const void* a, const void* dy,
                                const void* hc, void* ddt, void* dx,
                                void* dbm, void* dcm, void* da,
                                float* scratch, int batch, int S, int di,
                                int N, int chunk, long long b_sb,
                                long long b_ss, long long c_sb,
                                long long c_ss, cudaStream_t stream) {
  return launch<float>(dt, x, bm, cm, a, dy, hc, ddt, dx, dbm, dcm, da,
                       scratch, batch, S, di, N, chunk, b_sb, b_ss, c_sb,
                       c_ss, stream);
}

// As ssm_scan_bwd_f32 with x, B, C, dy, dx, dB and dC in bf16.
extern "C" int ssm_scan_bwd_bf16(const void* dt, const void* x,
                                 const void* bm, const void* cm,
                                 const void* a, const void* dy,
                                 const void* hc, void* ddt, void* dx,
                                 void* dbm, void* dcm, void* da,
                                 float* scratch, int batch, int S, int di,
                                 int N, int chunk, long long b_sb,
                                 long long b_ss, long long c_sb,
                                 long long c_ss, cudaStream_t stream) {
  return launch<bf16bits>(dt, x, bm, cm, a, dy, hc, ddt, dx, dbm, dcm, da,
                          scratch, batch, S, di, N, chunk, b_sb, b_ss, c_sb,
                          c_ss, stream);
}

// Floats of scratch ssm_scan_bwd_* takes: the CTAs' dB / dC parts and,
// with dA, the batch rows' dA parts.
extern "C" long long ssm_scan_bwd_scratch(int batch, int S, int di, int N,
                                          int with_da) {
  if (N != 8 && N != 16) return -1;
  const long long n_cta = (di + kThreads / (N / kStates) - 1) /
                          (kThreads / (N / kStates));
  return n_cta * batch * S * 2 * N +
         (with_da ? static_cast<long long>(batch) * di * N : 0);
}
