// K12: the backward of the Mamba-2 / SSD scan (K11), f32 arithmetic.
//
// Replaces no Pallas kernel: the reference trains zamba2 through
// jax.value_and_grad of its jnp chunk loop (_ssd_chunk,
// src/repro/models/ssm.py:171-189, driven at :228-240), and K11 has no
// Pallas original either.  The forward is K11 (csrc/ssd_scan.cu), per
// head h of P channels and N states:
//   h_t = exp(dt_t a_h) h_{t-1} + dt_t x_t (outer) B_t,  y_t = h_t C_t,
// with x (Bt, S, H, P) and B, C (Bt, S, G, N) in one type (head h reads
// group h / (H / G)), dt (Bt, S, H) and a (H,) f32, h_{-1} = 0.  Given dy
// (Bt, S, H, P) f32 and the chunk states K11 saved (hc (Bt, ceil(S /
// 64), H, P, N) f32, the state entering each chunk of 64 steps), with
// g_t = dL/dh_t and d_t = exp(dt_t a_h):
//   g_t      = dy_t (outer) C_t + d_{t+1} g_{t+1}        (carried back)
//   dx_t[p]  = dt_t sum_n g_t[p, n] B_t[n]
//   dB_t[n]  = sum_{h in group, p} dt_t x_t[p] g_t[p, n]
//   dC_t[n]  = sum_{h in group, p} dy_t[p] h_t[p, n]
//   d(dt)_t  = sum_p x_t[p] sum_n g_t[p, n] B_t[n]
//              + a_h d_t sum_{p, n} g_t[p, n] h_{t-1}[p, n]
//   da_h     = sum_{b, t} dt_t d_t sum_{p, n} g_t[p, n] h_{t-1}[p, n]
//
// Bound on the H100 at zamba2-7b's shapes (H 112, P 64, N 64, G 1):
// about 6.5 FMAs (13 f32 operations) a state-step, 704.6 M state-steps
// at (Bt, S) = (1, 1,536): 9.16 GFLOP, 0.137 ms at 67 TFLOP/s, against
// ~133 MB of x, dy, dx and hc (0.040 ms at 3.35 TB/s): the operations
// set the bound.  At a client step (4, 40): 73.4 M state-steps, 0.014
// ms.  This design spends about twice the forward's share on top (each
// chunk's forward once more, then each block's), which the bound does
// not count.
//
// Design (simple and deterministic first; a chunked tensor-core form is
// later work):
//  - One CTA of 256 threads per (row, head), which walks the head's
//    channels in slices of 32: eight consecutive lanes share a channel p,
//    and lane q owns the N / 8 consecutive states [q N / 8, (q + 1) N / 8)
//    of it (8 at N = 64, 1 at N = 8).  For each slice the CTA walks its
//    chunks of 64 steps from the last to the first, staging the chunk's
//    dt, x, dy, B and C rows in shared memory and forming the decay
//    exp(dt a_h) once a step, as K11 does.
//  - Inside a chunk it recomputes h from the chunk's saved state with
//    K11's own arithmetic (fmaf(d, h, (dt x) B)), so the states are K11's
//    bits, never obtained by dividing by the decay, keeping the state at
//    the start of every block of 8 steps in shared memory; then for each
//    block from the last it recomputes the block's 9 states into
//    registers and runs its steps backwards, carrying d_t g_t across
//    blocks and chunks.
//  - Sums over a channel's states (dx's) are butterflies over its eight
//    lanes.  dB and dC are sums over every channel of every head of the
//    group, which cross CTAs: the four channels of a warp reduce-scatter
//    their 2 N / 8 values a step by shuffles, the CTA adds its 8 warps in
//    order, and adds the sum into its part, (H, Bt, S, 2 N) f32, a slice
//    after the other.  One part a head, not one a slice of 32 channels,
//    halves the buffer (at (1, 1,536): 112 parts of 1,536 x 128 floats,
//    88 MB, against 176 MB) and costs no time: at one CTA an SM (its
//    ~136 KB of shared memory) 224 slice-CTAs would run in two waves of
//    132 SMs, 112 head-CTAs in one wave of twice the length.  d(dt)
//    takes the CTA's sums of x sum_n g B and sum g h_{t-1} (warp
//    butterflies, then the 8 warps in order), added over the slices into
//    d(dt) itself; da's sum over t and slices runs in one thread, a part
//    a (row, head).  A second kernel adds the parts in a fixed order (the
//    group's heads; the batch rows for da).  No atomics: two calls return
//    the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16bits = uint16_t;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                     // lanes a channel
constexpr int kCh = kThreads / kLanes;        // channels a CTA
constexpr int kChunk = 64;                    // steps between saved states
constexpr int kBlock = 8;                     // steps recomputed at a time
constexpr int kBlocks = kChunk / kBlock;

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

// Shared memory of one CTA: the chunk's inputs, its dx rows, the
// block-start states and the warps' sums of a block's steps.
template <typename T, int N>
struct Smem {
  static constexpr int kSt = N / kLanes;
  float dt[kChunk];
  float dec[kChunk];
  float dy[kChunk][kCh];
  float dx[kChunk][kCh];
  float snap[kBlocks][kSt][kThreads];
  float part[kWarps][kBlock][2 * N];
  float scal[kWarps][kBlock][2];
  T x[kChunk][kCh];
  T b[kChunk][N];
  T c[kChunk][N];
};

// The butterfly sum of v over lanes xor 1, 2, 4 (a channel's lanes),
// or over the whole warp: every lane gets the same bits.
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Reduce-scatter of V values over the four channels of a warp (lane bits
// 16 and 8): each lane ends with max(V / 4, 1) of the warp's sums, those
// of value indices [base, base + held), base from its lane bits (16: the
// upper half; 8: the upper quarter when V >= 4).  At V = 2 both lanes of
// a bit-8 pair hold the same sum.
template <int V>
__device__ __forceinline__ void channel_scatter(float (&v)[V], int lane) {
  {
    const bool up = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float got =
          __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + V / 2], 16);
      v[i] = (up ? v[i + V / 2] : v[i]) + got;
    }
  }
  if constexpr (V >= 4) {
    const bool up = (lane & 8) != 0;
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float got =
          __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + V / 4], 8);
      v[i] = (up ? v[i + V / 4] : v[i]) + got;
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 8);
  }
}

// grid (H, Bt), block kThreads, dynamic shared memory sizeof(Smem<T,
// N>).  da_part is null when da is not wanted.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ dy,
    const float* __restrict__ hc, T* __restrict__ dx,
    float* __restrict__ part, float* __restrict__ ddt,
    float* __restrict__ da_part, int S, int H, int P, int G, long long x_sb,
    long long x_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss) {
  constexpr int kSt = N / kLanes;            // states a lane
  constexpr int kV = 2 * kSt;                // dB and dC shares a lane
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(raw);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int hh = blockIdx.x, bi = blockIdx.y, bt = gridDim.y;
  const int grp = hh / (H / G);
  const int ch = tid / kLanes, q = tid % kLanes;
  const float a_h = a[hh];
  const T* bp = bm + bi * b_sb + static_cast<long long>(grp) * N;
  const T* cp = cm + bi * c_sb + static_cast<long long>(grp) * N;
  const float* dtp = dt + static_cast<long long>(bi) * S * H + hh;
  const size_t row = static_cast<size_t>(H) * P;   // (b, t) row of dy, dx
  const int n_c = (S + kChunk - 1) / kChunk;
  float* partp = part + (static_cast<size_t>(hh) * bt + bi) * S * 2 * N;
  float* ddtp = ddt + static_cast<size_t>(bi) * S * H + hh;
  float da_acc = 0.f;                          // thread 0's sum

  for (int p0 = 0; p0 < P; p0 += kCh) {     // the head's channel slices
    const bool first = p0 == 0;                // the first slice writes
    const int p = p0 + ch;
    const bool live = p < P;
    const int width = min(kCh, P - p0);          // live channels
    const T* xp = x + bi * x_sb + static_cast<long long>(hh) * P + p0;
    const float* dyp = dy + (static_cast<size_t>(bi) * S * H + hh) * P + p0;
    T* dxp = dx + (static_cast<size_t>(bi) * S * H + hh) * P + p0;
    float carry[kSt];
#pragma unroll
    for (int m = 0; m < kSt; ++m) carry[m] = 0.f;

    for (int c = n_c - 1; c >= 0; --c) {
      const int t0 = c * kChunk;
      const int steps = min(kChunk, S - t0);
      __syncthreads();     // the previous chunk is done with the buffers
      for (int i = tid; i < steps; i += kThreads) {
        const float d = dtp[static_cast<long long>(t0 + i) * H];
        sm.dt[i] = d;
        sm.dec[i] = expf(d * a_h);               // K11's decay, bit for bit
      }
      for (int i = tid; i < steps * kCh; i += kThreads) {
        const int t = i / kCh, cc = i % kCh;
        const bool ok = cc < width;
        sm.x[t][cc] = ok ? xp[(t0 + t) * x_ss + cc] : T(0);
        sm.dy[t][cc] = ok ? dyp[(t0 + t) * row + cc] : 0.f;
      }
      for (int i = tid; i < steps * N; i += kThreads) {
        const int t = i / N, n = i % N;
        sm.b[t][n] = bp[(t0 + t) * b_ss + n];
        sm.c[t][n] = cp[(t0 + t) * c_ss + n];
      }
      float h[kSt];
#pragma unroll
      for (int m = 0; m < kSt; ++m)
        h[m] = live ? hc[(((static_cast<size_t>(bi) * n_c + c) * H + hh) * P +
                          p) * N + q * kSt + m]
                    : 0.f;
      __syncthreads();
      // forward over the chunk, K11's arithmetic, keeping each block's
      // starting state (each thread reads back only its own)
      const int n_blk = (steps + kBlock - 1) / kBlock;
      for (int k = 0; k < n_blk; ++k) {
#pragma unroll
        for (int m = 0; m < kSt; ++m) sm.snap[k][m][tid] = h[m];
#pragma unroll
        for (int j = 0; j < kBlock; ++j) {
          const int t = k * kBlock + j;
          if (t < steps) {
            const float dec = sm.dec[t];
            const float dtx = __fmul_rn(sm.dt[t], to_f32(sm.x[t][ch]));
#pragma unroll
            for (int m = 0; m < kSt; ++m)
              h[m] = fmaf(dec, h[m],
                          __fmul_rn(dtx, to_f32(sm.b[t][q * kSt + m])));
          }
        }
      }
      // the blocks backwards
      for (int k = n_blk - 1; k >= 0; --k) {
        float hs[kBlock + 1][kSt];
#pragma unroll
        for (int m = 0; m < kSt; ++m) hs[0][m] = sm.snap[k][m][tid];
#pragma unroll
        for (int j = 0; j < kBlock; ++j) {
          const int t = k * kBlock + j;
          const bool ok = t < steps;
          const float dec = ok ? sm.dec[t] : 1.f;
          const float dtx =
              ok ? __fmul_rn(sm.dt[t], to_f32(sm.x[t][ch])) : 0.f;
#pragma unroll
          for (int m = 0; m < kSt; ++m)
            hs[j + 1][m] = fmaf(
                dec, hs[j][m],
                __fmul_rn(dtx, ok ? to_f32(sm.b[t][q * kSt + m]) : 0.f));
        }
#pragma unroll
        for (int j = kBlock - 1; j >= 0; --j) {
          const int t = k * kBlock + j;
          if (t >= steps) continue;                // uniform over the CTA
          const float dtv = sm.dt[t], dec = sm.dec[t];
          const float xv = to_f32(sm.x[t][ch]);
          const float dyv = sm.dy[t][ch];
          const float dtx = __fmul_rn(dtv, xv);
          float gb = 0.f, gh = 0.f, v[kV];
#pragma unroll
          for (int m = 0; m < kSt; ++m) {
            const int n = q * kSt + m;
            const float g = fmaf(dyv, to_f32(sm.c[t][n]), carry[m]);
            carry[m] = dec * g;                    // d_t g_t
            gb = fmaf(g, to_f32(sm.b[t][n]), gb);
            gh = fmaf(g, hs[j][m], gh);
            v[m] = g * dtx;                        // dB share
            v[kSt + m] = dyv * hs[j + 1][m];       // dC share
          }
          gb = lane_sum(gb);
          if (q == 0) sm.dx[t][ch] = dtv * gb;
          const float s_gh = warp_sum(gh);
          const float s_xgb = warp_sum(q == 0 ? xv * gb : 0.f);
          channel_scatter<kV>(v, lane);
          // lane bits (16, 8) name the values it holds
          const int held = kV >= 4 ? kV / 4 : 1;
          const int base = ((lane & 16) ? kV / 2 : 0) +
                           ((kV >= 4 && (lane & 8)) ? kV / 4 : 0);
          if (kV >= 4 || (lane & 8) == 0) {
#pragma unroll
            for (int i = 0; i < held; ++i) {
              const int idx = base + i;
              sm.part[w][j][(idx / kSt) * N + q * kSt + idx % kSt] = v[i];
            }
          }
          if (lane == 0) {
            sm.scal[w][j][0] = s_gh;
            sm.scal[w][j][1] = s_xgb;
          }
        }
        __syncthreads();
        // the block's dB / dC, d(dt) and da shares: the warps in order
        const int tb = k * kBlock;
        const int jn = min(kBlock, steps - tb);
        for (int i = tid; i < jn * 2 * N; i += kThreads) {
          const int j = i / (2 * N), vv = i % (2 * N);
          float s = sm.part[0][j][vv];
#pragma unroll
          for (int ww = 1; ww < kWarps; ++ww) s += sm.part[ww][j][vv];
          float* dst = partp + static_cast<size_t>(t0 + tb + j) * 2 * N + vv;
          *dst = first ? s : *dst + s;
        }
        if (tid == 0) {
          for (int j = jn - 1; j >= 0; --j) {
            float gh = sm.scal[0][j][0], xgb = sm.scal[0][j][1];
            for (int ww = 1; ww < kWarps; ++ww) {
              gh += sm.scal[ww][j][0];
              xgb += sm.scal[ww][j][1];
            }
            const int t = tb + j;
            const float dec = sm.dec[t];
            const float v = fmaf(a_h * dec, gh, xgb);
            float* dst = ddtp + static_cast<size_t>(t0 + t) * H;
            *dst = first ? v : *dst + v;
            da_acc = fmaf(sm.dt[t] * dec, gh, da_acc);
          }
        }
        __syncthreads();
      }
      // the chunk's dx rows of the live channels
      for (int i = tid; i < steps * kCh; i += kThreads) {
        const int t = i / kCh, cc = i % kCh;
        if (cc < width) dxp[(t0 + t) * row + cc] = from_f32<T>(sm.dx[t][cc]);
      }
    }
  }
  if (da_part != nullptr && tid == 0)
    da_part[static_cast<size_t>(bi) * H + hh] = da_acc;
}

// dB, dC (Bt, S, G, N) in T from the heads' parts added in head order,
// then da (H,) f32 from the batch rows' parts in order: one thread an
// output element.
template <typename T, int N>
__global__ void __launch_bounds__(256) ssd_scan_bwd_sum(
    const float* __restrict__ part, const float* __restrict__ da_part,
    T* __restrict__ dbm, T* __restrict__ dcm, float* __restrict__ da,
    int bt, int S, int H, int G) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long bs = static_cast<long long>(bt) * S;   // (b, t) rows
  const long long n_bc = bs * G * 2 * N;
  if (i < n_bc) {
    const int v = static_cast<int>(i % (2 * N));
    const long long r = i / (2 * N);
    const int g = static_cast<int>(r % G);
    const long long row = r / G;
    const int per = H / G;                               // heads a group
    float s = 0.f;
    for (int hh = g * per; hh < (g + 1) * per; ++hh)
      s += part[(hh * bs + row) * 2 * N + v];
    if (v < N)
      dbm[(row * G + g) * N + v] = from_f32<T>(s);
    else
      dcm[(row * G + g) * N + v - N] = from_f32<T>(s);
    return;
  }
  const long long j = i - n_bc;
  if (da == nullptr || j >= H) return;
  float s = 0.f;
  for (int b = 0; b < bt; ++b) s += da_part[static_cast<long long>(b) * H + j];
  da[j] = s;
}

// Floats of scratch: the heads' dB / dC parts (H, batch, S, 2N) and,
// with da, the batch rows' da parts (batch, H).
long long scratch_floats(int batch, int S, int H, int N, bool with_da) {
  return static_cast<long long>(H) * batch * S * 2 * N +
         (with_da ? static_cast<long long>(batch) * H : 0);
}

template <typename T, int N>
int launch_n(const void* x, const void* bm, const void* cm, const void* dt,
             const void* a, const void* dy, const void* hc, void* dx,
             void* dbm, void* dcm, void* ddt, void* da, float* scratch,
             int batch, int S, int H, int P, int G, long long x_sb,
             long long x_ss, long long b_sb, long long b_ss, long long c_sb,
             long long c_ss, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<T, N>));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * S;
  float* part = scratch;
  float* da_part =
      da != nullptr ? part + static_cast<long long>(H) * rows * 2 * N
                    : nullptr;
  ssd_scan_bwd_kernel<T, N><<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(dy),
      static_cast<const float*>(hc), static_cast<T*>(dx), part,
      static_cast<float*>(ddt), da_part, S, H, P, G, x_sb, x_ss, b_sb, b_ss,
      c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = rows * G * 2 * N + (da != nullptr ? H : 0);
  ssd_scan_bwd_sum<T, N><<<static_cast<int>((total + 255) / 256), 256, 0,
                           stream>>>(
      part, da_part, static_cast<T*>(dbm), static_cast<T*>(dcm),
      static_cast<float*>(da), batch, S, H, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* dy, const void* hc, void* dx,
           void* dbm, void* dcm, void* ddt, void* da, float* scratch,
           int batch, int S, int H, int P, int G, int N, long long x_sb,
           long long x_ss, long long b_sb, long long b_ss, long long c_sb,
           long long c_ss, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || P <= 0 ||
      G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {     // zamba2-7b's state size and its reduced one
    case 8:
      return launch_n<T, 8>(x, bm, cm, dt, a, dy, hc, dx, dbm, dcm, ddt, da,
                            scratch, batch, S, H, P, G, x_sb, x_ss, b_sb,
                            b_ss, c_sb, c_ss, stream);
    case 64:
      return launch_n<T, 64>(x, bm, cm, dt, a, dy, hc, dx, dbm, dcm, ddt,
                             da, scratch, batch, S, H, P, G, x_sb, x_ss,
                             b_sb, b_ss, c_sb, c_ss, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, B and C as K11 reads them: x element [b, t, h, p] at b * x_sb + t *
// x_ss + h * P + p, B element [b, t, g, n] at b * b_sb + t * b_ss + g * N
// + n (likewise C); dt (batch, S, H), a (H,), dy (batch, S, H, P) f32
// contiguous; hc (batch, ceil(S / 64), H, P, N) f32, K11's chunk states.
// Writes dx (batch, S, H, P), dB and dC (batch, S, G, N) contiguous in
// x's type, d(dt) (batch, S, H) f32 and, when da is not null, da (H,)
// f32.  scratch holds ssd_scan_bwd_scratch's floats.  N in {8, 64}; H a
// multiple of G; any S, H, P >= 1.  Returns 0 or a cudaError_t.
extern "C" int ssd_scan_bwd_f32(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a, const void* dy, const void* hc, void* dx, void* dbm,
    void* dcm, void* ddt, void* da, float* scratch, int batch, int S, int H,
    int P, int G, int N, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, cudaStream_t stream) {
  return launch<float>(x, bm, cm, dt, a, dy, hc, dx, dbm, dcm, ddt, da,
                       scratch, batch, S, H, P, G, N, x_sb, x_ss, b_sb, b_ss,
                       c_sb, c_ss, stream);
}

// As ssd_scan_bwd_f32 with x, B, C, dx, dB and dC in bf16.
extern "C" int ssd_scan_bwd_bf16(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a, const void* dy, const void* hc, void* dx, void* dbm,
    void* dcm, void* ddt, void* da, float* scratch, int batch, int S, int H,
    int P, int G, int N, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, cudaStream_t stream) {
  return launch<bf16bits>(x, bm, cm, dt, a, dy, hc, dx, dbm, dcm, ddt, da,
                          scratch, batch, S, H, P, G, N, x_sb, x_ss, b_sb,
                          b_ss, c_sb, c_ss, stream);
}

// Floats of scratch ssd_scan_bwd_* takes: the heads' dB / dC parts (H x
// (batch, S, 2N)) and, with da, the batch rows' da parts (batch, H); -1
// for an N the kernel does not take.
extern "C" long long ssd_scan_bwd_scratch(int batch, int S, int H, int P,
                                          int N, int with_da) {
  if ((N != 8 && N != 64) || P <= 0) return -1;
  return scratch_floats(batch, S, H, N, with_da != 0);
}
