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
// Bound on the H100: bytes.  At the serving shape (Bt 1, S 1,536, di
// 8,192, N 16) dt, x and y move ~101 MB (0.030 ms at 3.35 TB/s); the
// ~1.4 GFLOP of f32 arithmetic is 0.021 ms at 67 TFLOP/s, and the 201 M
// exponentials on the special-function units come close to the byte time.
// The recurrence is sequential in t, so only the (d, n) pairs give
// parallelism: di * N = 131,072 independent chains a request.
//
// Design (simple first): one thread per (channel d, state n); the N
// threads of one channel sit in N consecutive lanes of a warp and sum y_t
// with a width-N butterfly of shuffles, so a thread-step costs one exp.
// A CTA of 256 threads owns 256 / N channels (16 at N = 16: 512 CTAs of 8
// warps at the serving shape, one wave on 132 SMs) and walks the sequence
// in chunks of kSteps rows: the chunk's dt, dt * x, B and C rows are
// staged into shared memory with coalesced loads (B and C once for all
// channels of the CTA), the chunk is scanned from shared memory, and its y
// rows, collected in shared memory, are written back coalesced.  The
// decay uses the accurate expf; the update h = fmaf(da, h, (dt x) B_t)
// rounds once less than the plain version's two-step update.  Overlapping
// a chunk's loads with the previous chunk's scan (cp.async or TMA) and a
// chunked parallel scan across the sequence are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSteps = 32;     // sequence rows staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid (ceil(di / (kThreads / N)), Bt), block kThreads.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const float* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const float* __restrict__ a, T* __restrict__ y,
    float* __restrict__ h_out, int S, int di, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss) {
  constexpr int kCh = kThreads / N;           // channels per CTA
  __shared__ float s_dt[kSteps][kCh];
  __shared__ float s_dx[kSteps][kCh];         // dt * x
  __shared__ float s_y[kSteps][kCh];
  __shared__ float s_b[kSteps][N];
  __shared__ float s_c[kSteps][N];

  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int d = d0 + ch;
  const float an = d < di ? a[static_cast<size_t>(d) * N + n] : 0.f;
  const size_t base = static_cast<size_t>(bi) * S * di;   // dt, x, y
  const T* bp = bm + bi * b_sb;
  const T* cp = cm + bi * c_sb;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    for (int i = threadIdx.x; i < kSteps * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      float dv = 0.f, xv = 0.f;
      if (t < steps && d0 + c < di) {
        const size_t off = base + static_cast<size_t>(t0 + t) * di + d0 + c;
        dv = dt[off];
        xv = to_f32(x[off]);
      }
      s_dt[t][c] = dv;
      s_dx[t][c] = dv * xv;
    }
    for (int i = threadIdx.x; i < kSteps * N; i += kThreads) {
      const int t = i / N, j = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < steps) {
        bv = to_f32(bp[(t0 + t) * b_ss + j]);
        cv = to_f32(cp[(t0 + t) * c_ss + j]);
      }
      s_b[t][j] = bv;
      s_c[t][j] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float da = expf(s_dt[t][ch] * an);
      h = fmaf(da, h, s_dx[t][ch] * s_b[t][n]);
      float p = h * s_c[t][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o, N);
      if (n == 0) s_y[t][ch] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      if (d0 + c < di)
        store(y + base + static_cast<size_t>(t0 + t) * di + d0 + c,
              s_y[t][c]);
    }
    // the next chunk's staging writes s_dt, s_dx, s_b and s_c, which no
    // thread reads any more; s_y is written again only after the next
    // __syncthreads
  }
  if (d < di) h_out[(static_cast<size_t>(bi) * di + d) * N + n] = h;
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, void* y, void* h, int batch, int S, int di,
             long long b_sb, long long b_ss, long long c_sb, long long c_ss,
             cudaStream_t stream) {
  constexpr int kCh = kThreads / N;
  dim3 grid((di + kCh - 1) / kCh, batch);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h), S, di, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, void* y, void* h, int batch, int S, int di, int N,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {     // falcon-mamba-7b's state size and its reduced one
    case 8:
      return launch_n<T, 8>(dt, x, bm, cm, a, y, h, batch, S, di, b_sb, b_ss,
                            c_sb, c_ss, stream);
    case 16:
      return launch_n<T, 16>(dt, x, bm, cm, a, y, h, batch, S, di, b_sb,
                             b_ss, c_sb, c_ss, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dt (batch, S, di) f32 and x (batch, S, di) contiguous; B and C element
// [b, t, n] at b * b_sb + t * b_ss + n (likewise c_*); a (di, N) f32
// contiguous; y (batch, S, di) and h (batch, di, N) f32 written.  N in
// {8, 16}; any S >= 1 and di >= 1.  Returns 0 or a cudaError_t.
extern "C" int ssm_scan_f32(const void* dt, const void* x, const void* bm,
                            const void* cm, const void* a, void* y, void* h,
                            int batch, int S, int di, int N, long long b_sb,
                            long long b_ss, long long c_sb, long long c_ss,
                            cudaStream_t stream) {
  return launch<float>(dt, x, bm, cm, a, y, h, batch, S, di, N, b_sb, b_ss,
                       c_sb, c_ss, stream);
}

// As ssm_scan_f32 with x, B, C and y in bf16.
extern "C" int ssm_scan_bf16(const void* dt, const void* x, const void* bm,
                             const void* cm, const void* a, void* y, void* h,
                             int batch, int S, int di, int N, long long b_sb,
                             long long b_ss, long long c_sb, long long c_ss,
                             cudaStream_t stream) {
  return launch<bf16>(dt, x, bm, cm, a, y, h, batch, S, di, N, b_sb, b_ss,
                      c_sb, c_ss, stream);
}
