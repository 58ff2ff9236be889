// Causal (+ sliding-window) GQA flash attention for prefill, bf16 in/out,
// written for Hopper (sm_90a): TMA loads, wgmma, O in registers.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_attn_kernel): q (B, H, S, D), k/v (B, KVH, S, D) -> (B, H, S, D), an
// online softmax in f32 over KV tiles, query head h reading KV head
// h / (H / KVH), masks k_pos <= q_pos (causal) and k_pos > q_pos - window,
// masked scores at NEG_INF = -2**30.
//
// History-offset mode (hist > 0): the queries sit at absolute positions
// hist + i and attend over hist history positions 0..hist-1 ahead of the
// seq fresh ones, key visible iff its position is <= hist + i (and with
// a window > hist + i - window).  This is the suffix / chunk prefill of
// COW prefix sharing and chunked prefill, which the reference computes
// in jnp over [history; fresh] (src/repro/models/attention.py:327-342):
// its Pallas kernel takes q_len == kv_len only.  The history (1, KVH,
// hist, D) is a second KV source with tensor maps of its own, read in
// place ahead of the fresh K/V: a B = 1 history shared by every row of a
// suffix group is never expanded (every row reads batch 0).
// Its tiles are numbered from position 0, the fresh ones from position
// hist, so a ragged history tail is a masked tile, not a shifted one.
// Tiles wholly outside the window or past the causal edge are skipped,
// not masked: a chunk at offset 3,072 with window 512 reads the ~512
// keys behind it.
//
// Bound on the H100: at S = 2048, H = 16, D = 256, causal, the work is
// about 2 * S^2 * D * H = 34 GFLOP of bf16 products (35 us at the 989
// TFLOP/s dense peak) against about 67 MB of q/k/v/o traffic (20 us at
// 3.35 TB/s), so it is bound by the tensor cores from S ~ 256 up; at a
// short prompt (S = 31) by launch latency.
//
// Design.  One CTA of three warpgroups per (b, h, 128-row query tile):
// two consumer warpgroups own 64 query rows each, the third is the
// producer, one thread of which issues every TMA load.
//  - Shared memory (D = 256): Q 2 x 64 x 256 bf16 (64 KB, loaded once),
//    K and V in a 2-stage ring of 64 x 256 bf16 tiles (128 KB), five
//    mbarriers: 192 KB of the 227 KB a block may use, one CTA per SM.
//    At D = 112 (zamba2's shared block) every tile is padded to 128
//    columns of 64 (96 KB in all): TMA zero-fills the entries past 112,
//    Q K^T runs 7 k-steps of 16 and P V wgmma.m64n128k16.  At D = 64
//    (granite-moe, H 24 over KV 8: a GQA group of 3) a tile is one
//    128-byte column: 48 KB in all, P V by wgmma.m64n64k16.
//    Tiles arrive by TMA (4-D tensor maps over (D, S, H, B) built per
//    call from the tensors' strides, so strided views are read in place)
//    in the 128-byte swizzle (64-byte at D = 32), as columns of 64 (32)
//    head-dim entries; rows past S are zero-filled by TMA.  The producer
//    refills a stage as soon as both consumers have released it (empty
//    barrier of 256 arrivals), so the next tile is in flight while the
//    consumers compute.
//  - S = Q K^T by wgmma.m64n64k16 from shared memory (K-major Q and K),
//    f32 accumulators in registers.  The online softmax runs on the
//    accumulator layout (each thread holds two rows, quad shuffles for
//    the row max; the row sum stays per thread until the epilogue);
//    scale and log2(e) are folded into one multiply and exp2.  Only
//    diagonal, window-edge and ragged tiles apply the element mask;
//    tiles that no row of a warpgroup can see are skipped whole.
//  - O += P V by wgmma.m64n256k16 (m64n64k16 at D = 64, m64n32k16 at
//    D = 32) with P converted
//    to bf16 in registers as the A operand (the accumulator layout of S
//    is the register-A layout) and V MN-major in shared memory
//    (transpose bit).  O stays in registers for the whole KV loop: 128
//    f32 a thread at D = 256; setmaxnreg gives the consumers 240
//    registers and the producer 24.
//  - Epilogue: O / max(l, 1e-30) to bf16, written swizzled into the
//    warpgroup's Q tile and stored by TMA, which clips rows past S.
//    With a non-null LSE pointer (a training forward) each live row's
//    natural-log log-sum-exp, (m + log2 l) ln 2, is written to lse (B, H,
//    S) f32 for the backward (K8, csrc/flash_attention_bwd.cu); with it
//    null, as on every serving path, nothing else changes.
//  - Longest first: blockIdx runs over the query tiles from the last
//    (most visible KV tiles under the causal mask) to the first, heads
//    and batch fastest, so GQA heads sharing a KV head run together.
// Registers and shared memory (ptxas, sm_90a, nvcc 12.9): 168 registers
// a thread at launch (the cap of 384 threads), 0 bytes of spills, at D =
// 256, 112 and 32; 197,672 B of dynamic shared memory at D = 256, 99,368
// B at D = 112, 50,216 B at D = 64, 25,640 B at D = 32 (1,024 of it
// alignment slack).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1073741824.f;  // -2**30, as the reference
constexpr int kRows = 64;        // query rows per consumer, keys per tile
constexpr int kConsumers = 2;
constexpr int kStages = 2;
constexpr int kThreads = (kConsumers + 1) * 128;

template <int D>
struct Cfg {
  static constexpr int kSwz = D * 2 >= 128 ? 128 : D * 2;  // bytes a row
  static constexpr int kCW = kSwz / 2;       // head-dim entries a column
  static constexpr int kCols = (D + kCW - 1) / kCW;
  // head_dim padded to whole columns (128 at D = 112): TMA zero-fills the
  // entries past D, so they add nothing to Q K^T and give zero columns
  // of P V, which the output's TMA store clips
  static constexpr int kDP = kCols * kCW;
  static constexpr int kColBytes = kRows * kSwz;
  static constexpr int kTileBytes = kRows * kDP * 2;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : 2;  // wgmma swizzle
  static constexpr CUtensorMapSwizzle kTmaSwz =
      kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(D % 16 == 0 && kCW % 16 == 0, "head_dim");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous region.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) {+}= A (64 x 16) B (16 x 64); A and B K-major in
// shared memory (descriptors), scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256, f32) += A (64 x 16, bf16 in registers) B (16 x 256); B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128); B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64); B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers) B (16 x 32); B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V at D = 256, 112 (padded to 128), 64 and 32, picked by the
// accumulator's size.
__device__ __forceinline__ void wgmma_pv(float (&o)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n256(o, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&o)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&o)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&o)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n32(o, a, db);
}

// One KV tile of the online softmax on the wgmma accumulator layout:
// this thread holds rows q_pos and q_pos + 8 (register i is row
// (i >> 1) & 1, key k_pos + (i >> 2) * 8 + (i & 1)), both absolute
// positions; keys at or past ``limit`` (the end of the tile's source)
// are masked.  Scales the scores
// into log2 units, masks them (kMask), updates the running max m and the
// thread's partial sum l, rescales O, and returns P in bf16 as the four
// register-A fragments of P V.
template <int NO, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[NO],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[4][4], int q_pos,
                                             int k_pos, int limit, int causal,
                                             int window, float scale_log2) {
  uint32_t vis = 0xffffffffu;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = s[i] * scale_log2;
    if (kMask) {
      const int qp = q_pos + ((i & 2) ? 8 : 0);
      const int kp = k_pos + (i >> 2) * 8 + (i & 1);
      const bool ok = kp < limit && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      if (!ok) {
        v = kNegInf;
        vis &= ~(1u << i);
      }
    }
    s[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  float p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = ((vis >> i) & 1u) ? exp2f(s[i] - m[(i >> 1) & 1]) : 0.f;
    l[(i >> 1) & 1] += p[i];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __grid_constant__ const CUtensorMap thk,
                       __grid_constant__ const CUtensorMap thv,
                       __grid_constant__ const CUtensorMap to, float* lse,
                       int batch, int heads, int kv_heads, int seq, int hist,
                       int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::kBar;
  const uint32_t bar_full = bar_q + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  // Query tiles from the last to the first; heads, then batch, fastest.
  const int idx = static_cast<int>(blockIdx.x);
  const int n_qt = (seq + 2 * kRows - 1) / (2 * kRows);
  const int qt = n_qt - 1 - idx / (heads * batch);
  const int h = idx % heads;
  const int b = (idx / heads) % batch;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * 2 * kRows;
  const int live_wgs = q0 + kRows < seq ? 2 : 1;
  // KV tiles any row of this query tile can see: history tiles
  // [h_begin, h_begin + n_hist) over positions 0..hist-1 (every one at
  // or before the first query, so the causal edge never cuts them), then
  // fresh tiles [t_begin, t_end) over positions hist..hist+seq-1.
  const int kv_end = causal ? min(seq, q0 + 2 * kRows) : seq;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kRows;
  const int t_end = (kv_end + kRows - 1) / kRows;
  const int h_begin =
      window > 0 ? max(0, hist + q0 - window + 1) / kRows : 0;
  const int n_hist = max(0, (hist + kRows - 1) / kRows - h_begin);
  const int n_tiles = n_hist + t_end - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, live_wgs * C::kTileBytes);
      for (int w = 0; w < live_wgs; ++w)
        for (int c = 0; c < C::kCols; ++c)
          tma_load(base + C::kQ + w * C::kTileBytes + c * C::kColBytes, &tq,
                   bar_q, c * C::kCW, q0 + w * kRows, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages)
          mbar_wait(bar_empty + 8 * st, ((i / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        const bool from_hist = i < n_hist;
        const CUtensorMap* mk = from_hist ? &thk : &tk;
        const CUtensorMap* mv = from_hist ? &thv : &tv;
        const int row = (from_hist ? h_begin + i : t_begin + i - n_hist) *
                        kRows;
        const int bb = from_hist ? 0 : b;
        for (int c = 0; c < C::kCols; ++c) {
          tma_load(base + C::kK + st * C::kTileBytes + c * C::kColBytes, mk,
                   full, c * C::kCW, row, kvh, bb);
          tma_load(base + C::kV + st * C::kTileBytes + c * C::kColBytes, mv,
                   full, c * C::kCW, row, kvh, bb);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows [row0, row0 + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + wg * kRows;
    const bool live = wg < live_wgs;
    // absolute positions: the first and last live row of the warpgroup
    // and this thread's first row
    const int a0 = hist + row0;
    const int hi = hist + min(row0 + kRows - 1, seq - 1);
    const int q_pos = a0 + warp * 16 + lane / 4;
    const uint32_t sq = base + C::kQ + wg * C::kTileBytes;
    constexpr uint32_t kSbo = 8 * C::kSwz;   // between groups of 8 rows
    float o[C::kDP / 2];
#pragma unroll
    for (int i = 0; i < C::kDP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    if (live) mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
      // the tile's first key position and the end of its source
      const bool from_hist = i < n_hist;
      const int k0 = from_hist ? (h_begin + i) * kRows
                               : hist + (t_begin + i - n_hist) * kRows;
      const int limit = from_hist ? hist : hist + seq;
      const bool seen = live && (!causal || k0 <= hi) &&
                        (window <= 0 || k0 + kRows - 1 > a0 - window);
      if (seen) {
        const uint32_t sk = base + C::kK + st * C::kTileBytes;
        const uint32_t sv = base + C::kV + st * C::kTileBytes;
        float s[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        pin(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / (C::kCW / 16)) * C::kColBytes +
                               (kk % (C::kCW / 16)) * 32;
          wgmma_ss_n64(s, desc(sq + off, 16, kSbo, C::kLayout),
                       desc(sk + off, 16, kSbo, C::kLayout), kk > 0);
        }
        wg_commit();
        wg_wait0();
        pin(s);
        uint32_t pa[4][4];
        const bool edge = (causal && k0 + kRows - 1 > a0) ||
                          (window > 0 && k0 <= hi - window) ||
                          k0 + kRows > limit;
        const int k_pos = k0 + 2 * (lane % 4);
        if (edge)
          softmax_tile<C::kDP / 2, true>(s, o, m, l, pa, q_pos, k_pos,
                                         limit, causal, window, scale_log2);
        else
          softmax_tile<C::kDP / 2, false>(s, o, m, l, pa, q_pos, k_pos,
                                          limit, causal, window, scale_log2);
        pin(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_pv(o, pa[kk], desc(sv + kk * 16 * C::kSwz, C::kColBytes,
                                   kSbo, C::kLayout));
        wg_commit();
        wg_wait0();
        pin(o);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    if (live) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + warp * 16 + lane / 4 + 8 * r;
          if (row < seq)
            lse[(static_cast<long long>(b) * heads + h) * seq + row] =
                (m[r] + log2f(l[r])) * 0.6931471805599453f;
        }
      }
      named_sync(1 + wg);  // every warp is done reading its Q tile
#pragma unroll
      for (int i = 0; i < C::kDP / 2; i += 2) {
        const int row = warp * 16 + lane / 4 + ((i & 2) ? 8 : 0);
        const int col = (i / 4) * 8 + 2 * (lane % 4);
        uint32_t off = row * C::kSwz + (col % C::kCW) * 2;
        off ^= ((off >> 7) & (C::kSwz / 16 - 1)) << 4;   // TMA's swizzle
        const float sc = inv[(i >> 1) & 1];
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(
                         sq + (col / C::kCW) * C::kColBytes + off),
                     "r"(pack_bf16(o[i] * sc, o[i + 1] * sc))
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + wg);
      if (threadIdx.x % 128 == 0) {
        for (int c = 0; c < C::kCols; ++c)
          tma_store(&to, sq + c * C::kColBytes, c * C::kCW, row0, h, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D map over (D, S, heads, batch) of a bf16 tensor whose element
// strides over S, heads and batch are st[0], st[1], st[2]; boxes of one
// column (kCW entries) by 64 rows, swizzled for wgmma.  At D = 112 the
// second column's box reaches past D: TMA fills entries 112..127 with
// zeros on a load and leaves them out of a store.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int seq, int heads,
            int batch, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Cfg<D>::kCW),
                             static_cast<cuuint32_t>(kRows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, Cfg<D>::kTmaSwz,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, void* out, float* lse, const long long* st,
           int batch,
           int heads, int kv_heads, int seq, int hist, int causal,
           int window, float scale, cudaStream_t stream) {
  if (encoder() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  CUtensorMap tq, tk, tv, thk, thv, to;
  if (!encode<D>(&tq, q, seq, heads, batch, st) ||
      !encode<D>(&tk, k, seq, kv_heads, batch, st + 3) ||
      !encode<D>(&tv, v, seq, kv_heads, batch, st + 6) ||
      !encode<D>(&to, out, seq, heads, batch, st + 9))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hist > 0) {
    if (!encode<D>(&thk, hk, hist, kv_heads, 1, st + 12) ||
        !encode<D>(&thv, hv, hist, kv_heads, 1, st + 15))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    thk = tk;  // never read: no history tile
    thv = tv;
  }
  const int smem = Cfg<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (seq + 2 * kRows - 1) / (2 * kRows);
  flash_attention_kernel<D><<<n_qt * heads * batch, kThreads, smem, stream>>>(
      tq, tk, tv, thk, thv, to, lse, batch, heads, kv_heads, seq, hist,
      causal,
      window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, S, D), k/v (B, KVH, S, D), out (B, H, S, D) and, when hist >
// 0, the history hk/hv (1, KVH, hist, D) that every row reads: bf16
// with a unit stride over D; strides[18] holds the element strides over
// (S, heads, batch) of q, k, v, out, hk and hv in turn, each a multiple
// of 8 (16 bytes; those of the history only when hist > 0), the pointers
// 16-byte aligned.  head_dim 256 is the 2b pair at full width, 112
// zamba2-7b's shared attention block, 64 granite-moe-3b-a800m's, 32
// their reduced configs.  lse, when not null, receives each row's natural-log
// log-sum-exp as (B, H, S) f32.  Returns 0 or a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* hk,
                                    const void* hv, void* out, float* lse,
                                    const long long* strides, int batch,
                                    int heads, int kv_heads, int seq,
                                    int hist, int head_dim,
                                    int causal, int window, float scale,
                                    cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      hist < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < (hist > 0 ? 18 : 12); ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, hk, hv, out, lse, strides, batch, heads,
                        kv_heads, seq, hist, causal, window, scale,
                        stream);
    case 64:
      return launch<64>(q, k, v, hk, hv, out, lse, strides, batch, heads,
                        kv_heads, seq, hist, causal, window, scale,
                        stream);
    case 112:
      return launch<112>(q, k, v, hk, hv, out, lse, strides, batch, heads,
                         kv_heads, seq, hist, causal, window, scale,
                         stream);
    case 256:
      return launch<256>(q, k, v, hk, hv, out, lse, strides, batch, heads,
                         kv_heads, seq, hist, causal, window, scale,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
