// Hopper (sm_90a) primitives for the port's kernels: mbarriers, TMA tile
// loads and stores and the bulk tensor reduce, the async-proxy fence, named
// barriers, wgmma shared-memory descriptors and the products built on them,
// register reallocation, and the host-side tensor-map encoder. Inline PTX
// only, so a source that includes this builds in seconds; no -lcuda: the
// CUDA driver API's cuTensorMapEncodeTiled is fetched through the runtime
// at first use.
//
// Shared-memory tiles are in the 128-byte swizzle throughout: a tile of
// bf16 rows is cut into panels of 64 columns (128 bytes a row), each panel
// 1024-byte aligned, row r at r * 128 with its 16-byte chunks XORed by
// r % 8. A TMA tensor map with CU_TENSOR_MAP_SWIZZLE_128B writes that
// layout, and every wgmma descriptor below reads it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// make the inits visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// raise the bytes the current phase waits for, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// block until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- TMA -------------------------------------------------------------------

// A 4-D box of `map` at coordinates (c0 innermost .. c3) into shared memory,
// completing `bytes` on `bar`. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Add an f32 shared-memory box into global memory at (c0 .. c3); elements
// out of range are dropped. Tracked by this thread's bulk group.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// A shared-memory box into global memory at (c0 .. c3); elements out of
// range are dropped. Tracked by this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// all but the newest N of this thread's bulk groups have finished reading
// shared memory
template <int N = 0> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// ... and have finished writing global memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Thread writes to shared memory, made visible to the async proxy (wgmma
// operands, TMA sources) that reads them after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads (a multiple of 32), id 1..15.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// Arrive at that barrier without waiting for it.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`.
// K-major (the reduction axis contiguous): sbo = 1024 (8 rows of 128
// bytes), lbo unused. MN-major: sbo = the stride between groups of 8 rows
// along the reduction axis (1024), lbo = the stride between 64-column
// panels along M or N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are pending
template <int N = 0> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin registers an asynchronous wgmma reads or writes, so that the
// compiler moves no access to them across a wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The f32 accumulator of m64nNk16 in thread t of a warpgroup: element i
// is row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2. The register A fragment of one k16
// step covers accumulator columns 16 kk .. 16 kk + 15 of the same rows:
// A[kk] = {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
//          pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])}.

#define NTPU_ACC8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d[64 x N] (+)= A . B^T for N = 128, 64 and 32, both from shared memory.
// kTransA / kTransB: the operand is MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : NTPU_ACC8(0), NTPU_ACC8(8), NTPU_ACC8(16), NTPU_ACC8(24),
        NTPU_ACC8(32), NTPU_ACC8(40), NTPU_ACC8(48), NTPU_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : NTPU_ACC8(0), NTPU_ACC8(8), NTPU_ACC8(16), NTPU_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : NTPU_ACC8(0), NTPU_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
// d[64 x N] += A . B^T with A [64 x 16] in registers and B from shared
// memory (kTransB: MN-major).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : NTPU_ACC8(0), NTPU_ACC8(8), NTPU_ACC8(16), NTPU_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kTransB),
        "r"(1));
}
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, %69;\n}\n"
      : NTPU_ACC8(0), NTPU_ACC8(8), NTPU_ACC8(16), NTPU_ACC8(24),
        NTPU_ACC8(32), NTPU_ACC8(40), NTPU_ACC8(48), NTPU_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kTransB),
        "r"(1));
}
#undef NTPU_ACC8

// N picks the instruction: 32, 64 or 128 from shared memory, 64 or 128
// with A in registers.
template <int kTransA, int kTransB, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32) wgmma_ss_n32<kTransA, kTransB>(d, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_ss_n64<kTransA, kTransB>(d, da, db, accumulate);
  else wgmma_ss_n128<kTransA, kTransB>(d, da, db, accumulate);
}
template <int kTransB, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64<kTransB>(d, a, db);
  else wgmma_rs_n128<kTransB>(d, a, db);
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no
// -lcuda).
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 4-D tensor map over a strided [B, S, heads, D] tensor (dims innermost
// first: D, heads, S, B; strides in elements), with a box of `box_cols`
// columns x 1 head x `box_rows` rows x 1 batch, 128-byte swizzled, so a
// box row is 128 bytes: box_cols = 64 for bf16, 32 for f32. Returns false
// when the encoder refuses it (a stride that is not a multiple of 16
// bytes).
inline bool encode_rows_map(CUtensorMap* map, const void* base, bool bf16,
                            int B, int S, int heads, int D, long long sb,
                            long long ss, long long sh, int box_cols,
                            int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sh * esize, ss * esize, sb * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
