// Primitives shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): the NEG_INF sentinel, cp.async copies, the bf16 mma.sync
// tile and its ldmatrix loads. Each .cu builds into its own library, so the
// anonymous namespace gives every library its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// 16 bytes global -> shared without a register round trip; zero-fills when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(void* smem, const void* src,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 of row `row` (0 past the sequence's end).
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long row_stride, int row,
                                              int col, int S) {
  return row < S ? *reinterpret_cast<const uint32_t*>(base + row * row_stride + col)
                 : 0u;
}

// Fragment layouts follow PTX's mma.m16n8k16: with g = lane / 4 and
// t = lane % 4, an A fragment holds rows g and g+8 at columns 2t, 2t+1
// (+8), a B fragment column g at rows 2t, 2t+1 (+8), and an f32 C fragment
// rows g and g+8 at columns 2t, 2t+1.

}  // namespace
