// Tensor-core building blocks shared by the attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): the XOR
// swizzle of bf16 tiles in shared memory, cp.async copies from global to
// shared memory, the ldmatrix loads that feed mma.sync, and the
// m16n8k16 bf16 product with fp32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// A (16 x 16, row) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
// a3 = (g+8, 8+2t..); B (16 x 8, col) b0 = (k 2t..2t+1, n g), b1 = (k
// 8+2t.., n g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// Two neighbouring C tiles, rounded and packed, are the A fragment of
// the next product over the same 16 rows (`pack_bf16`).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile.
// Eight consecutive rows put one logical chunk in eight distinct bank
// groups, which is what one 8x8 ldmatrix phase reads.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D >= 64)
    return r * D + ((c ^ (r & 7)) << 3);
  else  // D == 32: two rows per 128-byte bank line
    return r * D + ((c ^ ((r >> 1) & 3)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;  // 0: write a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // <= N groups pending
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier `id` (1..15; __syncthreads uses 0) among `n` threads of the
// block, a multiple of 32
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
