// Tensor-core and copy helpers shared by the bf16 attention kernels
// (attention.cu, attention_backward.cu): 16-byte cp.async staging,
// ldmatrix, and mma.sync.aligned.m16n8k16 with bf16 operands and f32
// accumulators. Staged rows are one head's 64-wide slice, kRow bf16 apart.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace {

constexpr int kRow = 64 + 8;  // shared row stride in bf16 (144 B): the eight
                              // rows of an ldmatrix phase hit eight 16-byte
                              // bank groups

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += A_tile (16 x 64, fragments qa) times the 8 rows at rows[0..8) of a
// (., 64) bf16 shared array, transposed: one 16x8 tile of A rows^T.
__device__ __forceinline__ void mma_rows(float (&d)[4],
                                         const uint32_t (&qa)[4][4],
                                         const __nv_bfloat16* rows,
                                         int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];  // depth 32*half + 0, 8, 16, 24
    ldsm_x4(b, rows + (lane & 7) * kRow + 8 * (lane >> 3) + 32 * half);
    mma_bf16(d, qa[2 * half], b[0], b[1]);
    mma_bf16(d, qa[2 * half + 1], b[2], b[3]);
  }
}

// d[n] += a (a 16x16 A fragment) times rows[0..16) x columns [8n, 8n + 8)
// of a (., 64) bf16 shared array, for the eight n: the 16 rows are the
// product's depth (ldmatrix.trans), as V is in P V.
__device__ __forceinline__ void mma_depth16(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            const __nv_bfloat16* rows,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    uint32_t b[4];  // rows 0..15, columns 8 n + 0..15
    ldsm_x4_trans(b, rows + (lane & 15) * kRow + 8 * n + 8 * (lane >> 4));
    mma_bf16(d[n], a, b[0], b[1]);
    mma_bf16(d[n + 1], a, b[2], b[3]);
  }
}

}  // namespace
