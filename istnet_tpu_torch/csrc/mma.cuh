// Tensor-core and async-copy primitives shared by the fused SA kernel
// (sa_fused.cu) and the fold-upsample GEMM (fold_upsample.cu): the warp-wide
// bf16 product mma.sync.m16n8k16 with float32 accumulators, ldmatrix loads
// of its operands from shared memory, and cp.async copies into it.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)   a[0] = (g, 2t..2t+1)      a[1] = (g + 8, 2t..)
//                            a[2] = (g, 2t + 8..)      a[3] = (g + 8, 2t + 8..)
//   B (16 x 8)               b0 = (k 2t..2t+1, n g)    b1 = (k 2t + 8.., n g)
//   C (16 x 8, float32)      c[0], c[1] = (g, 2t), (g, 2t + 1)
//                            c[2], c[3] = (g + 8, 2t), (g + 8, 2t + 1)
// ldmatrix_x4 on a row-major [row][k] tile with lane l pointing at
// (row0 + l % 16, k0 + 8 * (l / 16)) yields a[0..3] of the 16 x 16 tile at
// (row0, k0). ldmatrix_x4_trans on a row-major [k][n] tile with lane l
// pointing at (k0 + l % 16, n0 + 8 * (l / 16)) yields b0, b1 of the n-tile
// at n0 in r[0], r[1] and of the n-tile at n0 + 8 in r[2], r[3]. Rows must be
// 16-byte aligned; a row stride of 16 bytes modulo 32 keeps the eight rows
// of one 8 x 8 matrix on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace istnet {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared; with bytes < 16 the rest is filled with zeros
// (bytes == 0 reads nothing: src need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// ---- warpgroup products (wgmma): four warps, 64 rows, operands read from
// shared memory by the tensor cores themselves through 64-bit descriptors.
//
// Operand tiles here are K-major (rows of 64 bf16 = 128 bytes along k) in the
// 128-byte swizzle: groups of 8 rows are 1024 bytes apart and 1024-byte
// aligned, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its
// row (swizzled_chunk). A k-step of 16 inside the tile moves the descriptor's
// start by 32 bytes.
__device__ __forceinline__ int swizzled_chunk(int row, int chunk) {
  return chunk ^ (row & 7);
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFFu) >> 4;  // start address / 16
  d |= static_cast<uint64_t>(1) << 16;            // leading offset (unused here)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // stride between 8-row groups
  d |= static_cast<uint64_t>(1) << 62;            // 128-byte swizzle
  return d;
}

// shared-memory writes of the generic proxy (st.shared, cp.async that has
// landed) made visible to the async proxy through which wgmma reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// d (64 x 96, float32) += a (64 x 16) @ b (96 x 16)^T, both K-major bf16 in
// shared memory. Thread (warp w of the group, g = lane / 4, t = lane % 4)
// holds, for n-tile j: d[4j], d[4j + 1] = (16w + g, 8j + 2t), (.., 8j + 2t + 1)
// and d[4j + 2], d[4j + 3] the same columns of row 16w + g + 8.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

}  // namespace istnet
