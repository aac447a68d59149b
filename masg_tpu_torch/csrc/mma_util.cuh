// Tensor-core helpers shared by the bf16 kernels (K1 in flash_fwd.cu, K2 and
// K3 in flash_bwd.cu, K4 in fused_mrf.cu) and the f32 K4 (3xTF32): cp.async,
// ldmatrix, mma.sync m16n8k16 and m16n8k8 (bf16 in, f32 accumulate) and
// m16n8k8 (tf32 in, f32 accumulate), the tf32 rounding, and the XOR swizzle
// that keeps ldmatrix free of bank conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// q = lane % 4:
//   A (16 x 16, row-major): a[0] = (g, 2q..2q+1), a[1] = (g + 8, 2q..),
//                           a[2] = (g, 2q + 8..), a[3] = (g + 8, 2q + 8..)
//   B (16 x 8, k x n):      b[0] = (k = 2q..2q+1, n = g), b[1] = (k = 2q + 8.., n = g)
//   C/D (16 x 8, f32):      d[0..1] = (g, 2q..2q+1), d[2..3] = (g + 8, 2q..2q+1)
// The low 16 bits of a 32-bit register hold the element with the smaller
// column (or k) index.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// two 8x8 b16 matrices; lanes 0-15 give the row addresses (lane l: matrix l / 8)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b  (16x16 bf16 by 16x8 bf16, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b  (16x8 bf16 by 8x8 bf16, f32 accumulators). Fragments (PTX ISA,
// mma.m16n8k8 with .bf16): a[0] = (g, 2q..2q+1), a[1] = (g + 8, 2q..2q+1);
// b = (k = 2q..2q+1, n = g); C/D as above. ldsm_x2 on rows of 8 bf16 gives
// the A fragment.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a * b  (16x8 tf32 by 8x8 tf32, f32 accumulators). Fragments (PTX ISA,
// mma.m16n8k8 with .tf32): a[0] = (g, q), a[1] = (g + 8, q), a[2] = (g, q + 4),
// a[3] = (g + 8, q + 4); b[0] = (k = q, n = g), b[1] = (k = q + 4, n = g); C/D
// as above. ldsm_x4 on rows of floats gives the A fragment: 8x8 b16 matrices
// are 8 x 4 floats, and lane l receives float l % 4 of row l / 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  // not volatile: a pure function of its operands, so independent products
  // may be interleaved
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero), as
// the bits of an f32 whose low 13 bits are 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// two floats -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Rows of ROW bf16 elements in shared memory, cut into 16-byte chunks. The
// chunk index is XORed with bits of the row so that the 8 rows one ldmatrix
// matrix reads (8 consecutive rows, one chunk each) fall in 8 different
// 16-byte bank groups: rows of >= 128 bytes use row % 8; a 64-byte row
// shares a 128-byte line with its neighbour, so (row / 2) % 4; and so on. A
// row of one chunk is not swizzled: 8 consecutive rows fill one 128-byte line.
template <int ROW>
struct Swizzle {
  static constexpr int NCH = ROW / 8;  // chunks per row
  static_assert(NCH >= 1 && (NCH & (NCH - 1)) == 0, "row of 2^n chunks");
  static constexpr int SH = NCH >= 8 ? 0 : (NCH == 4 ? 1 : 2);
  static constexpr int MASK = (NCH >= 8 ? 8 : NCH) - 1;
  // element offset of chunk `ch` of row `r` (r >= 0)
  __device__ static __forceinline__ int off(int r, int ch) {
    return r * ROW + ((ch ^ ((r >> SH) & MASK)) << 3);
  }
};

}  // namespace mma
