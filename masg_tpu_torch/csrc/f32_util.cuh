// Helpers shared by the f32 (CUDA-core) kernels K1 (flash_fwd.cu) and K3
// (flash_bwd.cu): vector loads and stores of 1, 2 or 4 floats through
// registers, and the XOR swizzle of f32 tiles in shared memory.
//
// A tile row of DH floats is cut into DH / 4 chunks of 16 bytes; chunk `ch`
// of row `r` is stored at chunk position ch ^ (key(r) & M), M = min(7,
// chunks - 1). With key(r) = r, eight rows that a quarter-warp reads at one
// chunk (rows r0 + 0..7) land in eight different 16-byte bank groups, so a
// 16-byte load (LDS.128) of eight rows takes one shared-memory wavefront;
// with key(r) = r / 4, the same holds for rows 4 apart.

#pragma once

namespace f32 {

template <int N>
__device__ __forceinline__ void ldv(float (&r)[N], const float* p) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void stv(float* p, const float (&r)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4 floats");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

// Rows of DH floats, swizzled by key(r) = r >> SHIFT (see the header).
template <int DH, int SHIFT = 0>
struct Swz {
  static constexpr int NCH = DH / 4;  // 16-byte chunks per row
  static constexpr int M = NCH >= 8 ? 7 : NCH - 1;
  // float offset of element d of row r
  __device__ static __forceinline__ int off(int r, int d) {
    return r * DH + ((((d >> 2) ^ ((r >> SHIFT) & M))) << 2) + (d & 3);
  }
};

}  // namespace f32
