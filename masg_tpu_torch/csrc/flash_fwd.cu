// Flash-attention forward for Hopper (sm_90a), kernel K1 of the port.
//
// Replaces the Pallas TPU kernel masg_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_fwd_call). Computes, per (batch*head, query row),
//   O = softmax(q k^T / sqrt(Dh)) v  over keys [0, len[b])
// with an online softmax in f32, and the row log-sum-exp
//   LSE = m + log(l)  (-inf, with O = 0, for a row that sees no valid key).
//
// Layout: q, k, v, O are (B*H, T, Dh) contiguous, f32 or bf16; LSE is
// (B*H, T) f32 (the TPU's 128-lane replica is dropped); lens is (B,) int32,
// read per batch row as lens[bh / H]. Keys at or past min(len, T) and rows
// past T are masked here, so no padded copies are made.
//
// What bounds it on the H100: 4*T^2*Dh flops over ~4*T*Dh*bytes of I/O per
// head, about T/2 (f32) or T (bf16) flops per byte, so it is bound by
// arithmetic at the FastSpeech2 shapes (T = 128..1000, Dh = 128).
//
// bf16 (flash_fwd_bf16_kernel): both products run on the tensor cores,
// FA2-style. One block of 4 warps per (b*h, 64-row query tile); each warp
// owns 16 query rows, holds their q fragments in registers and the O
// accumulator (16 x Dh f32) in mma fragments. 64-row K and V tiles are
// double-buffered in shared memory with cp.async (rows past T zero-filled)
// under an XOR swizzle, so the ldmatrix reads (K as the B operand of q.k^T,
// V transposed by ldmatrix.trans for p.v) are free of bank conflicts. The
// scores are scaled in f32 after the product (into the log2 domain), the
// online max, sum and rescale work on the accumulator fragments (a quad of
// lanes shares a row), p is rounded to bf16 only as the A operand of p.v,
// and the row sum l and the LSE come from the unrounded f32 p, so K2/K3,
// which recompute p from the LSE, see the same normaliser. The key-tile loop
// runs to ceil(len / 64). The kernel stays on mma.sync rather than
// wgmma + TMA: at B*H = 32 and T <= 1000 the grid (64..512 blocks of 4 warps)
// and the per-tile softmax, not the tensor-core issue rate, set the time.
//
// f32 (flash_fwd_kernel): the first, SIMT kernel, kept so the f32 path meets
// masg_tpu's 2e-5 bar (TF32 would not). One block of 256 threads per (b*h,
// 64-row q tile), 32-row K/V tiles in shared memory, four threads per query
// row, f32 FMAs on the CUDA cores: bound by shared-memory loads (one per
// FMA), ~1/100 of its bound. Register-tiled SIMT micro-tiles are queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // key rows per staged tile
constexpr int NT = 256;  // threads per block: 4 per query row

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lens,
                 float* __restrict__ o, float* __restrict__ lse, int heads,
                 int t_len, float scale) {
  constexpr int QS = DH + 1;  // padded row strides (bank-conflict free)
  constexpr int KS = DH + 1;
  constexpr int PS = BK + 1;
  constexpr int NJ = DH / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * DH;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int q4 = tid & 3;  // quarter of that row
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int rr = i / DH, d = i % DH, row = q0 + rr;
    Qs[rr * QS + d] = row < t_len ? q[base + (size_t)row * DH + d] * scale : 0.f;
  }

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kb = (valid + BK - 1) / BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // the previous tile's readers are done; Q is visible
    const int k0 = kb * BK;
    for (int i = tid; i < BK * DH; i += NT) {
      const int c = i / DH, d = i % DH, row = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (row < t_len) {
        kv = k[base + (size_t)row * DH + d];
        vv = v[base + (size_t)row * DH + d];
      }
      Ks[c * KS + d] = kv;
      Vs[c * DH + d] = vv;
    }
    __syncthreads();

    float s[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * QS;
    const float* kcol = Ks + (q4 * 8) * KS;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[jj] = fmaf(qv, kcol[jj * KS + d], s[jj]);
    }

    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (k0 + q4 * 8 + jj >= valid) s[jj] = -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    // guard fully masked tiles: exp(-inf - -inf) must not give NaN
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p = isfinite(s[jj]) ? expf(s[jj] - m_safe) : 0.f;
      Ps[r * PS + q4 * 8 + jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same four lanes

#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    const float* prow = Ps + r * PS;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * DH + q4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  const int row = q0 + r;
  if (row < t_len) {
    if (q4 == 0)
      lse[(size_t)bh * t_len + row] =
          l > 0.f ? (isfinite(m) ? m : 0.f) + logf(l) : -INFINITY;
    const float denom = l == 0.f ? 1.f : l;
    float* orow = o + base + (size_t)row * DH + q4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[4 * j] = acc[j] / denom;
  }
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int TQ = 64;    // query rows per block (16 per warp)
constexpr int TK = 64;    // key rows per staged tile
constexpr int TNT = 128;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (TQ + 4 * TK) * DH;  // Q, K x 2, V x 2
}

template <int DH>
__global__ void __launch_bounds__(TNT)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int heads,
                      int t_len, float scale_log2) {
  using Sw = mma::Swizzle<DH>;
  constexpr int KD = DH / 16;  // k-steps of q.k^T
  constexpr int NO = DH / 8;   // n-tiles of O
  constexpr int NS = TK / 8;   // n-tiles of the score tile
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char fsm[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fsm);
  __nv_bfloat16* Ks = Qs + TQ * DH;  // two buffers
  __nv_bfloat16* Vs = Ks + 2 * TK * DH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb_ = k + base;
  const __nv_bfloat16* vb_ = v + base;

  // rows [row0, row0 + n) of src into a swizzled tile; rows >= T read as 0
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int n) {
    for (int i = tid; i < n * CH; i += TNT) {
      const int r = i / CH, ch = i % CH, row = row0 + r;
      const bool ok = row < t_len;
      mma::cp_async16(mma::smem_u32(dst + Sw::off(r, ch)),
                      src + (size_t)(ok ? row : 0) * DH + ch * 8, ok);
    }
  };

  const int n_kb = (valid + TK - 1) / TK;
  if (n_kb > 0) {
    stage(Qs, qb, q0, TQ);
    stage(Ks, kb_, 0, TK);
    stage(Vs, vb_, 0, TK);
    mma::cp_async_commit();
  }

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max, log2 domain (rows g, g + 8)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum

  for (int kb = 0; kb < n_kb; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < n_kb) {
      stage(Ks + (cur ^ 1) * TK * DH, kb_, (kb + 1) * TK, TK);
      stage(Vs + (cur ^ 1) * TK * DH, vb_, (kb + 1) * TK, TK);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma::ldsm_x4(qf[kd], mma::smem_u32(Qs + Sw::off(warp * 16 + (lane & 15),
                                                        2 * kd + (lane >> 4))));
    }
    const __nv_bfloat16* Kc = Ks + cur * TK * DH;
    const __nv_bfloat16* Vc = Vs + cur * TK * DH;

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        mma::ldsm_x4(b, mma::smem_u32(Kc + Sw::off(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                   2 * kd + ((lane >> 3) & 1))));
        mma::mma_bf16(s[2 * np], qf[kd], b[0], b[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kd], b[2], b[3]);
      }
    }

    // mask keys >= len, scale into the log2 domain, row max over the quad
    const int k0 = kb * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        s[n][e] = col < valid ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no valid key so far: exp2(-inf - -inf) must not give NaN
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_safe[r]);  // 0 while m = -inf
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // p in f32 for the row sum, in bf16 as the A operand of p.v
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[2 * j + h][e] - m_safe[e >> 1]);  // 0 at masked keys
          l[e >> 1] += p[e];
        }
        a[2 * h] = mma::pack_bf16(p[0], p[1]);
        a[2 * h + 1] = mma::pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        mma::ldsm_x4_t(b, mma::smem_u32(Vc + Sw::off(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                     2 * dp + (lane >> 4))));
        mma::mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= t_len) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + base + (size_t)row * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          mma::pack_bf16(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    if (tq == 0)
      lse[(size_t)bh * t_len + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const int* lens, void* o,
               float* lse, int bh, int heads, int t_len, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lens, static_cast<float*>(o), lse, heads, t_len,
      rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const int* lens, void* o,
                float* lse, int bh, int heads, int t_len, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + TQ - 1) / TQ, bh);
  using bf = __nv_bfloat16;
  flash_fwd_bf16_kernel<DH><<<grid, TNT, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), lens,
      static_cast<bf*>(o), lse, heads, t_len, LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, const int* lens,
           void* o, float* lse, int bh, int heads, int t_len, cudaStream_t s) {
  if (dtype == 0) return launch_f32<DH>(q, k, v, lens, o, lse, bh, heads, t_len, s);
  if (dtype == 1) return launch_bf16<DH>(q, k, v, lens, o, lse, bh, heads, t_len, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int masg_flash_fwd(const void* q, const void* k, const void* v,
                              const int* lens, void* o, float* lse, int bh,
                              int heads, int t_len, int dh, int dtype,
                              void* stream) {
  if (bh <= 0 || t_len <= 0) return 0;
  if (heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, s);
    case 32: return launch<32>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, s);
    case 64: return launch<64>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, s);
    case 128: return launch<128>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
