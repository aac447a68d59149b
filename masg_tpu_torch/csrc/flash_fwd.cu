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
// f32 (flash_fwd_kernel<DH, RI>): register-tiled SIMT on the CUDA cores, in
// full f32 so that the path meets masg_tpu's 2e-5 bar (TF32 would lose three
// digits). One block of 4 warps per (b*h, 16 * RI query rows); RI = 4 (64-row
// tiles), or RI = 2 (32-row tiles) where 64-row tiles would leave SMs without
// a block (T = 128 at B*H = 32). Lane l of warp w owns the RI query rows of
// row group rg = 4 w + l / 8 and the keys kg + 8 j (kg = l % 8, j < 8) of
// each 64-key tile, so a row's max and sum are shuffles among eight lanes of
// one warp. The query tile, times 1/sqrt(Dh), stays in shared memory; K and V
// tiles come by cp.async in 16-byte chunks, Q and K swizzled (f32_util.cuh),
// each in one buffer: K of tile j + 1 is in flight while p.v of tile j runs,
// V of tile j + 1 while the scores of tile j + 1 run. Scores: an RI x 8
// micro-tile per thread, built over d in steps of 4 from float4 loads (RI of
// q, broadcast within a quarter-warp, 8 of k: 128 FMAs per 12 loads at
// RI = 4, none with a bank conflict). p goes through shared memory as p[key][row],
// chunks of RI rows swizzled by key, so one load gives a thread's RI rows of
// p for one key; O is an RI x Dh/8 micro-tile (4 x 16 at Dh = 128: 64 FMAs
// per 5 loads). The online softmax is K1's in natural-log units with expf;
// each lane keeps its part of the row sum, reduced once at the end. Shared
// memory at Dh = 128: 112 KB (RI = 4), two blocks per SM. Its launcher sets
// the kernel's attributes and reads the SM count once per device
// (launch_util.cuh), so a call makes no runtime query.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_util.cuh"
#include "launch_util.cuh"
#include "mma_util.cuh"

namespace {

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int FK = 64;    // key rows per staged tile
constexpr int FNT = 128;  // threads per block: 4 warps x 4 row groups x 8 key groups

template <int DH, int RI>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * RI * DH + 2 * FK * DH + FK * 16 * RI);  // Q, K, V, p
}

template <int DH, int RI>
__global__ void __launch_bounds__(FNT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lens,
                 float* __restrict__ o, float* __restrict__ lse, int heads,
                 int t_len, float scale) {
  constexpr int BQ = 16 * RI;                 // query rows per block
  constexpr int NCH = DH / 4;                 // 16-byte chunks per row
  constexpr int VW = DH >= 32 ? 4 : DH / 8;   // O columns per vector
  constexpr int NJ = DH / (8 * VW);           // O vectors per row and thread
  using SwK = f32::Swz<DH>;                    // K: read 8 rows apart (keys kg + 8 j)
  using SwQ = f32::Swz<DH, RI == 4 ? 2 : 1>;  // Q: read RI rows apart (rows rg * RI + i)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;          // BQ x DH, times scale, swizzled
  float* Ks = Qs + BQ * DH;  // FK x DH, swizzled
  float* Vs = Ks + FK * DH;  // FK x DH
  float* Ps = Vs + FK * DH;  // p[key][row]: FK x BQ, chunk rg of key c at rg ^ (c & 7)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp * 4 + (lane >> 3);  // this thread's rows: rg * RI + i
  const int kg = lane & 7;                // this thread's keys: kg + 8 j
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;

  // rows [row0, row0 + FK) of src into a tile by cp.async; rows >= T read as 0
  auto stage = [&](float* dst, const float* src, int row0, bool swizzled) {
    for (int i = tid; i < FK * NCH; i += FNT) {
      const int r = i / NCH, d = 4 * (i % NCH), row = row0 + r;
      const bool ok = row < t_len;
      mma::cp_async16(mma::smem_u32(dst + (swizzled ? SwK::off(r, d) : r * DH + d)),
                      src + base + (size_t)(ok ? row : 0) * DH + d, ok);
    }
  };

  const int n_kb = (valid + FK - 1) / FK;
  if (n_kb > 0) {
    stage(Ks, k, 0, true);
    mma::cp_async_commit();
    stage(Vs, v, 0, false);
    mma::cp_async_commit();
    for (int i = tid; i < BQ * NCH; i += FNT) {  // once per block, through registers
      const int r = i / NCH, d = 4 * (i % NCH), row = q0 + r;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < t_len) f32::ldv<4>(x, q + base + (size_t)row * DH + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= scale;
      f32::stv<4>(Qs + SwQ::off(r, d), x);
    }
  }

  float acc[RI][NJ * VW];
  float m[RI], l[RI];  // row max (natural log units); this lane's part of the row sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ * VW; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * FK;
    mma::cp_async_wait<1>();  // this tile's K is in (its V may still be in flight)
    __syncthreads();

    float s[RI][8];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float qv[RI][4], kv[8][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) f32::ldv<4>(qv[i], Qs + SwQ::off(rg * RI + i, d));
#pragma unroll
      for (int j = 0; j < 8; ++j) f32::ldv<4>(kv[j], Ks + SwK::off(kg + 8 * j, d));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }
    __syncthreads();  // every warp is done with this K tile: fetch the next one
    if (kb + 1 < n_kb) {
      stage(Ks, k, k0 + FK, true);
      mma::cp_async_commit();
    }

    // online softmax over the tile: mask keys >= len, row max over the 8 lanes
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k0 + kg + 8 * j >= valid) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      // a row with no valid key so far: exp(-inf - -inf) must not give NaN
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);  // 0 while m = -inf
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NJ * VW; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);  // 0 at masked keys
        l[i] += s[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pr[i] = s[i][j];
      f32::stv<RI>(Ps + (kg + 8 * j) * BQ + (rg ^ kg) * RI, pr);  // (kg + 8 j) & 7 = kg
    }

    if (kb + 1 < n_kb)
      mma::cp_async_wait<1>();  // this tile's V is in (the next K may still be in flight)
    else
      mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FK; ++c) {
      float pr[RI];
      f32::ldv<RI>(pr, Ps + c * BQ + (rg ^ (c & 7)) * RI);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float vv[VW];
        f32::ldv<VW>(vv, Vs + c * DH + (kg + 8 * jj) * VW);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][jj * VW + e] = fmaf(pr[i], vv[e], acc[i][jj * VW + e]);
      }
    }
    __syncthreads();  // every warp is done with this V tile (and with p)
    if (kb + 1 < n_kb) {
      stage(Vs, v, k0 + FK, false);
      mma::cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {  // the whole warp takes part in the shuffles
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg * RI + i;
    if (row >= t_len) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + base + (size_t)row * DH;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float ov[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) ov[e] = acc[i][jj * VW + e] / denom;
      f32::stv<VW>(orow + (kg + 8 * jj) * VW, ov);
    }
    if (kg == 0) lse[(size_t)bh * t_len + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
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

template <int DH, int RI>
int launch_f32_tiles(const void* q, const void* k, const void* v, const int* lens, void* o,
                     float* lse, int bh, int heads, int t_len, int device,
                     cudaStream_t stream) {
  static std::atomic<uint64_t> attrs_set{0};
  const size_t smem = smem_bytes<DH, RI>();
  // two blocks of 112 KB need the largest shared-memory carveout
  if (int e = once::set_attributes(attrs_set, device, flash_fwd_kernel<DH, RI>, smem,
                                          true))
    return e;
  const dim3 grid((t_len + 16 * RI - 1) / (16 * RI), bh);
  flash_fwd_kernel<DH, RI><<<grid, FNT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lens, static_cast<float*>(o), lse, heads, t_len,
      rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

// 64-row query tiles; 32-row ones where the 64-row grid has fewer blocks than
// the card has SMs
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const int* lens, void* o,
               float* lse, int bh, int heads, int t_len, int device, cudaStream_t stream) {
  int sms = 0;
  if (int e = once::sm_count(device, &sms)) return e;
  if ((long long)((t_len + 63) / 64) * bh < sms)
    return launch_f32_tiles<DH, 2>(q, k, v, lens, o, lse, bh, heads, t_len, device, stream);
  return launch_f32_tiles<DH, 4>(q, k, v, lens, o, lse, bh, heads, t_len, device, stream);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const int* lens, void* o,
                float* lse, int bh, int heads, int t_len, int device, cudaStream_t stream) {
  static std::atomic<uint64_t> attrs_set{0};
  const size_t smem = bf16_smem_bytes<DH>();
  if (int e = once::set_attributes(attrs_set, device, flash_fwd_bf16_kernel<DH>, smem, false))
    return e;
  const dim3 grid((t_len + TQ - 1) / TQ, bh);
  using bf = __nv_bfloat16;
  flash_fwd_bf16_kernel<DH><<<grid, TNT, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), lens,
      static_cast<bf*>(o), lse, heads, t_len, LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, const int* lens,
           void* o, float* lse, int bh, int heads, int t_len, int device, cudaStream_t s) {
  if (dtype == 0) return launch_f32<DH>(q, k, v, lens, o, lse, bh, heads, t_len, device, s);
  if (dtype == 1) return launch_bf16<DH>(q, k, v, lens, o, lse, bh, heads, t_len, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the index of the current device,
// which the stream belongs to. Returns a cudaError_t code (0 = launched).
extern "C" int masg_flash_fwd(const void* q, const void* k, const void* v,
                              const int* lens, void* o, float* lse, int bh,
                              int heads, int t_len, int dh, int dtype, int device,
                              void* stream) {
  if (bh <= 0 || t_len <= 0) return 0;
  if (heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, device, s);
    case 32: return launch<32>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, device, s);
    case 64: return launch<64>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, device, s);
    case 128: return launch<128>(dtype, q, k, v, lens, o, lse, bh, heads, t_len, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
