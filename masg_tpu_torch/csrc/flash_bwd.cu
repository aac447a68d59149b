// Flash-attention backward for Hopper (sm_90a): kernels K2 (dQ) and K3 (dK, dV)
// of the port.
//
// Replace the Pallas TPU kernels masg_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (launched by _flash_bwd_call). With s = scale * q k^T,
// p = exp(s - LSE) recomputed from K1's saved row log-sum-exp and
// delta = rowsum(do * o) (computed by the caller, f32):
//   K2: dQ = scale * sum_keys [p * (do v^T - delta)] k
//   K3: dV = sum_rows p^T do,   dK = scale * sum_rows [p * (do v^T - delta)]^T q
// p is 0 at keys >= len[b] and at dead rows (LSE = -inf, a length-0 batch row),
// so such rows give no NaN. K3 also drops query rows >= len[b]: the model's
// cotangent is 0 there (every FFT block masks its pad rows), which is the
// contract of masg_tpu's backward; dQ at those rows is don't-care.
//
// Layout: q, k, v, do, dq, dk, dv are (B*H, T, Dh) contiguous, f32 or bf16;
// LSE and delta are (B*H, T) f32; lens is (B,) int32, read as lens[bh / H].
// Rows >= T are never written.
//
// Determinism: every output row is owned by exactly one block (K2 by its query
// tile, K3 by its key tile), so there are no atomics and the gradient is the
// same bit for bit from run to run. Both kernels do only the work the lengths
// need: K2 runs key tiles up to ceil(len / tile), K3 query tiles up to
// ceil(len / tile), and a K3 key tile at or past len loads nothing and writes
// zeros.
//
// What bounds them on the H100: per head, 3 (K2: s, dp, ds.k) and 4 (K3: s,
// dp, p^T.do, ds^T.q) products of 2 * len^2 * Dh flops over ~8 * T * Dh *
// bytes of I/O. At the FastSpeech2 shapes (B*H = 32, T <= 1000, Dh = 128) the
// bf16 bound is a few microseconds a call, by bytes or by the tensor cores
// about equally; what sets the time is how fast the tensor cores are fed from
// shared memory, the elementwise work on each score tile, and the fill of the
// card (64 blocks of 4 warps at T = 128 on 132 SMs).
//
// bf16 (flash_dq_bf16_kernel, flash_dkv_bf16_kernel): every product runs on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), the scheme of
// K1's bf16 kernel. One block of 4 warps per (b*h, 64-row tile); each warp owns
// 16 rows of the output and keeps them in mma accumulator fragments. The
// block's own 64 rows stay in shared memory; 64-row tiles of the other side are
// double-buffered by cp.async (rows past T zero-filled), all under the XOR
// swizzle of mma_util.cuh, so every ldmatrix is free of bank conflicts.
//   K2: per key tile, s = q k^T and dp = do v^T (q and do as A fragments,
//   loaded from shared memory each k-step, which keeps registers for the
//   16 x Dh dQ accumulator; K and V as B), p and ds = p * (dp - delta) on the
//   accumulator fragments, then ds, repacked into A fragments as K1 repacks p,
//   times K through ldmatrix.trans.
//   K3: the keys are the M dimension. s^T = k q^T and dp^T = v do^T come out
//   with a key per row, so p^T and ds^T repack straight into A fragments for
//   dV += p^T do and dK += ds^T q (do and q through ldmatrix.trans): no
//   transpose passes through shared memory. LSE and delta, indexed by the
//   query (the column), are staged per query tile in shared memory as f32. A
//   staged 64-query tile is worked in two 32-query halves, so the dK and dV
//   accumulators (2 x 16 x Dh f32 per warp) and the 16 x 32 s^T and dp^T fit
//   the 255-register cap without spilling.
// Numerics: the scores are scaled in f32 after the product, into the log2
// domain, with K1's normaliser (K1 writes LSE = (m + log2 l) ln 2). p and ds
// are rounded to bf16 only as the A operands of the products; sums, LSE and
// delta stay f32. A row that contributes nothing (dead; in K3 also >= len or
// >= T) carries an LSE of +inf, so p = exp2(s - inf) = 0 with no branch and no
// NaN. Shared memory at Dh = 128: 96 KB (K2) and 97 KB (K3), two blocks per SM.
// Like K1 they stay on mma.sync; wgmma + TMA is not queued for them.
//
// f32 (flash_dq_kernel, flash_dkv_kernel): the first, SIMT kernels, kept so
// the f32 path meets masg_tpu's 5e-3 bar with sums ~1e-6 off (TF32 would
// lose three digits). 256 threads, 4 per resident row; K2: one block per
// (b*h, 64-row query tile), the query tile (pre-scaled by 1/sqrt(Dh)) and its
// do rows in shared memory, 32-row K and V tiles staged one at a time, the
// 64 x 32 ds tile through shared memory, each thread accumulating Dh/4
// columns of dQ in registers. K3: one block per (b*h, 64-row key tile), K and
// V in shared memory, 32-row q / do tiles (with their LSE and delta) staged, p
// and ds through shared memory, Dh/4 columns of dK and dV per thread. Rows
// are padded by one float (no bank conflicts). f32 FMAs on the CUDA cores,
// bound by one shared-memory load per FMA; the register-tiled redesign is
// queued. Shared memory at Dh = 128: ~107 KB (K2) and ~116 KB (K3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int BR = 64;   // resident rows per block (query rows in K2, key rows in K3)
constexpr int BS = 32;   // rows per staged tile
constexpr int NT = 256;  // threads per block: 4 per resident row

template <int DH>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs (BR x DH+1); Ks, Vs (BS x DH+1); DSs (BR x BS+1)
  return sizeof(float) * (2 * BR * (DH + 1) + 2 * BS * (DH + 1) + BR * (BS + 1));
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs (BR x DH+1); Qs, dOs (BS x DH+1); Ps, DSs (BR x BS+1); lse, delta (BS)
  return sizeof(float) *
         (2 * BR * (DH + 1) + 2 * BS * (DH + 1) + 2 * BR * (BS + 1) + 2 * BS);
}

// Copies rows [r0, r0 + n) of a (t_len, DH) slab into shared memory (row stride
// DH + 1), times `mul`; rows at or past t_len read as 0.
template <int DH, int N>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0,
                                      int t_len, float mul) {
  for (int i = threadIdx.x; i < N * DH; i += NT) {
    const int rr = i / DH, d = i % DH, row = r0 + rr;
    dst[rr * (DH + 1) + d] = row < t_len ? src[(size_t)row * DH + d] * mul : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lens, float* __restrict__ dq, int heads,
                int t_len, float scale) {
  constexpr int S = DH + 1;  // padded row stride
  constexpr int PS = BS + 1;
  constexpr int NJ = DH / 4;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BR * S;
  float* Ks = dOs + BR * S;
  float* Vs = Ks + BS * S;
  float* DSs = Vs + BS * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int q4 = tid & 3;  // quarter of that row
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;
  const int row = q0 + r;

  stage<DH, BR>(Qs, q + base, q0, t_len, scale);
  stage<DH, BR>(dOs, dout + base, q0, t_len, 1.f);
  float row_lse = -INFINITY, row_delta = 0.f;
  if (row < t_len) {
    row_lse = lse[(size_t)bh * t_len + row];
    row_delta = delta[(size_t)bh * t_len + row];
  }
  const bool live = isfinite(row_lse);

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  const int n_kb = (valid + BS - 1) / BS;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // the previous tile's readers are done; Q and dO are visible
    const int k0 = kb * BS;
    stage<DH, BS>(Ks, k + base, k0, t_len, 1.f);
    stage<DH, BS>(Vs, v + base, k0, t_len, 1.f);
    __syncthreads();

    float s[8], dp[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = dp[jj] = 0.f;
    const float* qrow = Qs + r * S;
    const float* orow = dOs + r * S;
    const float* kcol = Ks + (q4 * 8) * S;
    const float* vcol = Vs + (q4 * 8) * S;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d], ov = orow[d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj] = fmaf(qv, kcol[jj * S + d], s[jj]);
        dp[jj] = fmaf(ov, vcol[jj * S + d], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const bool on = live && (k0 + q4 * 8 + jj < valid);
      const float p = on ? expf(s[jj] - row_lse) : 0.f;
      DSs[r * PS + q4 * 8 + jj] = p * (dp[jj] - row_delta);
    }
    __syncwarp();  // a row's ds is written and read by the same four lanes

    const float* dsrow = DSs + r * PS;
#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      const float ds = dsrow[c];
      const float* krow = Ks + c * S + q4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = fmaf(ds, krow[4 * j], acc[j]);
    }
  }

  if (row < t_len) {
    float* out = dq + base + (size_t)row * DH + q4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[4 * j] = scale * acc[j];
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lens, float* __restrict__ dk,
                 float* __restrict__ dv, int heads, int t_len, float scale) {
  constexpr int S = DH + 1;
  constexpr int PS = BS + 1;
  constexpr int NJ = DH / 4;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BR * S;
  float* Qs = Vs + BR * S;
  float* dOs = Qs + BS * S;
  float* Ps = dOs + BS * S;
  float* DSs = Ps + BR * PS;
  float* Ls = DSs + BR * PS;
  float* Ds = Ls + BS;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // key row within the tile
  const int q4 = tid & 3;  // quarter of that row
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;
  const int key = k0 + r;

  float gk[NJ], gv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) gk[j] = gv[j] = 0.f;

  // a key tile at or past the length sees no query: it writes zeros below
  const int n_qb = k0 >= valid ? 0 : (valid + BS - 1) / BS;
  if (n_qb > 0) {
    stage<DH, BR>(Ks, k + base, k0, t_len, scale);  // holds scale * k
    stage<DH, BR>(Vs, v + base, k0, t_len, 1.f);
  }
  for (int qb = 0; qb < n_qb; ++qb) {
    __syncthreads();  // the previous tile's readers are done; K and V are visible
    const int r0 = qb * BS;
    stage<DH, BS>(Qs, q + base, r0, t_len, 1.f);
    stage<DH, BS>(dOs, dout + base, r0, t_len, 1.f);
    if (tid < BS) {
      const int row = r0 + tid;
      // query rows at or past the length contribute nothing (see the header)
      Ls[tid] = row < valid ? lse[(size_t)bh * t_len + row] : -INFINITY;
      Ds[tid] = row < valid ? delta[(size_t)bh * t_len + row] : 0.f;
    }
    __syncthreads();

    float s[8], dp[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = dp[jj] = 0.f;
    const float* krow = Ks + r * S;
    const float* vrow = Vs + r * S;
    const float* qcol = Qs + (q4 * 8) * S;
    const float* ocol = dOs + (q4 * 8) * S;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj] = fmaf(kv, qcol[jj * S + d], s[jj]);
        dp[jj] = fmaf(vv, ocol[jj * S + d], dp[jj]);
      }
    }
    const bool key_on = key < valid;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = q4 * 8 + jj;
      const float l = Ls[c];
      const float p = (key_on && isfinite(l)) ? expf(s[jj] - l) : 0.f;
      Ps[r * PS + c] = p;
      DSs[r * PS + c] = p * (dp[jj] - Ds[c]);
    }
    __syncwarp();  // a key row's p and ds are written and read by the same four lanes

    const float* prow = Ps + r * PS;
    const float* dsrow = DSs + r * PS;
#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      const float p = prow[c], ds = dsrow[c];
      const float* qr = Qs + c * S + q4;
      const float* orr = dOs + c * S + q4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        gv[j] = fmaf(p, orr[4 * j], gv[j]);
        gk[j] = fmaf(ds, qr[4 * j], gk[j]);
      }
    }
  }

  if (key < t_len) {
    float* ok = dk + base + (size_t)key * DH + q4;
    float* ov = dv + base + (size_t)key * DH + q4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      ok[4 * j] = scale * gk[j];
      ov[4 * j] = gv[j];
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int TB = 64;    // rows per block (its output rows) and per staged tile
constexpr int TNT = 128;  // threads per block: 4 warps x 16 output rows
constexpr int QC = 32;    // K3: query columns per pass over a staged tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(bf16) * 6 * TB * DH;  // Q, dO; K x 2, V x 2
}

template <int DH>
constexpr size_t dkv_bf16_smem_bytes() {
  // K, V; Q x 2, dO x 2 (bf16); LSE x 2, delta x 2 (f32)
  return sizeof(bf16) * 6 * TB * DH + sizeof(float) * 4 * TB;
}

// Rows [row0, row0 + TB) of a (t_len, DH) slab into a swizzled tile by
// cp.async; rows >= t_len read as 0.
template <int DH>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int t_len) {
  using Sw = mma::Swizzle<DH>;
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TB * CH; i += TNT) {
    const int r = i / CH, ch = i % CH, row = row0 + r;
    const bool ok = row < t_len;
    mma::cp_async16(mma::smem_u32(dst + Sw::off(r, ch)),
                    src + (size_t)(ok ? row : 0) * DH + ch * 8, ok);
  }
}

// The A fragment (16 x 16, row-major) of rows r0.. and k-step kd of a tile.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kd,
                                       int lane) {
  using Sw = mma::Swizzle<DH>;
  mma::ldsm_x4(a, mma::smem_u32(tile + Sw::off(r0 + (lane & 15), 2 * kd + (lane >> 4))));
}

// B fragments of two n-tiles (rows n0..n0+15 of the tile are the n index)
// at k-step kd: b[0..1] for n0.., b[2..3] for n0 + 8..
template <int DH>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int kd,
                                       int lane) {
  using Sw = mma::Swizzle<DH>;
  mma::ldsm_x4(b, mma::smem_u32(tile + Sw::off(n0 + (lane & 7) + ((lane >> 4) << 3),
                                               2 * kd + ((lane >> 3) & 1))));
}

// B fragments through ldmatrix.trans (rows k0..k0+15 of the tile are the k
// index, columns the n index): b[0..1] for columns 16 dp.., b[2..3] for
// 16 dp + 8..
template <int DH>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile, int k0, int dp,
                                         int lane) {
  using Sw = mma::Swizzle<DH>;
  mma::ldsm_x4_t(b, mma::smem_u32(tile + Sw::off(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                 2 * dp + (lane >> 4))));
}

// LSE in the log2 domain; +inf for a row that contributes nothing, so that
// p = exp2(s - inf) = 0 there.
__device__ __forceinline__ float lse_log2(float l, bool on) {
  return on && isfinite(l) ? l * LOG2E : INFINITY;
}

template <int DH>
__global__ void __launch_bounds__(TNT)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dq, int heads,
                     int t_len, float scale, float scale_log2) {
  constexpr int KD = DH / 16;  // k-steps of q.k^T and do.v^T
  constexpr int NO = DH / 8;   // n-tiles of dQ
  constexpr int NS = TB / 8;   // n-tiles of the 16 x 64 score tile
  extern __shared__ __align__(128) unsigned char dsm[];
  bf16* Qs = reinterpret_cast<bf16*>(dsm);
  bf16* dOs = Qs + TB * DH;
  bf16* Ks = dOs + TB * DH;  // two buffers
  bf16* Vs = Ks + 2 * TB * DH;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * TB;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;

  // this lane's rows g and g + 8 of the warp's 16
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < t_len;
    lse2[r] = lse_log2(in ? lse[(size_t)bh * t_len + row] : 0.f, in);
    dl[r] = in ? delta[(size_t)bh * t_len + row] : 0.f;
  }

  const int n_kb = (valid + TB - 1) / TB;
  if (n_kb > 0) {
    stage_tile<DH>(Qs, q + base, q0, t_len);
    stage_tile<DH>(dOs, dout + base, q0, t_len);
    stage_tile<DH>(Ks, k + base, 0, t_len);
    stage_tile<DH>(Vs, v + base, 0, t_len);
    mma::cp_async_commit();
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < n_kb) {
      stage_tile<DH>(Ks + (cur ^ 1) * TB * DH, k + base, (kb + 1) * TB, t_len);
      stage_tile<DH>(Vs + (cur ^ 1) * TB * DH, v + base, (kb + 1) * TB, t_len);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kc = Ks + cur * TB * DH;
    const bf16* Vc = Vs + cur * TB * DH;

    // s = q k^T and dp = do v^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4], b[4];
      load_a<DH>(a, Qs, warp * 16, kd, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        load_b<DH>(b, Kc, np * 16, kd, lane);
        mma::mma_bf16(s[2 * np], a, b[0], b[1]);
        mma::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
      load_a<DH>(a, dOs, warp * 16, kd, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        load_b<DH>(b, Vc, np * 16, kd, lane);
        mma::mma_bf16(dp[2 * np], a, b[0], b[1]);
        mma::mma_bf16(dp[2 * np + 1], a, b[2], b[3]);
      }
    }

    // ds = p * (dp - delta) in f32, to bf16 A fragments, then dQ += ds k
    const int k0 = kb * TB;
#pragma unroll
    for (int j = 0; j < TB / 16; ++j) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * j + h;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const float p =
              col < valid ? exp2f(fmaf(s[n][e], scale_log2, -lse2[e >> 1])) : 0.f;
          ds[e] = p * (dp[n][e] - dl[e >> 1]);
        }
        a[2 * h] = mma::pack_bf16(ds[0], ds[1]);
        a[2 * h + 1] = mma::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t b[4];
        load_b_t<DH>(b, Kc, j * 16, d2, lane);
        mma::mma_bf16(acc[2 * d2], a, b[0], b[1]);
        mma::mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= t_len) continue;
    bf16* out = dq + base + (size_t)row * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          mma::pack_bf16(scale * acc[n][2 * r], scale * acc[n][2 * r + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(TNT)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ lens, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int heads, int t_len, float scale,
                      float scale_log2) {
  constexpr int KD = DH / 16;  // k-steps of k.q^T and v.do^T
  constexpr int NO = DH / 8;   // n-tiles of dK and dV
  constexpr int NC = QC / 8;   // n-tiles of the 16 x QC score tile
  static_assert(TNT == 2 * TB, "one thread per staged LSE and per staged delta");
  extern __shared__ __align__(128) unsigned char dsm[];
  bf16* Ks = reinterpret_cast<bf16*>(dsm);
  bf16* Vs = Ks + TB * DH;
  bf16* Qs = Vs + TB * DH;    // two buffers
  bf16* dOs = Qs + 2 * TB * DH;  // two buffers
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TB * DH);  // two buffers
  float* Ds = Ls + 2 * TB;                                  // two buffers

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * TB;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;
  // this lane's key rows g and g + 8 of the warp's 16
  const bool key_on[2] = {k0 + warp * 16 + g < valid, k0 + warp * 16 + g + 8 < valid};

  // LSE (log2 domain) and delta of query rows [r0, r0 + TB) into buffer `buf`;
  // rows at or past the length contribute nothing (see the header)
  auto stage_stats = [&](int buf, int r0) {
    const int i = threadIdx.x % TB, row = r0 + i;
    const bool on = row < valid;
    if (threadIdx.x < TB)
      Ls[buf * TB + i] = lse_log2(on ? lse[(size_t)bh * t_len + row] : 0.f, on);
    else
      Ds[buf * TB + i] = on ? delta[(size_t)bh * t_len + row] : 0.f;
  };

  // a key tile at or past the length sees no query: it writes zeros below
  const int n_qb = k0 >= valid ? 0 : (valid + TB - 1) / TB;
  if (n_qb > 0) {
    stage_tile<DH>(Ks, k + base, k0, t_len);
    stage_tile<DH>(Vs, v + base, k0, t_len);
    stage_tile<DH>(Qs, q + base, 0, t_len);
    stage_tile<DH>(dOs, dout + base, 0, t_len);
    mma::cp_async_commit();
    stage_stats(0, 0);
  }

  float gk[NO][4], gv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  for (int qb = 0; qb < n_qb; ++qb) {
    const int cur = qb & 1;
    if (qb + 1 < n_qb) {
      stage_tile<DH>(Qs + (cur ^ 1) * TB * DH, q + base, (qb + 1) * TB, t_len);
      stage_tile<DH>(dOs + (cur ^ 1) * TB * DH, dout + base, (qb + 1) * TB, t_len);
      mma::cp_async_commit();
      stage_stats(cur ^ 1, (qb + 1) * TB);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qc = Qs + cur * TB * DH;
    const bf16* dOc = dOs + cur * TB * DH;
    const float* Lc = Ls + cur * TB;
    const float* Dc = Ds + cur * TB;

#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += QC) {
      // s^T = k q^T and dp^T = v do^T: this warp's 16 keys x QC queries
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4], b[4];
        load_a<DH>(a, Ks, warp * 16, kd, lane);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          load_b<DH>(b, Qc, c0 + np * 16, kd, lane);
          mma::mma_bf16(s[2 * np], a, b[0], b[1]);
          mma::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
        load_a<DH>(a, Vs, warp * 16, kd, lane);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          load_b<DH>(b, dOc, c0 + np * 16, kd, lane);
          mma::mma_bf16(dp[2 * np], a, b[0], b[1]);
          mma::mma_bf16(dp[2 * np + 1], a, b[2], b[3]);
        }
      }

      // p^T and ds^T = p^T * (dp^T - delta) in f32, to bf16 A fragments, then
      // dV += p^T do and dK += ds^T q
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        uint32_t pa[4], da[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * j + h;
          const int col = c0 + n * 8 + 2 * tq;
          const float2 l = *reinterpret_cast<const float2*>(Lc + col);
          const float2 d = *reinterpret_cast<const float2*>(Dc + col);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float le = (e & 1) ? l.y : l.x;
            const float de = (e & 1) ? d.y : d.x;
            p[e] = key_on[e >> 1] ? exp2f(fmaf(s[n][e], scale_log2, -le)) : 0.f;
            ds[e] = p[e] * (dp[n][e] - de);
          }
          pa[2 * h] = mma::pack_bf16(p[0], p[1]);
          pa[2 * h + 1] = mma::pack_bf16(p[2], p[3]);
          da[2 * h] = mma::pack_bf16(ds[0], ds[1]);
          da[2 * h + 1] = mma::pack_bf16(ds[2], ds[3]);
        }
#pragma unroll
        for (int d2 = 0; d2 < NO / 2; ++d2) {
          uint32_t b[4];
          load_b_t<DH>(b, dOc, c0 + j * 16, d2, lane);
          mma::mma_bf16(gv[2 * d2], pa, b[0], b[1]);
          mma::mma_bf16(gv[2 * d2 + 1], pa, b[2], b[3]);
          load_b_t<DH>(b, Qc, c0 + j * 16, d2, lane);
          mma::mma_bf16(gk[2 * d2], da, b[0], b[1]);
          mma::mma_bf16(gk[2 * d2 + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // these buffers are refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= t_len) continue;
    bf16* ok = dk + base + (size_t)key * DH + 2 * tq;
    bf16* ov = dv + base + (size_t)key * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(ok + n * 8) =
          mma::pack_bf16(scale * gk[n][2 * r], scale * gk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(ov + n * 8) = mma::pack_bf16(gv[n][2 * r], gv[n][2 * r + 1]);
    }
  }
}

// ---- launchers ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lens;
  void *out0, *out1;  // dq; or dk, dv
  int bh, heads, t_len;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int DH>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<DH>();
  if (int e = set_smem(flash_dq_kernel<DH>, smem)) return e;
  const dim3 grid((a.t_len + BR - 1) / BR, a.bh);
  flash_dq_kernel<DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.lens, static_cast<float*>(a.out0), a.heads, a.t_len, rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DH>();
  if (int e = set_smem(flash_dkv_kernel<DH>, smem)) return e;
  const dim3 grid((a.t_len + BR - 1) / BR, a.bh);
  flash_dkv_kernel<DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.lens, static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.heads, a.t_len,
      rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

// K1's bf16 scores take LOG2E / sqrtf(DH); the recomputed p uses the same factor
template <int DH>
int launch_dq_bf16(const Args& a) {
  const size_t smem = dq_bf16_smem_bytes<DH>();
  if (int e = set_smem(flash_dq_bf16_kernel<DH>, smem)) return e;
  const dim3 grid((a.t_len + TB - 1) / TB, a.bh);
  flash_dq_bf16_kernel<DH><<<grid, TNT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.lens, static_cast<bf16*>(a.out0), a.heads, a.t_len, rsqrtf((float)DH),
      LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const Args& a) {
  const size_t smem = dkv_bf16_smem_bytes<DH>();
  if (int e = set_smem(flash_dkv_bf16_kernel<DH>, smem)) return e;
  const dim3 grid((a.t_len + TB - 1) / TB, a.bh);
  flash_dkv_bf16_kernel<DH><<<grid, TNT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      a.lens, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.heads, a.t_len,
      rsqrtf((float)DH), LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <bool DQ, int DH>
int launch(const Args& a, int dtype) {
  if (dtype == 0) return DQ ? launch_dq<DH>(a) : launch_dkv<DH>(a);
  if (dtype == 1) return DQ ? launch_dq_bf16<DH>(a) : launch_dkv_bf16<DH>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool DQ>
int dispatch(const Args& a, int dh, int dtype) {
  if (a.bh <= 0 || a.t_len <= 0) return 0;
  if (a.heads <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<DQ, 16>(a, dtype);
    case 32: return launch<DQ, 32>(a, dtype);
    case 64: return launch<DQ, 64>(a, dtype);
    case 128: return launch<DQ, 128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t code (0 = launched).
extern "C" int masg_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 const int* lens, void* dq, int bh, int heads, int t_len,
                                 int dh, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, lens, dq, nullptr, bh, heads, t_len,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dh, dtype);
}

extern "C" int masg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  const int* lens, void* dk, void* dv, int bh, int heads,
                                  int t_len, int dh, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, lens, dk, dv, bh, heads, t_len,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dh, dtype);
}
