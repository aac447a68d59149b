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
// f32 (flash_dq_kernel, flash_dkv_kernel): f32 FMAs on the CUDA cores, so
// that the f32 path meets masg_tpu's 5e-3 bar with sums ~1e-6 off (TF32
// would lose three digits).
//   K2 (flash_dq_kernel<DH, RI>, register-tiled, K1's scheme): one block of
//   4 warps per (b*h, 16 * RI query rows); RI = 4 (64-row tiles), or RI = 2
//   (32-row tiles) where 64-row tiles would leave SMs without a block (T = 128
//   at B*H = 32). The query tile (times 1/sqrt(Dh)) and its do rows stay in
//   shared memory, swizzled; 32-key K and V tiles come by cp.async in 16-byte
//   chunks, one buffer each, fetched so that each load overlaps work: per key
//   tile, dp = do v^T runs first (then V of the next tile is fetched), then
//   s = q k^T and ds = exp(s - LSE) * (dp - delta), then dQ += ds k (then K of
//   the next tile is fetched, and arrives during the next tile's dp). Lane l
//   of warp w owns rows rg * RI + i (rg = 4 w + l / 8) and keys kg + 8 j (kg =
//   l % 8, j < 4): RI x 4 micro-tiles of dp and s over d in steps of 4 from
//   float4 loads (RI + 4 loads per 16 RI FMAs), dp kept in registers while s
//   runs. ds goes to shared memory as ds[key][row], chunks of RI rows swizzled
//   by key, so one load gives a thread's RI rows for one key; dQ is an RI x
//   Dh/8 micro-tile (4 x 16 at Dh = 128: 64 FMAs per 5 loads). Numerics of
//   the plain version: natural-log LSE and expf. Shared memory at Dh = 128:
//   104 KB (RI = 4), two blocks per SM; what bounds it is the shared-memory
//   loads and the FMA issue of the three products, at a fill of 320 blocks
//   (T = 640) on 264 slots.
//   K3 (flash_dkv_kernel<DH>, register-tiled): one block of 8 warps per
//   (b*h, 64-key tile), scale * K and V resident in shared memory; 32-query
//   tiles of q and do (rows >= T zero-filled) double-buffered by cp.async in
//   16-byte chunks, their LSE and delta staged beside them. Per query tile,
//   warps 0-3 build s^T and warps 4-7 dp^T, each thread a 4-key x 4-query
//   micro-tile over d in steps of 4 from float4 loads (8 loads per 64 FMAs);
//   p^T = exp(s^T - LSE) and dp^T - delta go to shared memory as [query][key],
//   chunks of 4 keys swizzled by the query, so one load gives four keys. Then
//   every thread owns a 4-key x Dh/16-column micro-tile of dK and of dV (64
//   accumulators at Dh = 128) and adds p^T do and (p^T * (dp^T - delta)) q
//   per query: 6 loads per 64 FMAs. K, V, q and do tiles are XOR-swizzled
//   (f32_util.cuh) so that no 16-byte load has a bank conflict.
//   ~145 KB of shared memory at Dh = 128, so one block per SM: two would
//   need <= 113 KB, i.e. 16-query tiles, and <= 128 registers a thread,
//   which the 64 accumulators and the score micro-tile do not leave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_util.cuh"
#include "launch_util.cuh"
#include "mma_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int DQK = 32;    // K2: key rows per staged tile
constexpr int DQNT = 128;  // K2: threads per block: 4 warps x 4 row groups x 8 key groups

template <int DH, int RI>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * 16 * RI * DH + 2 * DQK * DH + DQK * 16 * RI);  // Q, dO, K, V, ds
}

template <int DH, int RI>
__global__ void __launch_bounds__(DQNT, 2)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lens, float* __restrict__ dq, int heads,
                int t_len, float scale) {
  constexpr int BQ = 16 * RI;                 // query rows per block
  constexpr int NCH = DH / 4;                 // 16-byte chunks per row
  constexpr int KJ = DQK / 8;                 // keys per thread in the score micro-tile
  constexpr int VW = DH >= 32 ? 4 : DH / 8;   // dQ columns per vector
  constexpr int NJ = DH / (8 * VW);           // dQ vectors per row and thread
  using SwK = f32::Swz<DH>;                    // K, V: read 8 rows apart (keys kg + 8 j)
  using SwQ = f32::Swz<DH, RI == 4 ? 2 : 1>;  // q, do: read RI rows apart (rows rg * RI + i)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // BQ x DH, times scale, swizzled
  float* dOs = Qs + BQ * DH;   // BQ x DH, swizzled
  float* Ks = dOs + BQ * DH;   // DQK x DH, swizzled
  float* Vs = Ks + DQK * DH;   // DQK x DH, swizzled
  float* DSs = Vs + DQK * DH;  // ds[key][row]: DQK x BQ, chunk rg of key c at rg ^ (c & 7)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp * 4 + (lane >> 3);  // this thread's rows: rg * RI + i
  const int kg = lane & 7;                // this thread's keys: kg + 8 j
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;

  // rows [row0, row0 + DQK) of src into a swizzled tile by cp.async; rows >= T read as 0
  auto stage = [&](float* dst, const float* src, int row0) {
    for (int i = tid; i < DQK * NCH; i += DQNT) {
      const int r = i / NCH, d = 4 * (i % NCH), row = row0 + r;
      const bool ok = row < t_len;
      mma::cp_async16(mma::smem_u32(dst + SwK::off(r, d)),
                      src + base + (size_t)(ok ? row : 0) * DH + d, ok);
    }
  };

  // this thread's rows: LSE (a row that is dead or past T contributes nothing)
  // and delta
  float row_lse[RI], row_delta[RI];
  bool live[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg * RI + i;
    const float l = row < t_len ? lse[(size_t)bh * t_len + row] : -INFINITY;
    live[i] = isfinite(l);
    row_lse[i] = live[i] ? l : 0.f;
    row_delta[i] = row < t_len ? delta[(size_t)bh * t_len + row] : 0.f;
  }

  const int n_kb = (valid + DQK - 1) / DQK;
  if (n_kb > 0) {
    stage(Vs, v, 0);
    mma::cp_async_commit();
    stage(Ks, k, 0);
    mma::cp_async_commit();
    for (int i = tid; i < BQ * NCH; i += DQNT) {  // once per block, through registers
      const int r = i / NCH, d = 4 * (i % NCH), row = q0 + r;
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < t_len) {
        f32::ldv<4>(x, q + base + (size_t)row * DH + d);
        f32::ldv<4>(y, dout + base + (size_t)row * DH + d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= scale;
      f32::stv<4>(Qs + SwQ::off(r, d), x);
      f32::stv<4>(dOs + SwQ::off(r, d), y);
    }
  }

  float acc[RI][NJ * VW];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NJ * VW; ++c) acc[i][c] = 0.f;

  // an RI x KJ micro-tile of a . b^T over d, a from rows rg * RI + i of A
  // (SwQ), b from rows kg + 8 j of B (SwK)
  auto micro = [&](float (&s)[RI][KJ], const float* A, const float* Bt) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float av[RI][4], bv[KJ][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) f32::ldv<4>(av[i], A + SwQ::off(rg * RI + i, d));
#pragma unroll
      for (int j = 0; j < KJ; ++j) f32::ldv<4>(bv[j], Bt + SwK::off(kg + 8 * j, d));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
    }
  };

  // Per key tile: dp = do v^T (V of the next tile is fetched after it), then
  // s = (scale q) k^T and ds = exp(s - LSE) (dp - delta) to shared memory,
  // then dQ += ds k (K of the next tile is fetched after it, and arrives
  // while the next tile's dp runs).
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * DQK;
    mma::cp_async_wait<1>();  // this tile's V is in (its K may still be in flight)
    __syncthreads();
    float dp[RI][KJ];
    micro(dp, dOs, Vs);
    __syncthreads();  // every warp is done with this V tile: fetch the next one
    if (kb + 1 < n_kb) {
      stage(Vs, v, k0 + DQK);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();  // this tile's K is in (the next V may still be in flight)
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    float s[RI][KJ];
    micro(s, Qs, Ks);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const bool key_on = k0 + kg + 8 * j < valid;
      float ds[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = key_on && live[i] ? expf(s[i][j] - row_lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - row_delta[i]);
      }
      f32::stv<RI>(DSs + (kg + 8 * j) * BQ + (rg ^ kg) * RI, ds);  // (kg + 8 j) & 7 = kg
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      float ds[RI];
      f32::ldv<RI>(ds, DSs + c * BQ + (rg ^ (c & 7)) * RI);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float kv[VW];
        f32::ldv<VW>(kv, Ks + SwK::off(c, (kg + 8 * jj) * VW));
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][jj * VW + e] = fmaf(ds[i], kv[e], acc[i][jj * VW + e]);
      }
    }
    __syncthreads();  // every warp is done with this K tile (and with ds)
    if (kb + 1 < n_kb) {
      stage(Ks, k, k0 + DQK);
      mma::cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg * RI + i;
    if (row >= t_len) continue;
    float* orow = dq + base + (size_t)row * DH;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float ov[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) ov[e] = scale * acc[i][jj * VW + e];
      f32::stv<VW>(orow + (kg + 8 * jj) * VW, ov);
    }
  }
}

constexpr int KT = 64;    // K3: key rows per block
constexpr int QT = 32;    // K3: query rows per staged tile
constexpr int KNT = 256;  // K3: threads per block

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // K, V; Q x 2, dO x 2; p^T, dp^T - delta; LSE x 2, delta x 2
  return sizeof(float) * (2 * KT * DH + 4 * QT * DH + 2 * QT * KT + 4 * QT);
}

template <int DH>
__global__ void __launch_bounds__(KNT, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lens, float* __restrict__ dk,
                 float* __restrict__ dv, int heads, int t_len, float scale) {
  constexpr int NCH = DH / 4;                  // 16-byte chunks per row
  constexpr int VW = DH >= 64 ? 4 : DH / 16;   // dK / dV columns per vector
  constexpr int NJ = DH / (16 * VW);           // dK / dV vectors per key and thread
  using SwK = f32::Swz<DH, 2>;  // K, V: read 4 rows apart (keys 4 kg + i)
  using SwQ = f32::Swz<DH>;     // q, do: read 8 rows apart (queries qg + 8 j)
  constexpr int QJ = QT / 8;    // queries per thread in the score micro-tile
  static_assert(KNT == 256 && KT == 64 && QT % 8 == 0 && 2 * QT <= KNT,
                "16 key groups x 8 query groups per half block; one thread per staged stat");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // scale * k
  float* Vs = Ks + KT * DH;
  float* Qs = Vs + KT * DH;      // two buffers
  float* dOs = Qs + 2 * QT * DH;  // two buffers
  float* Ps = dOs + 2 * QT * DH;  // p^T as [query][key], chunk c of query r at c ^ (r & 7)
  float* DPs = Ps + QT * KT;      // dp^T - delta, the same layout
  float* Ls = DPs + QT * KT;      // two buffers
  float* Ds = Ls + 2 * QT;        // two buffers

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, k0 = blockIdx.x * KT;
  const int valid = min(max(lens[bh / heads], 0), t_len);
  const size_t base = (size_t)bh * t_len * DH;

  // q and do rows [r0, r0 + QT) into buffer `buf` by cp.async (rows >= T read
  // as 0), with their LSE and delta; a query row at or past the length (or
  // dead) contributes nothing (see the header): LSE = +inf gives p = 0
  auto stage_q = [&](int buf, int r0) {
    for (int i = tid; i < QT * NCH; i += KNT) {
      const int r = i / NCH, d = 4 * (i % NCH), row = r0 + r;
      const bool ok = row < t_len;
      const size_t src = base + (size_t)(ok ? row : 0) * DH + d;
      mma::cp_async16(mma::smem_u32(Qs + buf * QT * DH + SwQ::off(r, d)), q + src, ok);
      mma::cp_async16(mma::smem_u32(dOs + buf * QT * DH + SwQ::off(r, d)), dout + src, ok);
    }
    const int i = tid % QT, row = r0 + i;
    const bool on = row < valid;
    if (tid < QT) {
      const float l = on ? lse[(size_t)bh * t_len + row] : 0.f;
      Ls[buf * QT + i] = on && isfinite(l) ? l : INFINITY;
    } else if (tid < 2 * QT) {
      Ds[buf * QT + i] = on ? delta[(size_t)bh * t_len + row] : 0.f;
    }
  };

  // a key tile at or past the length sees no query: it writes zeros below
  const int n_qb = k0 >= valid ? 0 : (valid + QT - 1) / QT;
  if (n_qb > 0) {
    stage_q(0, 0);
    mma::cp_async_commit();
    for (int i = tid; i < KT * NCH; i += KNT) {  // once per block, through registers
      const int r = i / NCH, d = 4 * (i % NCH), row = k0 + r;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < t_len) {
        f32::ldv<4>(kx, k + base + (size_t)row * DH + d);
        f32::ldv<4>(vx, v + base + (size_t)row * DH + d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) kx[e] *= scale;
      f32::stv<4>(Ks + SwK::off(r, d), kx);
      f32::stv<4>(Vs + SwK::off(r, d), vx);
    }
  }

  // the dK / dV micro-tile: keys 4 kd + i, columns (cg + 16 jj) * VW + e
  const int kd = tid >> 4, cg = tid & 15;
  float gk[4][NJ * VW], gv[4][NJ * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ * VW; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int qb = 0; qb < n_qb; ++qb) {
    const int cur = qb & 1;
    if (qb + 1 < n_qb) {
      stage_q(cur ^ 1, (qb + 1) * QT);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qc = Qs + cur * QT * DH;
    const float* dOc = dOs + cur * QT * DH;

    {
      // warps 0-3: s^T = (scale k) q^T -> p^T; warps 4-7: dp^T = v do^T -> dp^T - delta.
      // Thread t: keys 4 kg + i (i < 4), queries qg + 8 j (j < QJ) of the tile.
      const bool is_dp = tid >= KNT / 2;
      const int t = tid & (KNT / 2 - 1), kg = t >> 3, qg = t & 7;
      const float* A = is_dp ? Vs : Ks;
      const float* Bt = is_dp ? dOc : Qc;
      float acc[4][QJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
        float a[4][4], b[QJ][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) f32::ldv<4>(a[i], A + SwK::off(4 * kg + i, d));
#pragma unroll
        for (int j = 0; j < QJ; ++j) f32::ldv<4>(b[j], Bt + SwQ::off(qg + 8 * j, d));
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < QJ; ++j) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
      }
      const float* stat = (is_dp ? Ds : Ls) + cur * QT;
      float* dst = is_dp ? DPs : Ps;
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int c = qg + 8 * j;
        const float x = stat[c];
        float out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[i] = is_dp ? acc[i][j] - x
                         : (k0 + 4 * kg + i < valid ? expf(acc[i][j] - x) : 0.f);
        f32::stv<4>(dst + c * KT + ((kg ^ qg) << 2), out);  // (qg + 8 j) & 7 = qg
      }
    }
    __syncthreads();

    // dV += p^T do, dK += (p^T * (dp^T - delta)) q, one query at a time
#pragma unroll 2
    for (int c = 0; c < QT; ++c) {
      float p[4], dpd[4];
      f32::ldv<4>(p, Ps + c * KT + ((kd ^ (c & 7)) << 2));
      f32::ldv<4>(dpd, DPs + c * KT + ((kd ^ (c & 7)) << 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) dpd[i] *= p[i];  // ds^T
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float qv[VW], ov[VW];
        const int col = (cg + 16 * jj) * VW;
        f32::ldv<VW>(qv, Qc + SwQ::off(c, col));
        f32::ldv<VW>(ov, dOc + SwQ::off(c, col));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            gv[i][jj * VW + e] = fmaf(p[i], ov[e], gv[i][jj * VW + e]);
            gk[i][jj * VW + e] = fmaf(dpd[i], qv[e], gk[i][jj * VW + e]);
          }
      }
    }
    __syncthreads();  // these buffers are refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * kd + i;
    if (key >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = (cg + 16 * jj) * VW;
      float ok[VW], ov[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        ok[e] = scale * gk[i][jj * VW + e];
        ov[e] = gv[i][jj * VW + e];
      }
      f32::stv<VW>(dk + base + (size_t)key * DH + col, ok);
      f32::stv<VW>(dv + base + (size_t)key * DH + col, ov);
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
  int device;  // the current device, which the stream belongs to
  cudaStream_t stream;
};

template <int DH, int RI>
int launch_dq_tiles(const Args& a) {
  static std::atomic<uint64_t> attrs_set{0};
  const size_t smem = dq_smem_bytes<DH, RI>();
  // two blocks of 104 KB need the largest shared-memory carveout
  if (int e = once::set_attributes(attrs_set, a.device, flash_dq_kernel<DH, RI>, smem,
                                          true))
    return e;
  const dim3 grid((a.t_len + 16 * RI - 1) / (16 * RI), a.bh);
  flash_dq_kernel<DH, RI><<<grid, DQNT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.lens, static_cast<float*>(a.out0), a.heads, a.t_len, rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

// 64-row query tiles; 32-row ones where the 64-row grid has fewer blocks than
// the card has SMs (K1's rule)
template <int DH>
int launch_dq(const Args& a) {
  int sms = 0;
  if (int e = once::sm_count(a.device, &sms)) return e;
  if ((long long)((a.t_len + 63) / 64) * a.bh < sms) return launch_dq_tiles<DH, 2>(a);
  return launch_dq_tiles<DH, 4>(a);
}

template <int DH>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DH>();
  static std::atomic<uint64_t> attrs_set{0};
  if (int e = once::set_attributes(attrs_set, a.device, flash_dkv_kernel<DH>, smem, false))
    return e;
  const dim3 grid((a.t_len + KT - 1) / KT, a.bh);
  flash_dkv_kernel<DH><<<grid, KNT, smem, a.stream>>>(
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
  static std::atomic<uint64_t> attrs_set{0};
  if (int e = once::set_attributes(attrs_set, a.device, flash_dq_bf16_kernel<DH>, smem, false))
    return e;
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
  static std::atomic<uint64_t> attrs_set{0};
  if (int e = once::set_attributes(attrs_set, a.device, flash_dkv_bf16_kernel<DH>, smem, false))
    return e;
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

// dtype: 0 = float32, 1 = bfloat16; device: the index of the current device, which
// the stream belongs to. Each returns a cudaError_t code (0 = launched).
extern "C" int masg_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 const int* lens, void* dq, int bh, int heads, int t_len,
                                 int dh, int dtype, int device, void* stream) {
  const Args a{q, k, v, dout, lse, delta, lens, dq, nullptr, bh, heads, t_len, device,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dh, dtype);
}

extern "C" int masg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  const int* lens, void* dk, void* dv, int bh, int heads,
                                  int t_len, int dh, int dtype, int device, void* stream) {
  const Args a{q, k, v, dout, lse, delta, lens, dk, dv, bh, heads, t_len, device,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dh, dtype);
}
