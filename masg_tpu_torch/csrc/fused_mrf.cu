// Fused HiFi-GAN MRF stage for Hopper (sm_90a), kernel K4 of the port.
//
// Replaces the Pallas TPU kernel masg_tpu/ops/fused_mrf.py:_mrf_kernel
// (launched by fused_mrf_stage). One launch computes a whole multi-receptive-
// field stage on channel-last x (B, T, C):
//   for each resblock r (kernel k_r, dilations d_r0..):
//     h = x
//     for each dilation d:  h += conv(k,1)(lrelu(conv(k,d)(lrelu(h))))
//   out = mean_r h_r
// with leaky-relu slope 0.1, SAME zero padding at the sequence edges, each
// conv output rounded to the working dtype (bf16 or f32) after its bias as
// the unfused path rounds it, h rounded after every unit, and the resblock
// sum accumulated in f32. Rows outside [0, T) are zeroed after every conv,
// which reproduces each conv's own zero padding at the sequence edges. A
// row's summation order (taps, then input channels) does not depend on where
// its tile starts, so a chunked run matches a full run bit for bit.
//
// What bounds it on the H100: 2*C^2*sum(k) flops per row (1.03 Mflop at
// C = 64 for V1, ~2 kflop per byte of I/O), so it is bound by arithmetic,
// never by device memory. Both dtypes run every product on the tensor cores.
//
// bf16 (mrf_bf16_kernel): every conv tap is a product A_j . W_j on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), where A_j is the
// block's window shifted by (j - half) * d rows: ldmatrix takes one row
// address per lane, so the dilated shift costs nothing. One block of 12
// warps per (batch row, time tile) holds two bf16 buffers of the window in
// shared memory: h, and lrelu(t) (t = the first conv's output). Both are
// exact in bf16, since every value the chain keeps is rounded to bf16. The
// first conv of a unit applies lrelu to its A fragments as they load; the
// bias, rounding, edge zeroing and lrelu run in the epilogue on the
// accumulator fragments. Each warp computes 32-row x C tiles; the weights
// of a tap come from device memory through L1 in a fragment order packed
// once by the wrapper (16 bytes a lane per load, two n-tiles). Each resblock
// computes only the rows its own chain needs: its halo is chain_halo rounded
// up to 16 rows (16, 48, 64 for V1), so the recompute is 1.16x at C = 64
// (window 768 rows, tile 640) and 1.07x at C = 32 (1536, 1408), where the
// fixed 64-row halo around a 128-row tile cost 2x. The f32 resblock sum
// lives in a device-memory scratch (B, T, C) that only the block owning a
// tile row touches (no races; ~1.3 GB of traffic, ~0.4 ms, per C = 64
// stage). Shared memory: 208 KB at C = 64, 200 KB at C = 32.
//
// f32 (mrf_kernel, 3xTF32): the bf16 kernel's structure in f32, with every
// product on the tensor cores as three TF32 products (mma.sync m16n8k8, tf32
// in, f32 accumulate): x = hi + lo with hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: to nearest, ties away), and a.w = lo(a).hi(w) + hi(a).lo(w) +
// hi(a).hi(w). That keeps ~21 of f32's 24 bits, so the stage stays within a
// few 1e-6 of the f32 plain path (one TF32 product gives ~1e-3 and misses the
// 2e-5 bar). The tensor cores truncate as they accumulate: one chain of 264
// products per conv (k = 11, C = 64) drifted to 2.4e-5 on the card, so each
// chain covers two k-steps of 8 input channels (6 products) from 0 and joins
// the f32 sum by a rounded add. The two buffers hold h and lrelu(t) in f32
// (ldmatrix reads rows of floats as 8 x 4 matrices, which is the tf32 A
// fragment; f32_util.cuh's swizzle keeps it free of bank conflicts); lrelu
// and the hi/lo split are applied to the A fragments as they load. The packed
// weights hold hi(w) and w - hi(w) in fragment order (one float4 a lane per
// n-tile and k-step), so unpacking them is exact. 12 warps of 32-row tiles,
// 32 output channels a pass: 3 warps per SM sub-partition allow 168
// registers a thread, and 64 accumulators at C = 64 spilled, so C = 64 takes
// two passes, each loading and splitting the A fragments again. Windows of
// 384 rows (tile 256, 224 KB of shared memory) at C = 64 and 768 (tile 640,
// 208 KB) at C = 32, with the per-resblock halos above: 1.33x and 1.13x
// recompute, 9-12 and 21-24 warp tiles a conv. The f32 resblock sum lives in
// the same device-memory scratch. What bounds it: the issue of the mma.sync
// products and of the work around them (the A split, ~1.4 instructions per
// product, and the partial-sum adds), far below the TF32 rate (495 TFLOP/s
// dense, 165 TFLOP/s of f32 work as three products); at C = 64 also the
// weights through an L1 that 224 KB of shared memory leaves at ~28 KB.
//
// Narrow stages, C = 16 and 8 (the last two stages of HiFi-GAN V2 and of any
// generator of 128 initial channels; the wrapper runs C = 1, 2, 4 at C = 8
// on zero-padded channels, which stay exactly 0 through every conv, lrelu
// and residual): the same structure with the tiling cut to the width. f32
// takes all C/8 n-tiles in one pass, and chains of one k-step at C = 8 (two
// at C = 16). bf16 at C = 16 takes one k-step of 16 channels and one pair of
// n-tiles a tap; at C = 8 it takes mma.sync m16n8k8 (bf16) products, with
// ldmatrix.x2 on rows of 16 bytes (8 consecutive rows fill a 128-byte line,
// so no swizzle) and one register of weights a lane and tap, rather than K
// zero-padded to 16, which would double the tensor-core work and the
// buffers for nothing. Each width takes the widest window its two buffers
// leave in shared memory (f32 1664 / 3456 rows, bf16 3456 / 7040 at C = 16
// / 8), so the halo recompute stays under 1.09x. What bounds it: each A
// fragment feeds only C/8 n-tiles, so its load, lrelu and (f32) TF32 split
// weigh more per product than at C = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_util.cuh"
#include "launch_util.cuh"
#include "mma_util.cuh"

namespace {

constexpr int HALO = 64;             // halo rows on each side of a tile
constexpr int PADR = 32;             // zero margin rows around each buffer
constexpr int MAXR = 4;              // resblocks per stage
constexpr int MAXD = 4;              // dilation units per resblock

struct MrfParams {
  int n_res;
  int n_dil;
  int ks[MAXR];
  int halo[MAXR];  // per-resblock halo, chain_halo rounded up to 16
  int dils[MAXR][MAXD];
};

// leaky relu of an f32 value: max(x, 0.1 x)
__device__ __forceinline__ float lrelu_f32(float x) { return fmaxf(x, 0.1f * x); }

// ---- f32: tensor cores, 3xTF32 ---------------------------------------------

constexpr int FNW = 12;        // warps per block: 3 per SM sub-partition
constexpr int FNT = 32 * FNW;  // threads per block
constexpr int FMB = 2;         // 16-row m-tiles per warp tile
constexpr int FNP = 4;         // n-tiles (8 output channels each) per pass, at most

template <int C>
struct FGeo {
  // window rows: the widest that two f32 buffers leave in shared memory
  // below C = 64 (224 KB at C = 64, 208 KB at 32, 216 KB at 16, 220 KB at 8)
  static constexpr int W = C == 64 ? 384 : C == 32 ? 768 : C == 16 ? 1664 : 3456;
  static constexpr int TILE = W - 2 * HALO;      // output rows per block
  static constexpr int ROWS = W + 2 * PADR;      // buffer rows with margins
  static constexpr int KK = C / 8;               // k-steps per tap
  static constexpr int NTN = C / 8;              // n-tiles (output channels / 8)
  static constexpr int NP = NTN < FNP ? NTN : FNP;  // n-tiles per pass
  static constexpr int NN = NP < 2 ? NP : 2;        // n-tiles per group of chains
  static constexpr int KS = KK < 2 ? KK : 2;        // k-steps per chain
  static constexpr int TAP = KK * NTN * 32;      // float4s of packed weights per tap
  static constexpr size_t SMEM = 2 * sizeof(float) * ROWS * C;
  static_assert(TILE % (16 * FMB) == 0, "m-tile groups must not straddle the tile");
  static_assert(SMEM <= 232448, "two f32 buffers must fit a block's shared memory");
  static_assert(NTN % NP == 0 && NP % NN == 0, "whole passes of whole groups");
  static_assert(KK % KS == 0, "whole chains of k-steps");
};

// the f32 buffers' swizzle: rows of 64 (C = 16) and 32 bytes (C = 8) share a
// 128-byte line with 1 and 3 neighbours, so the key is row / 2 and row / 4
template <int C>
using FSw = f32::Swz<C, C == 16 ? 1 : C == 8 ? 2 : 0>;

// One conv over the m-tiles [m_lo, m_hi) of the window, the f32 twin of
// conv_mma below. Each product a.w is lo(a).hi(w) + hi(a).lo(w) + hi(a).hi(w)
// on the tensor cores, accumulated in f32 in that order: hi = tf32(x) and lo =
// tf32(x - hi) for the A fragments (lrelu first, for the unit's first conv),
// while the packed weights hold hi(w) and w - hi(w), whose tf32 is taken here.
template <int C, bool FIRST>
__device__ __forceinline__ void conv_tf32(float* __restrict__ Hs, float* __restrict__ Ts,
                                          const float4* __restrict__ wf,
                                          const float* __restrict__ bias, int k, int d,
                                          int m_lo, int m_hi, int t0, int t_len, bool ends,
                                          bool first_r, bool last_r, float n_res,
                                          float* __restrict__ ab, float* __restrict__ ob) {
  using G = FGeo<C>;
  using Sw = FSw<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const uint32_t src_s = mma::smem_u32(FIRST ? Hs : Ts);
  const int n_groups = (m_hi - m_lo) / FMB;
  for (int grp = warp; grp < n_groups; grp += FNW) {
    const int row0 = (m_lo + grp * FMB) * 16;  // window row of the warp tile
    // 32 output channels a pass (two passes at C = 64, C at C <= 32): up to
    // 32 accumulators
#pragma unroll 1
    for (int pass = 0; pass < G::NTN / G::NP; ++pass) {
      float acc[FMB][G::NP][4];
#pragma unroll
      for (int i = 0; i < FMB; ++i)
#pragma unroll
        for (int n = 0; n < G::NP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

      for (int j = 0; j < k; ++j) {
        // buffer row this lane addresses for ldmatrix (margin rows included)
        const int rs = row0 + (j - half) * d + PADR + (lane & 15);
        const float4* wj = wf + (size_t)j * G::TAP + pass * G::NP * 32 + lane;
        // KS k-steps (two, one at C = 8) an iteration, not unrolled further:
        // with 3 warps per SM sub-partition a thread has at most 168 registers
#pragma unroll 1
        for (int kk = 0; kk < G::KK; kk += G::KS) {
          // the A fragments of the warp tile's m-tiles at the KS k-steps, split
          uint32_t ah[G::KS][FMB][4], al[G::KS][FMB][4];
#pragma unroll
          for (int s = 0; s < G::KS; ++s)
#pragma unroll
            for (int i = 0; i < FMB; ++i) {
              uint32_t a[4];
              mma::ldsm_x4(a, src_s + 4 * Sw::off(rs + 16 * i,
                                                  4 * (2 * (kk + s) + (lane >> 4))));
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = __uint_as_float(a[e]);
                if (FIRST) x = lrelu_f32(x);
                ah[s][i][e] = mma::to_tf32(x);
                al[s][i][e] = mma::to_tf32(x - __uint_as_float(ah[s][i][e]));
              }
            }
          // NN n-tiles (two, one at C = 8) at a time: NN FMB independent
          // chains of 3 KS products, issued product by product
#pragma unroll
          for (int n0 = 0; n0 < G::NP; n0 += G::NN) {
            uint32_t bh[G::KS][G::NN][2], bl[G::KS][G::NN][2];
#pragma unroll
            for (int s = 0; s < G::KS; ++s)
#pragma unroll
              for (int nn = 0; nn < G::NN; ++nn) {
                const float4 w = __ldg(wj + ((kk + s) * G::NTN + n0 + nn) * 32);
                bh[s][nn][0] = __float_as_uint(w.x);
                bh[s][nn][1] = __float_as_uint(w.y);
                bl[s][nn][0] = mma::to_tf32(w.z);
                bl[s][nn][1] = mma::to_tf32(w.w);
              }
            // the tensor cores add into their accumulator with truncation,
            // so a long chain drifts; each chain of KS k-steps starts from 0
            // and joins the sum by a rounded f32 add
            float part[FMB][G::NN][4];
#pragma unroll
            for (int i = 0; i < FMB; ++i)
#pragma unroll
              for (int nn = 0; nn < G::NN; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][nn][e] = 0.f;
#pragma unroll
            for (int s = 0; s < G::KS; ++s) {
#pragma unroll
              for (int i = 0; i < FMB; ++i)
#pragma unroll
                for (int nn = 0; nn < G::NN; ++nn)
                  mma::mma_tf32(part[i][nn], al[s][i], bh[s][nn][0], bh[s][nn][1]);
#pragma unroll
              for (int i = 0; i < FMB; ++i)
#pragma unroll
                for (int nn = 0; nn < G::NN; ++nn)
                  mma::mma_tf32(part[i][nn], ah[s][i], bl[s][nn][0], bl[s][nn][1]);
#pragma unroll
              for (int i = 0; i < FMB; ++i)
#pragma unroll
                for (int nn = 0; nn < G::NN; ++nn)
                  mma::mma_tf32(part[i][nn], ah[s][i], bh[s][nn][0], bh[s][nn][1]);
            }
#pragma unroll
            for (int i = 0; i < FMB; ++i)
#pragma unroll
              for (int nn = 0; nn < G::NN; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][n0 + nn][e] += part[i][nn][e];
          }
        }
      }

      // epilogue: bias, zero outside [0, T), then lrelu(t) -> Ts, or h += t
      // -> Hs (and the resblock sum, or the mean on the last resblock); a
      // pass touches only its own columns, which the other pass never reads
#pragma unroll
      for (int i = 0; i < FMB; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row0 + 16 * i + g + 8 * hr;
          const int pos = t0 + row;
          const bool inside = pos >= 0 && pos < t_len;
          const bool out_row = ends && row >= HALO && row < HALO + G::TILE && pos < t_len;
#pragma unroll
          for (int n = 0; n < G::NP; ++n) {
            const int col = (pass * G::NP + n) * 8 + 2 * tq;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
            const float v0 = inside ? acc[i][n][2 * hr] + bb.x : 0.f;
            const float v1 = inside ? acc[i][n][2 * hr + 1] + bb.y : 0.f;
            const int off = Sw::off(row + PADR, col);
            if (FIRST) {
              *reinterpret_cast<float2*>(Ts + off) = make_float2(lrelu_f32(v0), lrelu_f32(v1));
            } else {
              float2* hp = reinterpret_cast<float2*>(Hs + off);
              const float2 h = *hp;
              const float h0 = h.x + v0, h1 = h.y + v1;
              *hp = make_float2(h0, h1);
              if (out_row) {
                const size_t e = (size_t)pos * C + col;
                float2 s = make_float2(0.f, 0.f);
                if (!first_r) s = *reinterpret_cast<const float2*>(ab + e);
                s.x += h0;
                s.y += h1;
                if (last_r)
                  *reinterpret_cast<float2*>(ob + e) = make_float2(s.x / n_res, s.y / n_res);
                else
                  *reinterpret_cast<float2*>(ab + e) = s;
              }
            }
          }
        }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(FNT, 1)
mrf_kernel(const float* __restrict__ x, float* __restrict__ out, const float4* __restrict__ wf,
           const float* __restrict__ bias, float* __restrict__ accbuf, int t_len, MrfParams p) {
  using G = FGeo<C>;
  using Sw = FSw<C>;
  constexpr int CH = C / 4;  // 16-byte chunks per row
  extern __shared__ __align__(128) float fsm[];
  float* Hs = fsm;               // h
  float* Ts = Hs + G::ROWS * C;  // lrelu(t)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TILE - HALO;  // sequence position of window row 0
  const float* xb = x + (size_t)b * t_len * C;
  float* ab = accbuf + (size_t)b * t_len * C;
  float* ob = out + (size_t)b * t_len * C;

  // zero both buffers: the margins stay zero, rows a resblock does not
  // compute stay finite (they only feed rows outside its halo)
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < (int)(G::SMEM / 16); i += FNT) reinterpret_cast<float4*>(fsm)[i] = z;
  __syncthreads();

  const float4* wp = wf;
  const float* bp = bias;
  const float n_res = (float)p.n_res;
  for (int r = 0; r < p.n_res; ++r) {
    const int k = p.ks[r];
    const int m_lo = (HALO - p.halo[r]) / 16;
    const int m_hi = (HALO + G::TILE + p.halo[r]) / 16;
    for (int i = tid; i < G::W * CH; i += FNT) {
      const int row = i / CH, ch = i % CH, pos = t0 + row;
      float4 v = z;
      if (pos >= 0 && pos < t_len)
        v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)pos * C + ch * 4));
      *reinterpret_cast<float4*>(Hs + Sw::off(row + PADR, ch * 4)) = v;
    }
    __syncthreads();
    for (int u = 0; u < p.n_dil; ++u) {
      const bool ends = u == p.n_dil - 1;
      conv_tf32<C, true>(Hs, Ts, wp, bp, k, p.dils[r][u], m_lo, m_hi, t0, t_len, false,
                         false, false, n_res, ab, ob);
      wp += (size_t)k * G::TAP;
      bp += C;
      __syncthreads();
      conv_tf32<C, false>(Hs, Ts, wp, bp, k, 1, m_lo, m_hi, t0, t_len, ends, r == 0,
                          r == p.n_res - 1, n_res, ab, ob);
      wp += (size_t)k * G::TAP;
      bp += C;
      __syncthreads();
    }
  }
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int BNW = 12;        // warps per block
constexpr int BNT = 32 * BNW;  // threads per block
constexpr int MB = 2;          // 16-row m-tiles per warp tile

template <int C>
struct TGeo {
  // window rows: the widest that two bf16 buffers leave in shared memory
  // below C = 64 (208 KB at C = 64, 200 KB at 32, 220 KB at 16, 222 KB at 8)
  static constexpr int W = C == 64 ? 768 : C == 32 ? 1536 : C == 16 ? 3456 : 7040;
  static constexpr int TILE = W - 2 * HALO;       // output rows per block
  static constexpr int ROWS = W + 2 * PADR;       // buffer rows with margins
  // C = 8 takes m16n8k8 products (one k-step of 8 channels, one n-tile, one
  // 32-bit register of two bf16 a lane and tap), the wider C m16n8k16
  static constexpr bool K8 = C == 8;
  static constexpr int KK = K8 ? 1 : C / 16;      // k-steps per tap
  static constexpr int NTN = C / 8;               // n-tiles (output channels / 8)
  static constexpr int NTP = C / 16;              // n-tile pairs (16 bytes a lane)
  static constexpr int TAP = K8 ? 8 : KK * NTP * 32;  // uint4s of packed weights per tap
  static constexpr size_t SMEM = 2 * sizeof(__nv_bfloat16) * ROWS * C;
  static_assert(TILE % (16 * MB) == 0, "m-tile groups must not straddle the tile");
  static_assert(SMEM <= 232448, "two bf16 buffers must fit a block's shared memory");
};

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// leaky relu of a bf16 value, as the unfused path rounds it: max(x, bf16(0.1 x))
__device__ __forceinline__ float lrelu_bf16(float x) { return fmaxf(x, rnd_bf16(0.1f * x)); }
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t u) {
  const float2 f = mma::unpack_bf16(u);
  return mma::pack_bf16(lrelu_bf16(f.x), lrelu_bf16(f.y));
}

// One conv over the m-tiles [m_lo, m_hi) of the window. FIRST: the unit's
// first conv, reading h (lrelu applied on load) and writing lrelu(t) to Ts;
// else the second, reading Ts and adding its output to h in Hs. On the
// unit that ends a resblock (`ends`), the second conv also adds h to the f32
// resblock sum at the tile's rows, or writes the mean on the last resblock.
template <int C, bool FIRST>
__device__ __forceinline__ void conv_mma(__nv_bfloat16* __restrict__ Hs,
                                         __nv_bfloat16* __restrict__ Ts,
                                         const uint4* __restrict__ wf,
                                         const float* __restrict__ bias, int k, int d,
                                         int m_lo, int m_hi, int t0, int t_len, bool ends,
                                         bool first_r, bool last_r, float n_res,
                                         float* __restrict__ ab, __nv_bfloat16* __restrict__ ob) {
  using G = TGeo<C>;
  using Sw = mma::Swizzle<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const __nv_bfloat16* src = FIRST ? Hs : Ts;
  const uint32_t src_s = mma::smem_u32(src);
  const int n_groups = (m_hi - m_lo) / MB;
  for (int grp = warp; grp < n_groups; grp += BNW) {
    const int row0 = (m_lo + grp * MB) * 16;  // window row of the warp tile
    float acc[MB][G::NTN][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int n = 0; n < G::NTN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

    for (int j = 0; j < k; ++j) {
      // buffer row this lane addresses for ldmatrix (margin rows included)
      const int rs = row0 + (j - half) * d + PADR + (lane & 15);
      if constexpr (G::K8) {
        // rows of 8 channels: ldmatrix.x2 of rows rs .. rs + 15 is the A
        // fragment, one register of the tap's weights the B fragment
        const uint32_t b0 =
            __ldg(reinterpret_cast<const uint32_t*>(wf + (size_t)j * G::TAP) + lane);
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          uint32_t a[2];
          mma::ldsm_x2(a, src_s + 2 * Sw::off(rs + 16 * i, 0));
          if (FIRST) {
            a[0] = lrelu_bf16x2(a[0]);
            a[1] = lrelu_bf16x2(a[1]);
          }
          mma::mma_bf16_k8(acc[i][0], a, b0);
        }
      } else {
        const uint4* wj = wf + (size_t)j * G::TAP + lane;
#pragma unroll
        for (int kk = 0; kk < G::KK; ++kk) {
          uint32_t bfr[G::NTN][2];
#pragma unroll
          for (int np = 0; np < G::NTP; ++np) {
            const uint4 w = __ldg(wj + (kk * G::NTP + np) * 32);
            bfr[2 * np][0] = w.x;
            bfr[2 * np][1] = w.y;
            bfr[2 * np + 1][0] = w.z;
            bfr[2 * np + 1][1] = w.w;
          }
#pragma unroll
          for (int i = 0; i < MB; ++i) {
            uint32_t a[4];
            mma::ldsm_x4(a, src_s + 2 * Sw::off(rs + 16 * i, 2 * kk + (lane >> 4)));
            if (FIRST) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = lrelu_bf16x2(a[e]);
            }
#pragma unroll
            for (int n = 0; n < G::NTN; ++n)
              mma::mma_bf16(acc[i][n], a, bfr[n][0], bfr[n][1]);
          }
        }
      }
    }

    // epilogue: bias in f32, round to bf16, zero outside [0, T), then
    // lrelu(t) -> Ts, or h = bf16(h + t) -> Hs (and the resblock sum)
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 16 * i + g + 8 * hr;
        const int pos = t0 + row;
        const bool inside = pos >= 0 && pos < t_len;
        const bool out_row = ends && row >= HALO && row < HALO + G::TILE && pos < t_len;
#pragma unroll
        for (int n = 0; n < G::NTN; ++n) {
          const int col = n * 8 + 2 * tq;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
          const float v0 = inside ? rnd_bf16(acc[i][n][2 * hr] + bb.x) : 0.f;
          const float v1 = inside ? rnd_bf16(acc[i][n][2 * hr + 1] + bb.y) : 0.f;
          const int off = Sw::off(row + PADR, n) + 2 * tq;
          if (FIRST) {
            *reinterpret_cast<uint32_t*>(Ts + off) = mma::pack_bf16(lrelu_bf16(v0), lrelu_bf16(v1));
          } else {
            uint32_t* hp = reinterpret_cast<uint32_t*>(Hs + off);
            const float2 h = mma::unpack_bf16(*hp);
            const float h0 = rnd_bf16(h.x + v0), h1 = rnd_bf16(h.y + v1);
            *hp = mma::pack_bf16(h0, h1);
            if (out_row) {
              const size_t e = (size_t)pos * C + col;
              float2 s = make_float2(0.f, 0.f);
              if (!first_r) s = *reinterpret_cast<const float2*>(ab + e);
              s.x += h0;
              s.y += h1;
              if (last_r)
                *reinterpret_cast<uint32_t*>(ob + e) = mma::pack_bf16(s.x / n_res, s.y / n_res);
              else
                *reinterpret_cast<float2*>(ab + e) = s;
            }
          }
        }
      }
  }
}

template <int C>
__global__ void __launch_bounds__(BNT, 1)
mrf_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                const uint4* __restrict__ wf, const float* __restrict__ bias,
                float* __restrict__ accbuf, int t_len, MrfParams p) {
  using G = TGeo<C>;
  using Sw = mma::Swizzle<C>;
  constexpr int CH = C / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char msm[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(msm);  // h
  __nv_bfloat16* Ts = Hs + G::ROWS * C;                         // lrelu(t)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TILE - HALO;  // sequence position of window row 0
  const __nv_bfloat16* xb = x + (size_t)b * t_len * C;
  float* ab = accbuf + (size_t)b * t_len * C;
  __nv_bfloat16* ob = out + (size_t)b * t_len * C;

  // zero both buffers: the margins stay zero, rows a resblock does not
  // compute stay finite (they only feed rows outside its halo)
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (int)(G::SMEM / 16); i += BNT) reinterpret_cast<uint4*>(msm)[i] = z;
  __syncthreads();

  const uint4* wp = wf;
  const float* bp = bias;
  const float n_res = (float)p.n_res;
  for (int r = 0; r < p.n_res; ++r) {
    const int k = p.ks[r];
    const int m_lo = (HALO - p.halo[r]) / 16;
    const int m_hi = (HALO + G::TILE + p.halo[r]) / 16;
    for (int i = tid; i < G::W * CH; i += BNT) {
      const int row = i / CH, ch = i % CH, pos = t0 + row;
      uint4 v = z;
      if (pos >= 0 && pos < t_len)
        v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)pos * C + ch * 8));
      *reinterpret_cast<uint4*>(Hs + Sw::off(row + PADR, ch)) = v;
    }
    __syncthreads();
    for (int u = 0; u < p.n_dil; ++u) {
      const bool ends = u == p.n_dil - 1;
      conv_mma<C, true>(Hs, Ts, wp, bp, k, p.dils[r][u], m_lo, m_hi, t0, t_len, false,
                        false, false, n_res, ab, ob);
      wp += (size_t)k * G::TAP;
      bp += C;
      __syncthreads();
      conv_mma<C, false>(Hs, Ts, wp, bp, k, 1, m_lo, m_hi, t0, t_len, ends, r == 0,
                         r == p.n_res - 1, n_res, ab, ob);
      wp += (size_t)k * G::TAP;
      bp += C;
      __syncthreads();
    }
  }
}

template <int C>
int launch_f32(const void* x, void* out, const void* w, const float* bias, float* acc, int b,
               int t_len, const MrfParams& p, int device, cudaStream_t stream) {
  using G = FGeo<C>;
  static std::atomic<uint64_t> attrs_set{0};
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  if (int e = once::set_attributes(attrs_set, device, mrf_kernel<C>, G::SMEM, false))
    return e;
  const dim3 grid((t_len + G::TILE - 1) / G::TILE, b);
  mrf_kernel<C><<<grid, FNT, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float4*>(w),
      bias, acc, t_len, p);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bf16(const void* x, void* out, const void* w, const float* bias, float* acc,
                int b, int t_len, const MrfParams& p, int device, cudaStream_t stream) {
  using G = TGeo<C>;
  static std::atomic<uint64_t> attrs_set{0};
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  if (int e = once::set_attributes(attrs_set, device, mrf_bf16_kernel<C>, G::SMEM, false))
    return e;
  const dim3 grid((t_len + G::TILE - 1) / G::TILE, b);
  mrf_bf16_kernel<C><<<grid, BNT, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const uint4*>(w), bias, acc, t_len, p);
  return (int)cudaGetLastError();
}

template <int C>
int launch(int dtype, const void* x, void* out, const void* w, const float* bias, float* acc,
           int b, int t_len, const MrfParams& p, int device, cudaStream_t s) {
  if (dtype == 0) return launch_f32<C>(x, out, w, bias, acc, b, t_len, p, device, s);
  if (dtype == 1) return launch_bf16<C>(x, out, w, bias, acc, b, t_len, p, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Weights `w`, one conv after another in the order (resblock, unit, conv1 then
// conv2), each tap in the order of the mma fragments. dtype 0 (f32): (k, C/8
// k-steps, C/8 n-tiles, 32 lanes, 4) f32, lane l of (kk, n) holding
// hi(W[j][8 kk + l % 4][8 n + l / 4]), hi(W[j][8 kk + l % 4 + 4][8 n + l / 4])
// and the two remainders W - hi(W), hi = tf32 (to nearest, ties away).
// dtype 1 (bf16): (k, C/16, C/16, 32 lanes, 8), element e of lane l holding
// W[j][16 kk + 2 (l % 4) + (e % 2) + 8 ((e % 4) / 2)][8 (2 np + e / 4) + l / 4];
// at C = 8, (k, 32 lanes, 2), element e of lane l holding W[j][2 (l % 4) + e][l / 4].
// C is 8, 16, 32 or 64 (the wrapper runs C = 1, 2, 4 at 8 on zero-padded channels).
// `bias`: f32 (n_conv, C). `acc`: f32 (B, T, C) scratch for the resblock sum.
// ks: (n_res,), dils: (n_res * n_dil,) row-major. dtype: 0 = f32, 1 = bf16;
// device: the index of the current device, which the stream belongs to.
// Returns a cudaError_t code (0 = launched).
extern "C" int masg_fused_mrf(const void* x, void* out, const void* w, const float* bias,
                              float* acc, int b, int t_len, int c, int dtype, int n_res,
                              int n_dil, const int* ks, const int* dils, int device,
                              void* stream) {
  if (b <= 0 || t_len <= 0) return 0;
  if (n_res < 1 || n_res > MAXR || n_dil < 1 || n_dil > MAXD)
    return (int)cudaErrorInvalidValue;
  MrfParams p;
  p.n_res = n_res;
  p.n_dil = n_dil;
  for (int r = 0; r < n_res; ++r) {
    const int k = ks[r], half = (k - 1) / 2;
    if (k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
    p.ks[r] = k;
    int radius = 0;
    for (int u = 0; u < n_dil; ++u) {
      const int d = dils[r * n_dil + u];
      if (d < 1 || half * d > PADR) return (int)cudaErrorInvalidValue;
      p.dils[r][u] = d;
      radius += half * d + half;
    }
    if (radius > HALO) return (int)cudaErrorInvalidValue;
    p.halo[r] = (radius + 15) / 16 * 16;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8: return launch<8>(dtype, x, out, w, bias, acc, b, t_len, p, device, s);
    case 16: return launch<16>(dtype, x, out, w, bias, acc, b, t_len, p, device, s);
    case 32: return launch<32>(dtype, x, out, w, bias, acc, b, t_len, p, device, s);
    case 64: return launch<64>(dtype, x, out, w, bias, acc, b, t_len, p, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
