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
// never by device memory.
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
// f32 (mrf_kernel): the first, SIMT kernel, kept so the f32 path meets the 2e-5
// bar (TF32 would not): a 16,384 / C-row window with a fixed 64-row halo, f32
// FMAs on the CUDA cores, 2x recompute at C = 64. Queued: the per-resblock
// halo on the CUDA cores, or a 3xTF32 split that meets 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

constexpr int NT = 512;              // threads per block (f32)
constexpr int HALO = 64;             // halo rows on each side of a tile
constexpr int PADR = 32;             // zero margin rows around each buffer
constexpr int WINDOW_ELEMS = 16384;  // window rows * channels (f32)
constexpr int MAXR = 4;              // resblocks per stage
constexpr int MAXD = 4;              // dilation units per resblock

struct MrfParams {
  int n_res;
  int n_dil;
  int ks[MAXR];
  int halo[MAXR];  // per-resblock halo, chain_halo rounded up to 16 (bf16)
  int dils[MAXR][MAXD];
};

template <int C>
struct Geo {
  static constexpr int W = WINDOW_ELEMS / C;  // window rows
  static constexpr int TILE = W - 2 * HALO;   // output rows per block
  static constexpr int STRIDE = NT / C;       // rows between a thread's rows
  static constexpr int RPT = W / STRIDE;      // rows per thread
  static constexpr int BUF = (W + 2 * PADR) * C;
  static constexpr size_t SMEM = sizeof(float) * (2 * BUF + W * C);
};

// leaky relu of an f32 value: max(x, 0.1 x)
__device__ __forceinline__ float lrelu_f32(float x) { return fmaxf(x, 0.1f * x); }

// c[i] = sum_j sum_ci src[row_i + (j - half) * d][ci] * w[j][ci][co]
template <int C>
__device__ __forceinline__ void conv(const float* __restrict__ src,
                                     const float* __restrict__ w, int k, int d,
                                     int co, int rg, float (&c)[Geo<C>::RPT]) {
  constexpr int RPT = Geo<C>::RPT;
  constexpr int STRIDE = Geo<C>::STRIDE;
#pragma unroll
  for (int i = 0; i < RPT; ++i) c[i] = 0.f;
  const int half = (k - 1) / 2;
  for (int j = 0; j < k; ++j) {
    const float* s = src + (rg + (j - half) * d) * C;
    const float* wj = w + j * C * C + co;
#pragma unroll 2
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = __ldg(wj + (ci + 0) * C);
      const float w1 = __ldg(wj + (ci + 1) * C);
      const float w2 = __ldg(wj + (ci + 2) * C);
      const float w3 = __ldg(wj + (ci + 3) * C);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(s + i * STRIDE * C + ci);
        float a = c[i];
        a = fmaf(v.x, w0, a);
        a = fmaf(v.y, w1, a);
        a = fmaf(v.z, w2, a);
        a = fmaf(v.w, w3, a);
        c[i] = a;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
mrf_kernel(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ wts, const float* __restrict__ bias, int t_len,
           MrfParams p) {
  using G = Geo<C>;
  constexpr int RPT = G::RPT;
  constexpr int STRIDE = G::STRIDE;
  extern __shared__ __align__(16) float smem[];
  float* L = smem + PADR * C;            // lrelu(h), rows [-PADR, W + PADR)
  float* Tb = smem + G::BUF + PADR * C;  // lrelu(t)
  float* ACC = smem + 2 * G::BUF;        // f32 sum of the resblock outputs

  const int tid = threadIdx.x;
  const int co = tid % C;
  const int rg = tid / C;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TILE - HALO;  // sequence position of row 0
  const float* xb = x + (size_t)b * t_len * C;

  for (int i = tid; i < PADR * C; i += NT) {
    L[-PADR * C + i] = 0.f;
    L[G::W * C + i] = 0.f;
    Tb[-PADR * C + i] = 0.f;
    Tb[G::W * C + i] = 0.f;
  }

  float h[RPT], c[RPT];
  const float* wp = wts;
  const float* bp = bias;
  for (int r = 0; r < p.n_res; ++r) {
    const int k = p.ks[r];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg + STRIDE * i, pos = t0 + row;
      const float xv = (pos >= 0 && pos < t_len) ? xb[(size_t)pos * C + co] : 0.f;
      h[i] = xv;
      L[row * C + co] = lrelu_f32(xv);
    }
    __syncthreads();
    for (int u = 0; u < p.n_dil; ++u) {
      conv<C>(L, wp, k, p.dils[r][u], co, rg, c);
      wp += k * C * C;
      const float b1 = __ldg(bp + co);
      bp += C;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = rg + STRIDE * i, pos = t0 + row;
        const float tv = (pos >= 0 && pos < t_len) ? c[i] + b1 : 0.f;
        Tb[row * C + co] = lrelu_f32(tv);
      }
      __syncthreads();
      conv<C>(Tb, wp, k, 1, co, rg, c);
      wp += k * C * C;
      const float b2 = __ldg(bp + co);
      bp += C;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = rg + STRIDE * i, pos = t0 + row;
        const float tv = (pos >= 0 && pos < t_len) ? c[i] + b2 : 0.f;
        h[i] = h[i] + tv;
        L[row * C + co] = lrelu_f32(h[i]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg + STRIDE * i;
      ACC[row * C + co] = (r == 0 ? 0.f : ACC[row * C + co]) + h[i];
    }
  }

  float* ob = out + (size_t)b * t_len * C;
  const float n = (float)p.n_res;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = rg + STRIDE * i, pos = t0 + row;
    if (row >= HALO && row < HALO + G::TILE && pos < t_len)
      ob[(size_t)pos * C + co] = ACC[row * C + co] / n;
  }
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int BNW = 12;        // warps per block
constexpr int BNT = 32 * BNW;  // threads per block
constexpr int MB = 2;          // 16-row m-tiles per warp tile

template <int C>
struct TGeo {
  static constexpr int W = C == 64 ? 768 : 1536;  // window rows
  static constexpr int TILE = W - 2 * HALO;       // output rows per block
  static constexpr int ROWS = W + 2 * PADR;       // buffer rows with margins
  static constexpr int KK = C / 16;               // k-steps per tap
  static constexpr int NTN = C / 8;               // n-tiles (output channels / 8)
  static constexpr int NTP = C / 16;              // n-tile pairs (16 bytes a lane)
  static constexpr int TAP = KK * NTP * 32;       // uint4s of packed weights per tap
  static constexpr size_t SMEM = 2 * sizeof(__nv_bfloat16) * ROWS * C;
  static_assert(TILE % (16 * MB) == 0, "m-tile groups must not straddle the tile");
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
          for (int n = 0; n < G::NTN; ++n) mma::mma_bf16(acc[i][n], a, bfr[n][0], bfr[n][1]);
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
int launch_f32(const void* x, void* out, const void* w, const float* bias, int b, int t_len,
               const MrfParams& p, cudaStream_t stream) {
  using G = Geo<C>;
  cudaError_t e = cudaFuncSetAttribute(
      mrf_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + G::TILE - 1) / G::TILE, b);
  mrf_kernel<C><<<grid, NT, G::SMEM, stream>>>(static_cast<const float*>(x),
                                              static_cast<float*>(out),
                                              static_cast<const float*>(w), bias, t_len, p);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bf16(const void* x, void* out, const void* w, const float* bias, float* acc,
                int b, int t_len, const MrfParams& p, cudaStream_t stream) {
  using G = TGeo<C>;
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mrf_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + G::TILE - 1) / G::TILE, b);
  mrf_bf16_kernel<C><<<grid, BNT, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const uint4*>(w), bias, acc, t_len, p);
  return (int)cudaGetLastError();
}

template <int C>
int launch(int dtype, const void* x, void* out, const void* w, const float* bias, float* acc,
           int b, int t_len, const MrfParams& p, cudaStream_t s) {
  if (dtype == 0) return launch_f32<C>(x, out, w, bias, b, t_len, p, s);
  if (dtype == 1) return launch_bf16<C>(x, out, w, bias, acc, b, t_len, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Weights `w`, one conv after another in the order (resblock, unit, conv1 then
// conv2): f32 (k, C_in, C_out) for dtype 0; for dtype 1 bf16 in the mma
// fragment order (k, C/16, C/16, 32 lanes, 8), element e of lane l holding
// W[j][16 kk + 2 (l % 4) + (e % 2) + 8 ((e % 4) / 2)][8 (2 np + e / 4) + l / 4].
// `bias`: f32 (n_conv, C). `acc`: f32 (B, T, C) scratch for the bf16 kernel
// (may be null for f32). ks: (n_res,), dils: (n_res * n_dil,) row-major.
// dtype: 0 = f32, 1 = bf16. Returns a cudaError_t code (0 = launched).
extern "C" int masg_fused_mrf(const void* x, void* out, const void* w, const float* bias,
                              float* acc, int b, int t_len, int c, int dtype, int n_res,
                              int n_dil, const int* ks, const int* dils, void* stream) {
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
    case 32: return launch<32>(dtype, x, out, w, bias, acc, b, t_len, p, s);
    case 64: return launch<64>(dtype, x, out, w, bias, acc, b, t_len, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
