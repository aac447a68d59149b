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
// Products and sums run in f32.
//
// Determinism: every output row is owned by exactly one block (K2 by its query
// tile, K3 by its key tile), so there are no atomics and the gradient is the
// same bit for bit from run to run.
//
// What bounds them on the H100: at the FastSpeech2 shapes (B*H = 32, T <= 1000,
// Dh = 128) the work is 6 (K2) and 8 (K3) * T^2 * Dh flops per head over
// ~8 * T * Dh * bytes of I/O: tiny, and as with K1 the ceiling that matters is
// the 67 TFLOP/s f32 rate of the CUDA cores these kernels run on (no tensor
// cores yet), or launch latency at T = 128. The design keeps every (T, T)
// intermediate out of device memory and does only the work the lengths need:
// K2 runs key tiles up to ceil(len/32) only, K3 query tiles up to
// ceil(len/32) only and skips key tiles at or past len outright (they write
// zeros). wgmma + TMA staging is the later step, as for K1.
//
// Design (both kernels): 256 threads, 4 threads per resident row, the scheme
// of K1. K2: one block per (b*h, 64-row query tile); the query tile
// (pre-scaled by 1/sqrt(Dh)) and its do rows stay in shared memory, 32-row K
// and V tiles are staged one at a time; each thread computes 8 scores and 8
// do.v products, the 64 x 32 ds tile goes through shared memory and each
// thread accumulates Dh/4 columns of dQ in registers. K3: one block per (b*h,
// 64-row key tile); the K and V tiles stay in shared memory, 32-row q / do
// tiles (with their LSE and delta) are staged; p and ds go through shared
// memory and each thread accumulates Dh/4 columns of dK and dV. Rows are
// padded by one float, so no product has bank conflicts. Shared memory at
// Dh = 128: ~107 KB (K2) and ~116 KB (K3), dynamic, opted in above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;   // resident rows per block (query rows in K2, key rows in K3)
constexpr int BS = 32;   // rows per staged tile
constexpr int NT = 256;  // threads per block: 4 per resident row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T, int DH, int N>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0,
                                      int t_len, float mul) {
  for (int i = threadIdx.x; i < N * DH; i += NT) {
    const int rr = i / DH, d = i % DH, row = r0 + rr;
    dst[rr * (DH + 1) + d] = row < t_len ? to_f(src[(size_t)row * DH + d]) * mul : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lens, T* __restrict__ dq, int heads,
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

  stage<T, DH, BR>(Qs, q + base, q0, t_len, scale);
  stage<T, DH, BR>(dOs, dout + base, q0, t_len, 1.f);
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
    stage<T, DH, BS>(Ks, k + base, k0, t_len, 1.f);
    stage<T, DH, BS>(Vs, v + base, k0, t_len, 1.f);
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
    T* out = dq + base + (size_t)row * DH + q4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[4 * j] = from_f<T>(scale * acc[j]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lens, T* __restrict__ dk,
                 T* __restrict__ dv, int heads, int t_len, float scale) {
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
    stage<T, DH, BR>(Ks, k + base, k0, t_len, scale);  // holds scale * k
    stage<T, DH, BR>(Vs, v + base, k0, t_len, 1.f);
  }
  for (int qb = 0; qb < n_qb; ++qb) {
    __syncthreads();  // the previous tile's readers are done; K and V are visible
    const int r0 = qb * BS;
    stage<T, DH, BS>(Qs, q + base, r0, t_len, 1.f);
    stage<T, DH, BS>(dOs, dout + base, r0, t_len, 1.f);
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
    T* ok = dk + base + (size_t)key * DH + q4;
    T* ov = dv + base + (size_t)key * DH + q4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      ok[4 * j] = from_f<T>(scale * gk[j]);
      ov[4 * j] = from_f<T>(gv[j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lens;
  void *out0, *out1;  // dq; or dk, dv
  int bh, heads, t_len;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.t_len + BR - 1) / BR, a.bh);
  flash_dq_kernel<T, DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.lens, static_cast<T*>(a.out0),
      a.heads, a.t_len, rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.t_len + BR - 1) / BR, a.bh);
  flash_dkv_kernel<T, DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.lens, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.heads, a.t_len, rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <bool DQ, typename T>
int dispatch_dh(int dh, const Args& a) {
  switch (dh) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(const Args& a, int dh, int dtype) {
  if (a.bh <= 0 || a.t_len <= 0) return 0;
  if (a.heads <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_dh<DQ, float>(dh, a);
  if (dtype == 1) return dispatch_dh<DQ, __nv_bfloat16>(dh, a);
  return (int)cudaErrorInvalidValue;
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
