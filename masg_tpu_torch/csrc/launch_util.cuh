// Launch helpers shared by the f32 launchers (K1 in flash_fwd.cu, K2 in
// flash_bwd.cu, K4 in fused_mrf.cu): a kernel's function attributes are set
// once per process and device, and the SM count is read once per device, so a
// launch makes no runtime call besides the launch itself and
// cudaGetLastError. The device index comes from the caller (the wrapper runs
// under `torch.cuda.device(x.device)`), so no cudaGetDevice either.

#pragma once

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace once {

constexpr int MAX_DEVICES = 64;

// Sets `kernel`'s dynamic shared-memory limit to `smem` bytes (and, with
// `max_carveout`, asks for the largest shared-memory carveout) on `device`
// the first time it is called with `done` for that device. `done` is a
// static of the calling launcher, one bit per device; setting an attribute
// twice (two threads racing) is harmless.
template <typename Kernel>
int set_attributes(std::atomic<uint64_t>& done, int device, Kernel kernel, size_t smem,
                   bool max_carveout) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const uint64_t bit = uint64_t(1) << device;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && max_carveout)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

// The number of SMs of `device`, read from the runtime once per device.
inline int sm_count(int device, int* sms) {
  static std::atomic<int> cache[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int n = cache[device].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    cache[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

}  // namespace once
