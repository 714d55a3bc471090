// Shared helpers for the port's kernels.  Every launcher is a plain C entry
// point: device pointers, sizes, the device index and the stream come in as
// plain values, and the launcher returns cudaGetLastError() so the Python
// wrapper can raise on a launch the driver refused.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

#define KERNEL_API extern "C" __attribute__((visibility("default")))

// Select the caller's device (the ctypes library carries its own runtime
// state, which does not follow torch's current device), then clear any
// stale error so the status read after the launch is this launch's.
static inline int begin_launch(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGetLastError();
  return 0;
}

static inline int end_launch() {
  return static_cast<int>(cudaGetLastError());
}

static inline unsigned int blocks_for(long long work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}

// Blocks of one kernel, at `threads` a block and `smem` bytes of dynamic
// shared memory, that stay resident on the whole card at once: the grid of
// a persistent kernel.  One cache per kernel (a static of its launcher),
// per device; 0 when the runtime cannot say.
struct ResidentCache {
  static constexpr int kMaxDevices = 64;
  std::atomic<int> blocks[kMaxDevices];

  template <typename K>
  int get(K kernel, int device, int threads, int smem = 0) {
    const bool cached = device >= 0 && device < kMaxDevices;
    if (cached) {
      const int v = blocks[device].load(std::memory_order_relaxed);
      if (v > 0) return v;
    }
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem)
            != cudaSuccess)
      return 0;
    const int v = sms * (per_sm > 0 ? per_sm : 1);
    if (cached) blocks[device].store(v, std::memory_order_relaxed);
    return v;
  }
};
