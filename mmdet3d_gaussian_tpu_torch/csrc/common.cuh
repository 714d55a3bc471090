// Shared helpers for the port's kernels.  Every launcher is a plain C entry
// point: device pointers, sizes, the device index and the stream come in as
// plain values, and the launcher returns cudaGetLastError() so the Python
// wrapper can raise on a launch the driver refused.
#pragma once

#include <cuda_runtime.h>

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
