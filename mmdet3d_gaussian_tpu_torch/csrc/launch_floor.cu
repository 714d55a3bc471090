// A kernel that does nothing: its device time, launched the way every
// kernel of the port is, is the floor that chip_smoke.py and k1_k3_times.py
// print beside the kernels whose bytes take less than a launch.
#include "common.cuh"

namespace {
__global__ void empty_kernel() {}
}  // namespace

KERNEL_API int empty_launch(int device, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  empty_kernel<<<1, 32, 0, stream>>>();
  return end_launch();
}
