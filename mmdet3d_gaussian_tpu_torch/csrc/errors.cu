// Error text for the status codes the launchers return.
#include "common.cuh"

KERNEL_API const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
