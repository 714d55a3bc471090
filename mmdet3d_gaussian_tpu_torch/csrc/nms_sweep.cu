// Greedy score-order NMS suppression sweep over P independent problems.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/nms_kernel.py::nms_sweep_pallas
// (kernel _nms_sweep_kernel).  Input: a (P, K, K) f32 IoU matrix whose rows
// and columns are in descending score order, a (P, K) valid mask and the
// threshold.  Output: the (P, K) keep mask.  keep starts as valid; step i
// (i = 0 .. K-1, in order) clears keep[j] for every j > i with
// iou[i, j] > thr, if keep[i] still holds.  An invalid or suppressed row
// never suppresses.
//
// Bound on an H100: neither bytes (50 MB of IoU for 12 problems of 1,024,
// ~15 us of HBM time) nor operations, but the K dependent steps: step i
// needs keep[i] after every earlier step.  One block per problem keeps the
// keep mask in shared memory; thread j owns column j.  Rows are staged into
// shared memory as 1-byte "iou > thr" flags, kRows rows at a time with
// coalesced loads, so each of the K steps is a shared-memory read and one
// block barrier instead of a device-memory round trip.
#include "common.cuh"

namespace {

constexpr int kSmemBytes = 48 * 1024;  // static-launch shared memory limit

__global__ void nms_sweep_kernel(const float* __restrict__ iou,
                                 const unsigned char* __restrict__ valid,
                                 unsigned char* __restrict__ keep_out, int K,
                                 int rows_per_stage, float thr) {
  extern __shared__ unsigned char smem[];
  unsigned char* keep = smem;
  unsigned char* sup = smem + K;
  const long long p = blockIdx.x;
  const float* m = iou + p * K * (long long)K;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    keep[j] = valid[p * K + j] ? 1 : 0;

  for (int i0 = 0; i0 < K; i0 += rows_per_stage) {
    int rows = min(rows_per_stage, K - i0);
    __syncthreads();  // previous stage's flags fully consumed
    const float* src = m + (long long)i0 * K;
    for (int e = threadIdx.x; e < rows * K; e += blockDim.x)
      sup[e] = src[e] > thr ? 1 : 0;
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      int i = i0 + r;
      if (keep[i]) {
        const unsigned char* row = sup + (long long)r * K;
        for (int j = threadIdx.x; j < K; j += blockDim.x)
          if (j > i && row[j]) keep[j] = 0;
      }
      __syncthreads();  // keep[i + 1] final before the next step reads it
    }
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    keep_out[p * K + j] = keep[j];
}

}  // namespace

KERNEL_API int nms_sweep_launch(int device, const float* iou,
                                const unsigned char* valid,
                                unsigned char* keep, int P, int K, float thr,
                                cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if (P == 0 || K == 0) return 0;
  int rows = (kSmemBytes - K) / K;  // keep mask + one staged row at least
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 32) rows = 32;
  int threads = K < 1024 ? ((K + 31) / 32) * 32 : 1024;
  size_t smem = (size_t)K + (size_t)rows * K;
  nms_sweep_kernel<<<P, threads, smem, stream>>>(iou, valid, keep, K, rows,
                                                 thr);
  return end_launch();
}
