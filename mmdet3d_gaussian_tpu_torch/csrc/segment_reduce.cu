// Sorted-segment sum / max, per segment or mapped back onto every row.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/segment_kernel.py::_fused_raw
// (the forward segmented scan + reverse broadcast behind sorted_reduce and
// sorted_reduce_mapback).  Rows arrive sorted by segment id, so segment v is
// the contiguous row range [starts[v], starts[v] + counts[v]).
//
// Bound on an H100: bytes.  The dynamic pillar encoder reduces ~65k point
// rows of 4 or 64 f32 channels: each input row is read once and each output
// row written once (33 MB for the 64-channel max, ~2.4 MB for the
// 4-channel mean), a few microseconds of HBM time, so the small pass is
// launch-bound.  The TPU kernel needed two sequential grid sweeps because its
// grid runs in order with a carry in VMEM; here a segment's extent is known
// up front, so the reduction is one pass with no carry:
//   * reduce:  one thread per (segment, channel) walks the segment's rows;
//     consecutive threads read consecutive channels of a row (coalesced).
//   * mapback: one thread per (row, channel); the segment's first row
//     computes the reduction and writes it to every row of the segment, rows
//     outside any live segment write 0, so each output element is written
//     exactly once.
//   * argmax (the winner form, for the max backward; replaces
//     segment_kernel.py::_winner_mask, which runs _fused_raw with
//     want_pe=True): one thread per (segment, channel) walks its rows and
//     returns the max together with the lowest row index holding it (the
//     reference's atomicMin traceback).  A NaN makes the max NaN with no
//     winner, as the reference's `x == max` test finds none; empty segments
//     give 0 and no winner (-1).
// Sums accumulate in f32 in row order; max propagates NaN like jnp.maximum.
#include "common.cuh"

namespace {

__device__ __forceinline__ float combine(float acc, float x, int is_max) {
  if (is_max) return (x > acc || x != x) ? x : acc;
  return acc + x;
}

__device__ __forceinline__ float reduce_rows(const float* __restrict__ p,
                                             int count, int C, int is_max) {
  float acc = p[0];
  for (int k = 1; k < count; ++k) acc = combine(acc, p[(long long)k * C], is_max);
  return acc;
}

__global__ void segment_reduce_kernel(const float* __restrict__ data,
                                      const int* __restrict__ starts,
                                      const int* __restrict__ counts,
                                      float* __restrict__ out, int V, int C,
                                      int is_max) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  int v = (int)(t / C);
  int c = (int)(t - (long long)v * C);
  int count = counts[v];
  float acc = 0.0f;  // empty segments read 0
  if (count > 0)
    acc = reduce_rows(data + (long long)starts[v] * C + c, count, C, is_max);
  out[t] = acc;
}

__global__ void segment_mapback_kernel(const float* __restrict__ data,
                                       const int* __restrict__ ids,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ counts,
                                       float* __restrict__ out, int N, int V,
                                       int C, int is_max) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * C) return;
  int r = (int)(t / C);
  int c = (int)(t - (long long)r * C);
  int v = ids[r];
  if (v < 0 || v >= V) {  // invalid / trash row
    out[t] = 0.0f;
    return;
  }
  int start = starts[v];
  if (r != start) return;  // the segment's first row writes for all of it
  int count = counts[v];
  const float* p = data + (long long)start * C + c;
  float acc = reduce_rows(p, count, C, is_max);
  float* o = out + (long long)start * C + c;
  for (int k = 0; k < count; ++k) o[(long long)k * C] = acc;
}

__global__ void segment_argmax_kernel(const float* __restrict__ data,
                                      const int* __restrict__ starts,
                                      const int* __restrict__ counts,
                                      float* __restrict__ out,
                                      int* __restrict__ winner, int V, int C) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  int v = (int)(t / C);
  int c = (int)(t - (long long)v * C);
  int count = counts[v];
  float acc = 0.0f;
  int win = -1;
  if (count > 0) {
    int start = starts[v];
    const float* p = data + (long long)start * C + c;
    acc = p[0];
    win = (acc == acc) ? start : -1;
    for (int k = 1; k < count; ++k) {
      float x = p[(long long)k * C];
      if (x != x) {          // NaN: the max is NaN and has no winner
        acc = x;
        win = -1;
      } else if (x > acc) {  // strict: ties keep the lower row
        acc = x;
        win = start + k;
      }
    }
  }
  out[t] = acc;
  winner[t] = win;
}

constexpr int kThreads = 256;

}  // namespace

KERNEL_API int segment_reduce_launch(int device, const float* data,
                                     const int* starts, const int* counts,
                                     float* out, int V, int C, int is_max,
                                     cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long work = (long long)V * C;
  if (work == 0) return 0;
  segment_reduce_kernel<<<blocks_for(work, kThreads), kThreads, 0, stream>>>(
      data, starts, counts, out, V, C, is_max);
  return end_launch();
}

KERNEL_API int segment_mapback_launch(int device, const float* data,
                                      const int* ids, const int* starts,
                                      const int* counts, float* out, int N,
                                      int V, int C, int is_max,
                                      cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long work = (long long)N * C;
  if (work == 0) return 0;
  segment_mapback_kernel<<<blocks_for(work, kThreads), kThreads, 0, stream>>>(
      data, ids, starts, counts, out, N, V, C, is_max);
  return end_launch();
}

KERNEL_API int segment_argmax_launch(int device, const float* data,
                                     const int* starts, const int* counts,
                                     float* out, int* winner, int V, int C,
                                     cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long work = (long long)V * C;
  if (work == 0) return 0;
  segment_argmax_kernel<<<blocks_for(work, kThreads), kThreads, 0, stream>>>(
      data, starts, counts, out, winner, V, C);
  return end_launch();
}
