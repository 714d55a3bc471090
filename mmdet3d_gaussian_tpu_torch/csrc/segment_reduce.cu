// K1 on Hopper: sorted-segment sum / max per segment, mapped back onto
// every row, and the max with its per-row winner mask.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/segment_kernel.py::_fused_raw
// (the forward segmented scan + reverse broadcast behind sorted_reduce and
// sorted_reduce_mapback) and its winner form _winner_mask.  Rows arrive
// sorted by segment id, so segment v is the contiguous row range
// [starts[v], starts[v] + counts[v]).
//
// Bound on an H100: bytes.  The dynamic pillar encoder reduces 65,536
// point rows of 64 f32 channels into 64,000 pillars, about one row a
// pillar: each input row is read once and each output row written once
// (33.7 MB for the reduce, 38 MB for the max with its mask, 10 and 11 us at
// 3.35 TB/s); the 4-channel cluster mean (mapback) moves 2.4 MB and sits at
// the launch floor.  With so little work a segment, the time is the chain
// of dependent loads (segment bounds, then rows) times the waves of
// threads, so the design keeps each thread's bytes in flight large and the
// chain short:
//   * a group of G lanes (a power of two up to 32) owns one segment and
//     runs over its channels in 16-byte vectors (float4; G = 16 at C = 64,
//     two segments a warp), stores 16 bytes a lane, and needs no 64-bit
//     division (the group is a shift of the thread index);
//   * lanes 0 and 1 of a group load the segment's start and count side by
//     side and share them by __shfl_sync, so the first row load waits on
//     one load, not two in a row;
//   * rows are walked four at a time with independent loads, combined in
//     row order (sums accumulate in f32 in row order; the max propagates NaN
//     like jnp.maximum);
//   * where C % 4 != 0 or the data pointer is not 16-byte aligned, the
//     same body runs on single floats (W = 1); the wrapper picks.
// The three forms:
//   * reduce:  out (V, C); empty segments 0;
//   * mapback: a group per row; a row outside [0, V) writes 0, the first
//     row of each segment (its id differs from the previous row's) reduces
//     it and writes every row of it, so each output element is written
//     once;
//   * winner:  out (V, C) as the max reduce, and mask (N, C) bytes, true at
//     the lowest row holding its segment's max (the reference's atomicMin
//     traceback, _winner_mask's (x == total) & (first | x > prefix)); false
//     everywhere in a NaN max's (segment, channel), which the reference's
//     x == max test never finds; false on rows with an id outside [0, V).
//     A group walks its segment once for the max and the winner, then
//     writes the mask bytes of its rows (4 a lane, one 32-bit store); group
//     t < N also writes row t's zero mask when ids[t] lies outside [0, V).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}

template <int W>
__device__ __forceinline__ void store_zero(float* __restrict__ p) {
  float z[W];
#pragma unroll
  for (int j = 0; j < W; ++j) z[j] = 0.f;
  store<W>(p, z);
}

template <int W>
__device__ __forceinline__ void combine(float (&acc)[W], const float (&x)[W],
                                        int is_max) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    acc[j] = is_max ? ((x[j] > acc[j] || x[j] != x[j]) ? x[j] : acc[j])
                    : acc[j] + x[j];
}

// acc (holding the row at p) = op over the count > 0 rows at p, p + C, ...
// in row order
template <int W>
__device__ __forceinline__ void reduce_more(const float* __restrict__ p,
                                            int count, long long C,
                                            int is_max, float (&acc)[W]) {
  int k = 1;
  for (; k + 4 <= count; k += 4) {
    float x0[W], x1[W], x2[W], x3[W];
    load<W>(p + k * C, x0);
    load<W>(p + (k + 1) * C, x1);
    load<W>(p + (k + 2) * C, x2);
    load<W>(p + (k + 3) * C, x3);
    combine<W>(acc, x0, is_max);
    combine<W>(acc, x1, is_max);
    combine<W>(acc, x2, is_max);
    combine<W>(acc, x3, is_max);
  }
  for (; k < count; ++k) {
    float x[W];
    load<W>(p + k * C, x);
    combine<W>(acc, x, is_max);
  }
}

template <int W>
__device__ __forceinline__ void reduce_rows(const float* __restrict__ p,
                                            int count, long long C,
                                            int is_max, float (&acc)[W]) {
  load<W>(p, acc);
  reduce_more<W>(p, count, C, is_max, acc);
}

// max over the count > 0 rows at p, ... and the lowest row holding it
// (start + k); a NaN makes the max NaN with no winner (-1)
template <int W>
__device__ __forceinline__ void take(float (&acc)[W], int (&win)[W],
                                     const float (&x)[W], int row) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (x[j] != x[j]) {
      acc[j] = x[j];
      win[j] = -1;
    } else if (x[j] > acc[j]) {  // strict: ties keep the lower row
      acc[j] = x[j];
      win[j] = row;
    }
  }
}

template <int W>
__device__ __forceinline__ void max_winner_rows(const float* __restrict__ p,
                                                int count, long long C,
                                                int start, float (&acc)[W],
                                                int (&win)[W]) {
  load<W>(p, acc);
#pragma unroll
  for (int j = 0; j < W; ++j) win[j] = acc[j] == acc[j] ? start : -1;
  // one row at a time: the main path's segments hold about one row, and
  // the registers kept free give the kernel more threads in flight
  for (int k = 1; k < count; ++k) {
    float x[W];
    load<W>(p + k * C, x);
    take<W>(acc, win, x, start + k);
  }
}

template <int W>
__device__ __forceinline__ void store_mask(uint8_t* __restrict__ p,
                                           const int (&win)[W], int row) {
  if constexpr (W == 4) {
    uchar4 m = make_uchar4(win[0] == row, win[1] == row, win[2] == row,
                           win[3] == row);
    *reinterpret_cast<uchar4*>(p) = m;
  } else {
    p[0] = win[0] == row;
  }
}

template <int W>
__device__ __forceinline__ void store_mask_zero(uint8_t* __restrict__ p) {
  if constexpr (W == 4)
    *reinterpret_cast<uchar4*>(p) = make_uchar4(0, 0, 0, 0);
  else
    p[0] = 0;
}

// The group's segment, its lane in the group, and the segment's start and
// count (0 past V): lanes 0 and 1 of the group load them side by side.
// Every lane of the warp must call it (shuffles).
struct Seg {
  long long v;
  int sub, start, count;
};

__device__ __forceinline__ Seg segment_of_group(
    const int* __restrict__ starts, const int* __restrict__ counts,
    long long V, int lg) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int G = 1 << lg;
  Seg s;
  s.v = t >> lg;
  s.sub = threadIdx.x & (G - 1);
  if (G == 1) {
    s.start = s.v < V ? starts[s.v] : 0;
    s.count = s.v < V ? counts[s.v] : 0;
    return s;
  }
  int m = 0;
  if (s.v < V && s.sub < 2) m = s.sub ? counts[s.v] : starts[s.v];
  const int base = (threadIdx.x & 31) & ~(G - 1);
  s.start = __shfl_sync(kFull, m, base);
  s.count = __shfl_sync(kFull, m, base + 1);
  return s;
}

template <int W>
__global__ void __launch_bounds__(kThreads) segment_reduce_kernel(
    const float* __restrict__ data, const int* __restrict__ starts,
    const int* __restrict__ counts, float* __restrict__ out, int V, int C,
    int lg, int is_max) {
  const Seg s = segment_of_group(starts, counts, V, lg);
  if (s.v >= V) return;
  const int G = 1 << lg;
  for (int c = s.sub * W; c < C; c += G * W) {
    float acc[W];
    if (s.count > 0)
      reduce_rows<W>(data + (long long)s.start * C + c, s.count, C, is_max,
                     acc);
    else
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.f;  // empty segments read 0
    store<W>(out + s.v * C + c, acc);
  }
}

// A group per row r.  Its id, the previous row's id and its first data
// vector load side by side; a row whose id differs from the previous
// row's is the first of its segment (ids ascend), which then needs only its
// count before the rest of its rows: two dependent loads, not four.
template <int W>
__global__ void __launch_bounds__(kThreads) segment_mapback_kernel(
    const float* __restrict__ data, const int* __restrict__ ids,
    const int* __restrict__ counts, float* __restrict__ out, int N, int V,
    int C, int lg, int is_max) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> lg;
  if (r >= N) return;
  const int G = 1 << lg, sub = threadIdx.x & (G - 1), c0 = sub * W;
  const int v = __ldg(ids + r);
  const bool first = r == 0 || __ldg(ids + r - 1) != v;
  float x0[W];
  if (c0 < C) load<W>(data + r * C + c0, x0);
  if (v < 0 || v >= V) {  // invalid / trash row
    for (int c = c0; c < C; c += G * W) store_zero<W>(out + r * C + c);
    return;
  }
  if (!first) return;  // the segment's first row writes for all of it
  const int count = __ldg(counts + v);
  for (int c = c0; c < C; c += G * W) {
    float acc[W];
    if (c == c0) {
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = x0[j];
    } else {
      load<W>(data + r * C + c, acc);
    }
    reduce_more<W>(data + r * C + c, count, C, is_max, acc);
    for (int k = 0; k < count; ++k) store<W>(out + (r + k) * C + c, acc);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 6) segment_max_winner_kernel(
    const float* __restrict__ data, const int* __restrict__ ids,
    const int* __restrict__ starts, const int* __restrict__ counts,
    float* __restrict__ out, uint8_t* __restrict__ mask, int N, int V,
    int C, int lg) {
  const Seg s = segment_of_group(starts, counts, V, lg);
  const int G = 1 << lg;
  // group t is also row t: zero its mask if no segment owns the row
  const int id = s.v < N ? __ldg(ids + s.v) : 0;
  if (s.v < V) {
    for (int c = s.sub * W; c < C; c += G * W) {
      float acc[W];
      int win[W] = {};
      if (s.count > 0) {
        max_winner_rows<W>(data + (long long)s.start * C + c, s.count, C,
                           s.start, acc, win);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = 0.f;  // empty: 0, no rows
      }
      store<W>(out + s.v * C + c, acc);
      for (int k = 0; k < s.count; ++k)
        store_mask<W>(mask + (long long)(s.start + k) * C + c, win,
                      s.start + k);
    }
  }
  if (s.v < N && (id < 0 || id >= V))
    for (int c = s.sub * W; c < C; c += G * W)
      store_mask_zero<W>(mask + s.v * C + c);
}

// lanes per segment: enough W-wide vectors to cover a row, at most a warp
int lanes_log2(int C, int W) {
  const int vecs = (C + W - 1) / W;
  int lg = 0;
  while (lg < 5 && (1 << lg) < vecs) ++lg;
  return lg;
}

}  // namespace

// vec: 1 for the float4 body (C % 4 == 0, data 16-byte aligned; the
// wrapper checks), 0 for single floats
KERNEL_API int segment_reduce_launch(int device, const float* data,
                                     const int* starts, const int* counts,
                                     float* out, int V, int C, int is_max,
                                     int vec, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if ((long long)V * C == 0) return 0;
  const int W = vec ? 4 : 1, lg = lanes_log2(C, W);
  const unsigned blocks = blocks_for((long long)V << lg, kThreads);
  if (vec)
    segment_reduce_kernel<4><<<blocks, kThreads, 0, stream>>>(
        data, starts, counts, out, V, C, lg, is_max);
  else
    segment_reduce_kernel<1><<<blocks, kThreads, 0, stream>>>(
        data, starts, counts, out, V, C, lg, is_max);
  return end_launch();
}

KERNEL_API int segment_mapback_launch(int device, const float* data,
                                      const int* ids, const int* counts,
                                      float* out, int N, int V, int C,
                                      int is_max, int vec,
                                      cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if ((long long)N * C == 0) return 0;
  const int W = vec ? 4 : 1, lg = lanes_log2(C, W);
  const unsigned blocks = blocks_for((long long)N << lg, kThreads);
  if (vec)
    segment_mapback_kernel<4><<<blocks, kThreads, 0, stream>>>(
        data, ids, counts, out, N, V, C, lg, is_max);
  else
    segment_mapback_kernel<1><<<blocks, kThreads, 0, stream>>>(
        data, ids, counts, out, N, V, C, lg, is_max);
  return end_launch();
}

// out (V, C) f32 and mask (N, C) bytes; ids (N,) as for the mapback
KERNEL_API int segment_max_winner_launch(int device, const float* data,
                                         const int* ids, const int* starts,
                                         const int* counts, float* out,
                                         uint8_t* mask, int N, int V, int C,
                                         int vec, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  const long long groups = V > N ? V : N;
  if (groups * C == 0) return 0;
  const int W = vec ? 4 : 1, lg = lanes_log2(C, W);
  const unsigned blocks = blocks_for(groups << lg, kThreads);
  if (vec)
    segment_max_winner_kernel<4><<<blocks, kThreads, 0, stream>>>(
        data, ids, starts, counts, out, mask, N, V, C, lg);
  else
    segment_max_winner_kernel<1><<<blocks, kThreads, 0, stream>>>(
        data, ids, starts, counts, out, mask, N, V, C, lg);
  return end_launch();
}
