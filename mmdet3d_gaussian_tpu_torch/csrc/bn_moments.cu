// Per-channel BatchNorm statistics for training: (sum x, sum x^2) in the
// forward, (sum g, sum g * xhat) with xhat = (x - mean) * inv in the backward.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/bn_kernel.py::moments and
// ::grad_moments (kernels _moments_kernel and _bwd_kernel).  The TPU kernel
// carries one (2, C) accumulator through a sequential grid; here blocks run
// in parallel, so the reduction has two levels with no atomics:
//   1. each block reduces a fixed range of rows into one partial (2, C) row
//      (fixed per-thread order, then a fixed order across the block);
//   2. per channel, 32 lanes each add every 32nd partial in block order,
//      then a fixed-shape tree over the lanes.
// The split depends on the shape only, so repeated runs give bitwise equal
// statistics (one sequential f32 sum over 214k rows would also drift from
// the tree-shaped sums of the reference).
//
// Layout: the activation is read where it lies.  Element (row r, channel c)
// sits at (r / S) * sb + (r % S) * ss + c * sc, which covers an (M, C)
// matrix and an NCHW tensor in either memory format; the backward's g and x
// each get their own strides.  With channels innermost (sc == 1, the
// channels-last conv output) neighbouring threads read neighbouring channels
// of a row; otherwise (per-channel planes) a block owns one channel and its
// threads read neighbouring rows.  Both are coalesced.
//
// Element type: x and g are f32, or both bf16 (the mixed-precision model's
// activations, as FastBatchNorm(dtype='bfloat16') reads them); every sum is
// taken in f32 either way.
//
// Bound on an H100: bytes.  Each input element is read once (4 bytes, 8 for
// the backward's g and x; half that in bf16) and each does 2 (forward) or 4
// (backward) f32 operations; the largest BN of the KITTI train step reads
// 214,272 x 128 f32 (110 MB), ~33 us of HBM time.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 256;

struct Layout {
  long long S, sb, ss, sc;
};

// Walks rows in steps of a fixed stride, keeping (r / S, r % S) without a
// division per element.
struct Cursor {
  long long b, s;
  __device__ Cursor(long long r, long long S) : b(r / S), s(r - (r / S) * S) {}
  __device__ __forceinline__ void advance(long long step, long long S) {
    s += step;
    while (s >= S) {
      s -= S;
      ++b;
    }
  }
  __device__ __forceinline__ long long at(const Layout& l, int c) const {
    return b * l.sb + s * l.ss + (long long)c * l.sc;
  }
};

template <bool kGrad, typename T>
__device__ __forceinline__ void accumulate_rows(
    const T* __restrict__ x, const T* __restrict__ g, Layout lx,
    Layout lg, int c, long long r_begin, long long r_end, long long step,
    float m, float iv, float& a, float& q) {
  if (r_begin >= r_end) return;
  Cursor cx(r_begin, lx.S);
  Cursor cg(r_begin, lg.S);
  for (long long r = r_begin; r < r_end; r += step) {
    float v = to_f32(x[cx.at(lx, c)]);
    if (kGrad) {
      float gv = to_f32(g[cg.at(lg, c)]);
      a += gv;
      q += gv * ((v - m) * iv);
      cg.advance(step, lg.S);
    } else {
      a += v;
      q += v * v;
    }
    cx.advance(step, lx.S);
  }
}

// Channels innermost: thread = (lane, channel); lanes interleave rows.
template <bool kGrad, typename T>
__global__ void partial_rows_kernel(const T* __restrict__ x,
                                    const T* __restrict__ g,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ inv,
                                    long long rows, int C, Layout lx,
                                    Layout lg, long long rows_per_block,
                                    float* __restrict__ parts) {
  __shared__ float sa[kThreads];
  __shared__ float sq[kThreads];
  const int ct = C < kThreads ? C : kThreads;
  const int lanes = kThreads / ct;
  const int tid = threadIdx.x;
  const int lane = tid / ct;
  const int cc = tid - lane * ct;
  const int c = blockIdx.y * ct + cc;
  const bool active = lane < lanes && c < C;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float a = 0.f, q = 0.f;
  if (active) {
    float m = kGrad ? mean[c] : 0.f;
    float iv = kGrad ? inv[c] : 0.f;
    accumulate_rows<kGrad, T>(x, g, lx, lg, c, r0 + lane, r1, lanes, m, iv,
                              a, q);
  }
  sa[tid] = a;
  sq[tid] = q;
  __syncthreads();
  if (active && lane == 0) {
    for (int l = 1; l < lanes; ++l) {
      a += sa[l * ct + cc];
      q += sq[l * ct + cc];
    }
    parts[((long long)blockIdx.x * 2) * C + c] = a;
    parts[((long long)blockIdx.x * 2 + 1) * C + c] = q;
  }
}

// Channel planes: block = (row range, channel); threads interleave rows,
// then a fixed-shape tree in shared memory.
template <bool kGrad, typename T>
__global__ void partial_planes_kernel(const T* __restrict__ x,
                                      const T* __restrict__ g,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ inv,
                                      long long rows, int C, Layout lx,
                                      Layout lg, long long rows_per_block,
                                      float* __restrict__ parts) {
  __shared__ float sa[kThreads];
  __shared__ float sq[kThreads];
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float a = 0.f, q = 0.f;
  float m = kGrad ? mean[c] : 0.f;
  float iv = kGrad ? inv[c] : 0.f;
  accumulate_rows<kGrad, T>(x, g, lx, lg, c, r0 + tid, r1, kThreads, m, iv,
                            a, q);
  sa[tid] = a;
  sq[tid] = q;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      sa[tid] += sa[tid + half];
      sq[tid] += sq[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    parts[((long long)blockIdx.x * 2) * C + c] = sa[0];
    parts[((long long)blockIdx.x * 2 + 1) * C + c] = sq[0];
  }
}

// Second level: out[mom][c] = sum_p parts[p][mom][c].  blockIdx.y is the
// moment, blockIdx.x a group of kFinC channels (threadIdx.x); lane
// threadIdx.y adds partials lane, lane + kFinLanes, ... in order, then a
// tree over the lanes in shared memory.  The shape alone fixes the order.
constexpr int kFinC = 32;
constexpr int kFinLanes = 32;

__global__ void finalize_kernel(const float* __restrict__ parts, int P, int C,
                                float* __restrict__ out) {
  __shared__ float red[kFinLanes][kFinC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinC + tx;
  const int mom = blockIdx.y;
  float acc = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int p = ty; p < P; p += kFinLanes)
      acc += parts[((long long)p * 2 + mom) * C + c];
  }
  red[ty][tx] = acc;
  __syncthreads();
  for (int half = kFinLanes / 2; half > 0; half >>= 1) {
    if (ty < half) red[ty][tx] += red[ty + half][tx];
    __syncthreads();
  }
  if (ty == 0 && c < C) out[(long long)mom * C + c] = red[0][tx];
}

template <bool kGrad, typename T>
int launch_moments(const T* g, const T* x, const float* mean,
                   const float* inv, long long rows, int C, Layout lx,
                   Layout lg, float* parts, int P, float* out,
                   cudaStream_t stream) {
  if (rows <= 0 || C <= 0 || P <= 0) return 0;
  long long rpb = (rows + P - 1) / P;
  if (lx.sc == 1) {
    int ct = C < kThreads ? C : kThreads;
    dim3 grid(P, (C + ct - 1) / ct);
    partial_rows_kernel<kGrad, T><<<grid, kThreads, 0, stream>>>(
        x, g, mean, inv, rows, C, lx, lg, rpb, parts);
  } else {
    dim3 grid(P, C);
    partial_planes_kernel<kGrad, T><<<grid, kThreads, 0, stream>>>(
        x, g, mean, inv, rows, C, lx, lg, rpb, parts);
  }
  finalize_kernel<<<dim3((C + kFinC - 1) / kFinC, 2), dim3(kFinC, kFinLanes),
                    0, stream>>>(parts, P, C, out);
  return end_launch();
}

}  // namespace

// out (2, C): out[0] = sum x, out[1] = sum x^2; parts (P, 2, C) scratch;
// bf16: x is bf16 (else f32).
KERNEL_API int bn_moments_launch(int device, const void* x, long long rows,
                                 int C, long long S, long long sb,
                                 long long ss, long long sc, float* parts,
                                 int P, float* out, int bf16,
                                 cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  Layout lx{S, sb, ss, sc};
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_moments<false, T>(nullptr, static_cast<const T*>(x),
                                    nullptr, nullptr, rows, C, lx, lx, parts,
                                    P, out, stream);
  }
  return launch_moments<false, float>(nullptr, static_cast<const float*>(x),
                                      nullptr, nullptr, rows, C, lx, lx,
                                      parts, P, out, stream);
}

// out (2, C): out[0] = sum g, out[1] = sum g * (x - mean) * inv; bf16: g
// and x are bf16 (else f32).
KERNEL_API int bn_grad_moments_launch(
    int device, const void* g, const void* x, const float* mean,
    const float* inv, long long rows, int C, long long Sx, long long sbx,
    long long ssx, long long scx, long long Sg, long long sbg, long long ssg,
    long long scg, float* parts, int P, float* out, int bf16,
    cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  Layout lx{Sx, sbx, ssx, scx};
  Layout lg{Sg, sbg, ssg, scg};
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_moments<true, T>(static_cast<const T*>(g),
                                   static_cast<const T*>(x), mean, inv, rows,
                                   C, lx, lg, parts, P, out, stream);
  }
  return launch_moments<true, float>(static_cast<const float*>(g),
                                     static_cast<const float*>(x), mean, inv,
                                     rows, C, lx, lg, parts, P, out, stream);
}
