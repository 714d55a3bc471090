// K4 on Hopper: one launch a call; channels-last rows (the main path) as 64-channel groups, a block a chunk of rows with 16-byte loads (8 in flight a thread), channel planes as warp runs of scalar loads; partials in chunks fixed by the shape, added in order by the last block of each group. Bound: bytes (795 MB forward, 1.59 GB backward a f32 step: 0.237 / 0.475 ms at 3.35 TB/s).
//
// Per-channel BatchNorm statistics for training: (sum x, sum x^2) in the
// forward, (sum g, sum g * xhat) with xhat = (x - mean) * inv in the backward.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/bn_kernel.py::moments and
// ::grad_moments (kernels _moments_kernel and _bwd_kernel).  The TPU kernel
// carries one (2, C) accumulator through a sequential grid; here the rows of
// each channel are cut into chunks fixed by the shape alone (ops/bn.py::
// chunking), each chunk is reduced into its own partial slot, and the last
// block to finish adds each channel's partials in index order.  Every sum
// has a fixed order (per lane in row order, then a fixed shuffle tree, then
// the partials in order), with no float atomics: repeated runs on the same
// tensor give bitwise equal statistics.
//
// Layout: the activation is read where it lies.  Element (plane b, position
// s, channel c) sits at b * sb + s * ss + c * sc, with x and g split into
// the same planes of S rows (ops/bn.py::kernel_plan), which covers an
// (M, C) matrix and an NCHW tensor in either memory format.  Paths, chosen
// by the wrapper:
//   rows (channels innermost, sc == 1): a block item is one chunk of rows
//     of one group of 64 channels; rows-vector reads 16 bytes of
//     neighbouring channels a thread (8 loads in flight) where C, the
//     strides and the pointer allow it, rows-scalar one element.  The
//     port's convolutions write channels last, so the main path's 19 + 19
//     calls a step take rows-vector.
//   planes (channel not innermost: NCHW, and g laid out otherwise than x):
//     a warp owns one chunk of one channel, a run of rows along a plane,
//     one element a lane.
// Chunks are fixed by the shape (ops/bn.py::chunking): about 256 block
// items a call on the rows path, so every call has enough loads in flight
// to fill the card's memory; about 4,096 warp runs on the planes path.
//
// One launch: every block (rows: every item) adds one to a ticket (an
// integer atomic after a __threadfence, which does not touch the float
// order); the block that draws the last ticket (of its channel group, on
// the rows path) reads the partials from L2, writes out and sets the
// ticket back to 0 for the next launch on the stream.
//
// Element type: x and g are f32, or both bf16 (the mixed-precision model's
// activations); every sum is taken in f32 either way.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 64;   // channels a rows-path block item reduces

enum Path { kPlanes = 0, kRowsScalar = 1, kRowsVector = 2 };

struct Strides {
  long long sb, ss, sc;
};

// Chunk k of a channel: planes [k * planes, (k + 1) * planes) whole when
// splits == 1, else rows [j * span, (j + 1) * span) of plane k / splits,
// j = k % splits (ops/bn.py::chunk_rows).
struct Chunks {
  long long planes, splits, span, count;
};

__device__ __forceinline__ void chunk_range(const Chunks& ch, long long k,
                                            long long B, long long S,
                                            long long& b0, long long& b1,
                                            long long& s0, long long& s1) {
  if (ch.splits > 1) {
    b0 = k / ch.splits;
    b1 = b0 + 1;
    s0 = (k - b0 * ch.splits) * ch.span;
    s1 = min(S, s0 + ch.span);
  } else {
    b0 = k * ch.planes;
    b1 = min(B, b0 + ch.planes);
    s0 = 0;
    s1 = S;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Elements of one 16-byte word, in memory order.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void unpack(const uint4& w, float* f) {
    const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// kN running (a, q) pairs of one thread.
template <bool kGrad, int kN>
struct Acc {
  float a[kN], q[kN];
  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int i = 0; i < kN; ++i) a[i] = q[i] = 0.f;
  }
  __device__ __forceinline__ void add(int i, float x, float g, float m,
                                      float iv) {
    if (kGrad) {
      a[i] += g;
      q[i] += g * ((x - m) * iv);
    } else {
      a[i] += x;
      q[i] += x * x;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The second level, in the block that finishes last: out[it] = sum over
// p of parts[it * count + p], it = moment * C + channel; k lanes (a power
// of two fixed by C) share an item, each adding every k-th partial in
// order, then a fixed shuffle tree.  Resets the ticket.
__device__ void finish(const float* __restrict__ parts, int C,
                       long long count, unsigned int* ticket,
                       float* __restrict__ out) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int items = 2 * C;
  int k = 1;
  while (k < 32 && 2 * k * items <= kThreads) k *= 2;
  const int groups = kThreads / k;
  const int sub = threadIdx.x % k, grp = threadIdx.x / k;
  for (int base = 0; base < items; base += groups) {
    const int it = base + grp;
    float s = 0.f;
    if (it < items) {
      const float* p = parts + (long long)it * count;
#pragma unroll 8
      for (long long j = sub; j < count; j += k) s += __ldcg(p + j);
    }
    for (int off = k >> 1; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (it < items && sub == 0) out[it] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <bool kGrad, typename T>
__global__ void __launch_bounds__(kThreads) planes_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv, int C,
    long long B, long long S, Strides lx, Strides lg, Chunks ch,
    float* __restrict__ parts, unsigned int* ticket,
    float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long items = (long long)C * ch.count;
  for (long long w = (long long)blockIdx.x * kWarps + warp; w < items;
       w += (long long)gridDim.x * kWarps) {
    const int c = (int)(w / ch.count);
    const long long k = w - (long long)c * ch.count;
    const float m = kGrad ? mean[c] : 0.f, iv = kGrad ? inv[c] : 0.f;
    long long b0, b1, s0, s1;
    chunk_range(ch, k, B, S, b0, b1, s0, s1);
    Acc<kGrad, 1> acc;
    for (long long b = b0; b < b1; ++b) {
      const T* xp = x + b * lx.sb + c * lx.sc + s0 * lx.ss;
      const T* gp = kGrad ? g + b * lg.sb + c * lg.sc + s0 * lg.ss : nullptr;
#pragma unroll 4
      for (long long i = lane; i < s1 - s0; i += 32)
        acc.add(0, to_f32(xp[i * lx.ss]), kGrad ? to_f32(gp[i * lg.ss]) : 0.f,
                m, iv);
    }
    const float a = warp_sum(acc.a[0]), q = warp_sum(acc.q[0]);
    if (lane == 0) {
      parts[(long long)c * ch.count + k] = a;
      parts[((long long)C + c) * ch.count + k] = q;
    }
  }
  finish(parts, C, ch.count, ticket, out);
}

// The rows path's second level, in the block that finishes group q last:
// out[moment][c] = sum over p of parts[(p * 2 + moment) * C + c] for the
// group's channels.  Eight lanes an item, each adding every eighth partial
// in order, then the eight in order; an item is four channels (16-byte
// loads) when C allows, else one.  Resets the group's ticket.
__device__ void finish_group(const float* __restrict__ parts, int C, int q,
                             long long count, unsigned int* ticket,
                             float* __restrict__ out, float4* red) {
  constexpr int kSubs = 8;
  constexpr int kSlots = kThreads / kSubs;    // 32 items: 2 x 16 quads
  const int it = threadIdx.x % kSlots, sub = threadIdx.x / kSlots;
  const int c0 = q * kGroup, width = min(kGroup, C - c0);
  const bool quads = C % 4 == 0;              // then width % 4 == 0 too
  const int per = quads ? 4 : 1;
  for (int base = 0; base < 2 * width; base += kSlots * per) {
    // item it: moment and first channel of its `per` channels
    const int j = base + it * per;
    const int mom = j / width, c = c0 + j % width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < 2 * width) {
      const float* at = parts + (long long)mom * C + c;
      if (quads) {
#pragma unroll 8
        for (long long p = sub; p < count; p += kSubs) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              at + p * 2 * C));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      } else {
#pragma unroll 8
        for (long long p = sub; p < count; p += kSubs)
          acc.x += __ldcg(at + p * 2 * C);
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (sub == 0 && j < 2 * width) {
      float4 t = acc;
      for (int k = 1; k < kSubs; ++k) {
        const float4 v = red[k * kSlots + it];
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
      float* o = out + (long long)mom * C + c;
      o[0] = t.x;
      if (quads) {
        o[1] = t.y;
        o[2] = t.z;
        o[3] = t.w;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// Channels innermost: a block item is (group q of kGroup channels, chunk k
// of rows); thread (lane, u) reads unit u (kN channels) of rows lane,
// lane + kLanes, ..., then the lanes of each unit are added by shuffles
// inside a warp and across warps in order: one partial (2, kGroup) an
// item.  The block drawing a group's last ticket finishes that group.
template <bool kGrad, typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv, int C,
    long long B, long long S, Strides lx, Strides lg, Chunks ch,
    float* __restrict__ parts, unsigned int* tickets,
    float* __restrict__ out) {
  constexpr int kN = kVector ? Word<T>::kN : 1;
  constexpr int kU = kGroup / kN;             // threads across a group row
  constexpr int kLanes = kThreads / kU;       // rows read at once
  constexpr int kWide = kU < 32 ? 32 : kU;    // threads left after shuffles
  constexpr int kParts = kThreads / kWide;    // ... a unit
  constexpr int kLoads = kGrad ? 4 : 8;       // 16-byte loads in flight
  __shared__ float red[2][kParts][kGroup];
  __shared__ float4 fin[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int u = tid % kU, lane = tid / kU;
  const int groups = (C + kGroup - 1) / kGroup;
  const long long items = ch.count * groups;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int q = (int)(w / ch.count);
    const long long k = w - (long long)q * ch.count;
    const int c0 = q * kGroup + u * kN;
    Acc<kGrad, kN> acc;
    if (c0 < C) {                             // kVector: C % kN == 0
      float m[kN], iv[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        m[e] = kGrad ? mean[c0 + e] : 0.f;
        iv[e] = kGrad ? inv[c0 + e] : 0.f;
      }
      long long b0, b1, s0, s1;
      chunk_range(ch, k, B, S, b0, b1, s0, s1);
      float fx[kN], fg[kN];
      for (long long b = b0; b < b1; ++b) {
        const T* xb = x + b * lx.sb + c0;
        const T* gb = kGrad ? g + b * lg.sb + (long long)c0 * lg.sc : nullptr;
        long long s = s0 + lane;
        if constexpr (kVector) {
          for (; s + (kLoads - 1) * kLanes < s1; s += kLoads * kLanes) {
            uint4 wx[kLoads], wg[kLoads];
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
              const long long r = s + i * kLanes;
              wx[i] = __ldg(reinterpret_cast<const uint4*>(xb + r * lx.ss));
              if (kGrad)
                wg[i] = __ldg(reinterpret_cast<const uint4*>(gb + r * lg.ss));
            }
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
              Word<T>::unpack(wx[i], fx);
              if (kGrad) Word<T>::unpack(wg[i], fg);
#pragma unroll
              for (int e = 0; e < kN; ++e)
                acc.add(e, fx[e], kGrad ? fg[e] : 0.f, m[e], iv[e]);
            }
          }
        }
#pragma unroll 4
        for (; s < s1; s += kLanes) {
          if constexpr (kVector) {
            Word<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                xb + s * lx.ss)), fx);
            if (kGrad)
              Word<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                  gb + s * lg.ss)), fg);
          } else {
            fx[0] = to_f32(xb[s * lx.ss]);
            if (kGrad) fg[0] = to_f32(gb[s * lg.ss]);
          }
#pragma unroll
          for (int e = 0; e < kN; ++e)
            acc.add(e, fx[e], kGrad ? fg[e] : 0.f, m[e], iv[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      float a = acc.a[e], qq = acc.q[e];
      if constexpr (kU < 32) {
#pragma unroll
        for (int off = kU; off < 32; off <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          qq += __shfl_xor_sync(0xffffffffu, qq, off);
        }
      }
      if (tid % kWide < kU) {
        red[0][tid / kWide][u * kN + e] = a;
        red[1][tid / kWide][u * kN + e] = qq;
      }
    }
    __syncthreads();
    if (tid < 2 * kGroup) {
      const int mom = tid / kGroup, cc = tid % kGroup;
      const int c = q * kGroup + cc;
      if (c < C) {
        float t = red[mom][0][cc];
        for (int j = 1; j < kParts; ++j) t += red[mom][j][cc];
        parts[(k * 2 + mom) * C + c] = t;
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + q, 1u) == ch.count - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      finish_group(parts, C, q, ch.count, tickets + q, out, fin);
      __syncthreads();
    }
  }
}

template <bool kGrad, typename T, bool kVector, bool kRows>
int launch_path(int device, const T* g, const T* x, const float* mean,
                const float* inv, int C, long long B, long long S,
                Strides lx, Strides lg, Chunks ch, float* parts,
                unsigned int* ticket, float* out, cudaStream_t stream) {
  static ResidentCache cache;
  auto kernel = kRows ? rows_kernel<kGrad, T, kVector>
                      : planes_kernel<kGrad, T>;
  const int cap = cache.get(kernel, device, kThreads);
  if (cap <= 0) {
    const int err = static_cast<int>(cudaGetLastError());
    return err ? err : static_cast<int>(cudaErrorUnknown);
  }
  const long long items = kRows
      ? ch.count * ((C + kGroup - 1) / kGroup)
      : ((long long)C * ch.count + kWarps - 1) / kWarps;
  const unsigned int blocks = (unsigned int)(items < cap ? items : cap);
  kernel<<<blocks, kThreads, 0, stream>>>(x, g, mean, inv, C, B, S, lx, lg,
                                          ch, parts, ticket, out);
  return end_launch();
}

template <bool kGrad, typename T>
int launch_moments(int device, const T* g, const T* x, const float* mean,
                   const float* inv, long long rows, int C, long long S,
                   Strides lx, Strides lg, int path, Chunks ch, float* parts,
                   unsigned int* ticket, float* out, cudaStream_t stream) {
  if (rows <= 0 || C <= 0 || S <= 0 || ch.count <= 0) return 0;
  if (kGrad && (g == nullptr || mean == nullptr || inv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long B = rows / S;
  switch (path) {
    case kPlanes:
      return launch_path<kGrad, T, false, false>(
          device, g, x, mean, inv, C, B, S, lx, lg, ch, parts, ticket, out,
          stream);
    case kRowsScalar:
      return launch_path<kGrad, T, false, true>(
          device, g, x, mean, inv, C, B, S, lx, lg, ch, parts, ticket, out,
          stream);
    case kRowsVector:
      if (C % Word<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
      return launch_path<kGrad, T, true, true>(
          device, g, x, mean, inv, C, B, S, lx, lg, ch, parts, ticket, out,
          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (2, C): out[0] = sum x, out[1] = sum x^2.  x: rows = B * S rows of C
// channels at (sb, ss, sc); path and chunks (planes, splits, span, count)
// from ops/bn.py::kernel_plan; parts 2 * C * count f32 scratch; ticket
// zeroed uint32s kept for the stream, one a group of 64 channels; bf16: x
// is bf16 (else f32).
KERNEL_API int bn_moments_launch(int device, const void* x, long long rows,
                                 int C, long long S, long long sb,
                                 long long ss, long long sc, int path,
                                 long long planes, long long splits,
                                 long long span, long long count,
                                 float* parts, unsigned int* ticket,
                                 float* out, int bf16, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  const Strides lx{sb, ss, sc};
  const Chunks ch{planes, splits, span, count};
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_moments<false, T>(device, nullptr,
                                    static_cast<const T*>(x), nullptr,
                                    nullptr, rows, C, S, lx, lx, path, ch,
                                    parts, ticket, out, stream);
  }
  return launch_moments<false, float>(device, nullptr,
                                      static_cast<const float*>(x), nullptr,
                                      nullptr, rows, C, S, lx, lx, path, ch,
                                      parts, ticket, out, stream);
}

// out (2, C): out[0] = sum g, out[1] = sum g * (x - mean) * inv; g and x
// split into the same planes of S rows, each with its own strides; bf16: g
// and x are bf16 (else f32).
KERNEL_API int bn_grad_moments_launch(
    int device, const void* g, const void* x, const float* mean,
    const float* inv, long long rows, int C, long long S, long long sbx,
    long long ssx, long long scx, long long sbg, long long ssg, long long scg,
    int path, long long planes, long long splits, long long span,
    long long count, float* parts, unsigned int* ticket, float* out,
    int bf16, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  const Strides lx{sbx, ssx, scx}, lg{sbg, ssg, scg};
  const Chunks ch{planes, splits, span, count};
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_moments<true, T>(device, static_cast<const T*>(g),
                                   static_cast<const T*>(x), mean, inv, rows,
                                   C, S, lx, lg, path, ch, parts, ticket, out,
                                   stream);
  }
  return launch_moments<true, float>(device, static_cast<const float*>(g),
                                     static_cast<const float*>(x), mean, inv,
                                     rows, C, S, lx, lg, path, ch, parts,
                                     ticket, out, stream);
}
