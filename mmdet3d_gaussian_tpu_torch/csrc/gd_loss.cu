// Fused anchor-head Gaussian-distance loss: decode, distance, postprocess,
// weighted sum (forward) and d(loss)/d(pred) in the conv layout (backward).
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/gd_loss_kernel.py::
// anchor_gd_loss_pallas (_fwd_kernel / _bwd_kernel around _block_loss).
// Per anchor (row m of M = B*H*W, anchor a of A): decode the 7 pred and the
// 7 target deltas against the anchor (DeltaXYZWLHRBBoxCoder.decode_parts),
// replace pred by target where the weight is <= 0, take the Gaussian
// distance of models/losses/gaussian.py for the configured loss type, fun,
// tau and alpha, and sum loss * weight.  Anchor rows repeat per sample
// (row m uses anchor row m % HW).
//
// The TPU kernel aligns the 7 components of each anchor with lane rolls and
// traces jax.grad of the block function inside a second kernel.  Here a
// thread reads an anchor's 7 components itself, so nothing needs aligning,
// and the loss math is written once as a template on the scalar type.
//
// Bound on an H100: bytes.  Dense targets weight ~100 of ~1.3M anchors, so
// the forward needs the 5.1 MB of weights and little more (1.5 us at
// 3.35 TB/s, below a launch), and the backward writes the 36 MB of
// d(pred), almost all zeros (11 us).  So only memory is designed for:
//   * forward, one launch: blocks run grid-stride over w in float4s, four
//     loads in flight a thread, and share the few weighted anchors out one
//     a thread (a block-wide prefix count lists them in order); each
//     block's fixed-order tree goes to a partial, and the block drawing the
//     last integer ticket adds the partials in order (no float atomics:
//     repeated runs give bitwise equal sums);
//   * backward: one wave of blocks, each owning an even span of rows of
//     d(pred): it reads its rows' weights (float4s) and lists and marks
//     its anchors with weight > 0 in shared memory; its first warps run
//     them 4 at a time a warp, lane 7 * s + k computing component k of the
//     s-th: a forward-mode dual number (value, one tangent along pred
//     component k), while its other warps fill the rest of the rows with
//     zeros in 16-byte evict-first stores that skip the marked anchors'
//     floats, so no row is written twice and the dual pass hides under the
//     fill.  The d(pred) row needs no hand-derived formulas, and the 7
//     passes of a weighted anchor run side by side.
// The dual rules match JAX's: clip gives 0 gradient outside its range and
// splits 0.5 / 0.5 at a bound (jnp.clip is maximum then minimum), maximum /
// minimum split 0.5 / 0.5 on ties, rows with weight <= 0 get 0.
//
// An anchor's pred, target and anchor floats are read only where it
// contributes: all 21 where w > 0 (the backward's 7 lanes of that anchor
// read them from the same lines), the target and anchor where w < 0 (pred
// replaced by the target), nothing where w == 0 (its term w * loss(t, t)
// is 0 for any finite target, and its gradient is 0).
// Built with --fmad=false: the KL terms subtract values near 1.5 and the
// distances go through sqrt near 0, so products must round as in the plain
// PyTorch version.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum LossType { GWD = 0, KLD = 1, JD = 2, KLD_SYMMAX = 3, KLD_SYMMIN = 4,
                BD = 5, KFIOU = 6 };
enum Fun { F_NONE = 0, F_LOG1P = 1, F_EXPM1 = 2, F_NLOG = 3 };

// ---- forward-mode dual number --------------------------------------------
struct D {
  float v, d;
};
__device__ __forceinline__ D operator+(D a, D b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ D operator-(D a, D b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ D operator*(D a, D b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ D operator/(D a, D b) {
  float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ D operator+(D a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ D operator+(float a, D b) { return {a + b.v, b.d}; }
__device__ __forceinline__ D operator-(D a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ D operator-(float a, D b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ D operator-(D a) { return {-a.v, -a.d}; }
__device__ __forceinline__ D operator*(D a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ D operator*(float a, D b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ D operator/(D a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ D operator/(float a, D b) {
  float q = a / b.v;
  return {q, -q * b.d / b.v};
}

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ float expm1_(float x) { return expm1f(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float max_(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float min_(float a, float b) { return a < b ? a : b; }

__device__ __forceinline__ D sqrt_(D x) {
  float r = sqrtf(x.v);
  return {r, x.d / (2.f * r)};
}
__device__ __forceinline__ D log_(D x) { return {logf(x.v), x.d / x.v}; }
__device__ __forceinline__ D log1p_(D x) {
  return {log1pf(x.v), x.d / (1.f + x.v)};
}
__device__ __forceinline__ D expm1_(D x) {
  return {expm1f(x.v), x.d * expf(x.v)};
}
__device__ __forceinline__ D exp_(D x) {
  float e = expf(x.v);
  return {e, x.d * e};
}
__device__ __forceinline__ D cos_(D x) { return {cosf(x.v), -x.d * sinf(x.v)}; }
__device__ __forceinline__ D sin_(D x) { return {sinf(x.v), x.d * cosf(x.v)}; }
// jnp.maximum / jnp.minimum: the gradient is split evenly on a tie
__device__ __forceinline__ D max_(D a, D b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  return {a.v, 0.5f * (a.d + b.d)};
}
__device__ __forceinline__ D min_(D a, D b) {
  if (a.v < b.v) return a;
  if (a.v > b.v) return b;
  return {a.v, 0.5f * (a.d + b.d)};
}
__device__ __forceinline__ D max_(D a, float b) { return max_(a, D{b, 0.f}); }
__device__ __forceinline__ D min_(D a, float b) { return min_(a, D{b, 0.f}); }

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

template <typename T>
__device__ __forceinline__ T clip_lo(T x, float lo) { return max_(x, lo); }

template <typename T>
__device__ __forceinline__ T clip(T x, float lo, float hi) {
  return min_(max_(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) { return sqrt_(clip_lo(x, 1e-9f)); }

// ---- models/losses/gaussian.py -------------------------------------------
template <typename T>
struct Gauss {
  T x, y, z, c, s, a, b, sl;
};

struct Config {
  int loss_type, fun;
  float tau, alpha, off0, off1, off2;
};

template <typename T>
__device__ __forceinline__ Gauss<T> gaussian_params(const T* box,
                                                    const Config& cfg) {
  Gauss<T> g;
  g.x = box[0] + cfg.off0 * box[3];
  g.y = box[1] + cfg.off1 * box[4];
  g.z = box[2] + cfg.off2 * box[5];
  g.c = cos_(box[6]);
  g.s = sin_(box[6]);
  g.a = 0.5f * clip(box[3], 1e-7f, 1e7f);
  g.b = 0.5f * clip(box[4], 1e-7f, 1e7f);
  g.sl = 0.5f * clip(box[5], 1e-7f, 1e7f);
  return g;
}

template <typename T>
__device__ __forceinline__ void sigma_bev(const Gauss<T>& g, T& s00, T& s01,
                                          T& s11) {
  T a2 = sq(g.a), b2 = sq(g.b);
  s00 = a2 * g.c * g.c + b2 * g.s * g.s;
  s11 = a2 * g.s * g.s + b2 * g.c * g.c;
  s01 = (a2 - b2) * g.c * g.s;
}

template <typename T>
__device__ __forceinline__ void sigma_bev_inv(const Gauss<T>& g, T& i00,
                                              T& i01, T& i11) {
  T ia2 = 1.0f / sq(g.a), ib2 = 1.0f / sq(g.b);
  i00 = ia2 * g.c * g.c + ib2 * g.s * g.s;
  i11 = ia2 * g.s * g.s + ib2 * g.c * g.c;
  i01 = (ia2 - ib2) * g.c * g.s;
}

template <typename T>
__device__ __forceinline__ T postprocess(T d, int fun, float tau) {
  if (fun == F_LOG1P) d = log1p_(d);
  else if (fun == F_EXPM1) d = expm1_(d);
  else if (fun == F_NLOG) d = -log_(1.0f - d + 1e-7f);
  if (tau >= 1.0f) return 1.0f - tau / (tau + d);
  return d;
}

template <typename T>
__device__ T gwd3d(const Gauss<T>& p, const Gauss<T>& t, float alpha) {
  T xyz = sq(p.x - t.x) + sq(p.y - t.y) + sq(p.z - t.z);
  T p00, p01, p11, t00, t01, t11;
  sigma_bev(p, p00, p01, p11);
  sigma_bev(t, t00, t01, t11);
  T tr_pt = p00 * t00 + 2.0f * p01 * t01 + p11 * t11;
  T det_sqrt = p.a * p.b * t.a * t.b;
  T whlr = sq(p.a) + sq(p.b) + sq(t.a) + sq(t.b)
      - 2.0f * safe_sqrt(tr_pt + 2.0f * det_sqrt) + sq(p.sl - t.sl);
  T dist = safe_sqrt(xyz + alpha * alpha * whlr);
  T logsum = log_(det_sqrt) + log_(p.sl) + log_(t.sl);
  return dist / (2.0f * exp_(logsum / 6.0f));
}

template <typename T>
__device__ T kld3d(const Gauss<T>& p, const Gauss<T>& t, float alpha,
                   bool root) {
  T i00, i01, i11, t00, t01, t11;
  sigma_bev_inv(p, i00, i01, i11);
  sigma_bev(t, t00, t01, t11);
  T dx = p.x - t.x, dy = p.y - t.y, dz = p.z - t.z;
  T isl2 = 1.0f / sq(p.sl);
  T xyz = 0.5f * (i00 * dx * dx + 2.0f * i01 * dx * dy + i11 * dy * dy);
  xyz = xyz + 0.5f * dz * dz * isl2;
  T whlr = 0.5f * (i00 * t00 + 2.0f * i01 * t01 + i11 * t11);
  whlr = whlr + 0.5f * isl2 * sq(t.sl);
  T ldp = log_(p.a) + log_(p.b) + log_(p.sl);
  T ldt = log_(t.a) + log_(t.b) + log_(t.sl);
  whlr = whlr + (ldp - ldt) - 1.5f;
  T dist = xyz / (alpha * alpha) + whlr;
  return root ? safe_sqrt(dist) : dist;
}

template <typename T>
__device__ T bd3d(const Gauss<T>& p, const Gauss<T>& t, float alpha) {
  T p00, p01, p11, t00, t01, t11;
  sigma_bev(p, p00, p01, p11);
  sigma_bev(t, t00, t01, t11);
  T m00 = 0.5f * (p00 + t00), m01 = 0.5f * (p01 + t01);
  T m11 = 0.5f * (p11 + t11);
  T ml = 0.5f * (sq(p.sl) + sq(t.sl));
  T det = clip_lo(m00 * m11 - m01 * m01, 1e-7f);
  T inv_det = 1.0f / det;
  T dx = p.x - t.x, dy = p.y - t.y, dz = p.z - t.z;
  T quad = (m11 * dx * dx - 2.0f * m01 * dx * dy + m00 * dy * dy) * inv_det;
  T xyz = 0.125f * quad + 0.125f * dz * dz / ml;
  T whlr = 0.5f * (log_(det) + log_(ml));
  whlr = whlr - 0.25f * (log_(sq(p.a)) + log_(sq(p.b)) + log_(sq(p.sl)));
  whlr = whlr - 0.25f * (log_(sq(t.a)) + log_(sq(t.b)) + log_(sq(t.sl)));
  return safe_sqrt(xyz / (alpha * alpha) + whlr);
}

template <typename T>
__device__ T kfiou3d(const Gauss<T>& p, const Gauss<T>& t) {
  T p00, p01, p11, t00, t01, t11;
  sigma_bev(p, p00, p01, p11);
  sigma_bev(t, t00, t01, t11);
  T s00 = p00 + t00, s01 = p01 + t01, s11 = p11 + t11;
  T det = (s00 * s11 - s01 * s01) * (sq(p.sl) + sq(t.sl));
  T vol_p = p.a * p.b * p.sl;
  T vol_t = t.a * t.b * t.sl;
  T inter = vol_p * vol_t / sqrt_(clip_lo(det, 1e-7f));
  T uni = clip_lo(vol_p + vol_t - inter, 1e-7f);
  return 1.0f - 4.656854249492381f * (inter / uni);
}

// BAG_GD_LOSS[loss_type](gp, gt, fun, tau, alpha) with the defaults GDLoss
// uses (sqrt=True, normalize=True)
template <typename T>
__device__ T gd_distance(const Gauss<T>& p, const Gauss<T>& t,
                         const Config& cfg) {
  switch (cfg.loss_type) {
    case GWD:
      return postprocess(gwd3d(p, t, cfg.alpha), cfg.fun, cfg.tau);
    case KLD:
      return postprocess(kld3d(p, t, cfg.alpha, true), cfg.fun, cfg.tau);
    case JD: {
      T jd = 0.5f * (kld3d(p, t, cfg.alpha, false)
                     + kld3d(t, p, cfg.alpha, false));
      return postprocess(safe_sqrt(jd), cfg.fun, cfg.tau);
    }
    case KLD_SYMMAX:
      return postprocess(max_(kld3d(p, t, cfg.alpha, true),
                              kld3d(t, p, cfg.alpha, true)),
                         cfg.fun, cfg.tau);
    case KLD_SYMMIN:
      return postprocess(min_(kld3d(p, t, cfg.alpha, true),
                              kld3d(t, p, cfg.alpha, true)),
                         cfg.fun, cfg.tau);
    case BD:
      return postprocess(bd3d(p, t, cfg.alpha), cfg.fun, cfg.tau);
    default:
      return postprocess(kfiou3d(p, t), cfg.fun, 0.0f);
  }
}

// core/bbox/coders.py::DeltaXYZWLHRBBoxCoder.decode_parts
template <typename T>
__device__ __forceinline__ void decode(const float* anc, const T* delta,
                                       T* box) {
  float za = anc[2] + anc[5] / 2.0f;
  float diag = sqrtf(anc[4] * anc[4] + anc[3] * anc[3]);
  T lg = exp_(delta[4]) * anc[4];
  T wg = exp_(delta[3]) * anc[3];
  T hg = exp_(delta[5]) * anc[5];
  box[0] = delta[0] * diag + anc[0];
  box[1] = delta[1] * diag + anc[1];
  box[2] = delta[2] * anc[5] + za - hg / 2.0f;
  box[3] = wg;
  box[4] = lg;
  box[5] = hg;
  box[6] = delta[6] + anc[6];
}

// Where flat anchor i (row m = i / A of M = B*HW, anchor a = i % A) keeps
// its 7 pred, 7 target and 7 anchor floats
struct Where {
  const float* pred;
  const float* tgt;
  const float* anc;
};

__device__ __forceinline__ Where locate(const float* __restrict__ pred,
                                        long long pred_row_stride,
                                        const float* __restrict__ tgt,
                                        const float* __restrict__ anc,
                                        long long i, int A, int HW) {
  long long m = i / A;
  int a = (int)(i - m * A);
  return {pred + m * pred_row_stride + a * 7, tgt + i * 7,
          anc + ((m % HW) * A + a) * 7};
}

__device__ __forceinline__ void load7(const float* __restrict__ src,
                                      float* dst) {
#pragma unroll
  for (int k = 0; k < 7; ++k) dst[k] = src[k];
}

// loss * w of flat anchor i, whose weight w is not 0
__device__ __forceinline__ float anchor_term(
    const float* __restrict__ pred, long long pred_row_stride,
    const float* __restrict__ tgt, const float* __restrict__ anc,
    long long i, float wi, int A, int HW, const Config& cfg) {
  Where at = locate(pred, pred_row_stride, tgt, anc, i, A, HW);
  float av[7], tv[7], bp[7], bt[7];
  load7(at.anc, av);
  load7(at.tgt, tv);
  decode(av, tv, bt);
  if (wi > 0.f) {
    float pv[7];
    load7(at.pred, pv);
    decode(av, pv, bp);
  } else {
#pragma unroll
    for (int k = 0; k < 7; ++k) bp[k] = bt[k];
  }
  Gauss<float> gp = gaussian_params(bp, cfg);
  Gauss<float> gt = gaussian_params(bt, cfg);
  return gd_distance(gp, gt, cfg) * wi;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int kQuadsInFlight = 4;  // float4 loads of w a thread issues at once
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The exclusive prefix sum of x over the block in thread order, and the
// block's total.  Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int x, int* warp_sums,
                                         int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_sums[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + inc - x;
}

// The sum of x over the block in a fixed order: a shuffle tree in each
// warp, then one over the warps' sums.  Every thread of the block must
// call it; thread 0 gets the sum.
__device__ __forceinline__ float block_sum(float x, float* warp_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  if (lane == 0) warp_part[warp] = x;
  __syncthreads();
  x = lane < kWarps ? warp_part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One launch: the blocks run grid-stride over w in float4s, four loads in
// flight a thread.  The anchors of a round's quads whose weight is not 0
// (few, and clustered around the boxes) are listed in shared memory in
// thread order, by a block-wide prefix count, and shared out one a thread,
// so no thread computes the terms of a cluster one after another.  Each
// thread adds its terms in list order, a fixed tree sums the block into
// its partial, and the block drawing the last integer ticket adds the P
// partials in order into out[0] and resets the ticket.  The grid depends
// on the shape alone, so repeated calls give bitwise equal sums.  The at
// most 3 + 3 anchors of w's unaligned head and tail are block 0's.
__global__ void __launch_bounds__(kThreads) gd_loss_fwd_kernel(
    const float* __restrict__ pred, long long pred_row_stride,
    const float* __restrict__ tgt, const float* __restrict__ w,
    const float* __restrict__ anc, long long n, int A, int HW, Config cfg,
    float* __restrict__ parts, unsigned int* ticket,
    float* __restrict__ out) {
  __shared__ float red[kWarps];
  __shared__ int warp_sums[kWarps];
  __shared__ long long list_i[kThreads];
  __shared__ float list_w[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long head =
      min(n, (long long)(((16 - (reinterpret_cast<uintptr_t>(w) & 15)) & 15)
                         / 4));
  const long long n4 = (n - head) / 4, tail = head + 4 * n4;
  const float4* __restrict__ w4 = reinterpret_cast<const float4*>(w + head);
  const long long stride = (long long)gridDim.x * kThreads;
  float acc = 0.f;
  if (blockIdx.x == 0 && tid < head + (n - tail)) {
    const long long i = tid < head ? tid : tail + (tid - head);
    const float wi = w[i];
    if (wi != 0.f)
      acc += anchor_term(pred, pred_row_stride, tgt, anc, i, wi, A, HW, cfg);
  }
  // the loop bounds are the same on every thread of the block (barriers)
  for (long long base = (long long)blockIdx.x * kThreads; base < n4;
       base += kQuadsInFlight * stride) {
    const long long q0 = base + tid;
    float4 v[kQuadsInFlight];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u) {
      const long long q = q0 + u * stride;
      v[u] = q < n4 ? __ldcs(w4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u)
      cnt += (v[u].x != 0.f) + (v[u].y != 0.f) + (v[u].z != 0.f)
             + (v[u].w != 0.f);
    int total;
    const int first = block_scan(cnt, warp_sums, total);
    for (int c0 = 0; c0 < total; c0 += kThreads) {
      if (cnt) {
        int pos = first;
#pragma unroll
        for (int u = 0; u < kQuadsInFlight; ++u) {
          const float wq[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
          const long long i = head + 4 * (q0 + u * stride);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (wq[e] == 0.f) continue;
            if (pos >= c0 && pos < c0 + kThreads) {
              list_i[pos - c0] = i + e;
              list_w[pos - c0] = wq[e];
            }
            ++pos;
          }
        }
      }
      __syncthreads();
      if (c0 + tid < total)
        acc += anchor_term(pred, pred_row_stride, tgt, anc, list_i[tid],
                           list_w[tid], A, HW, cfg);
      __syncthreads();
    }
  }
  acc = block_sum(acc, red);
  if (tid == 0) {
    parts[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int p = tid; p < (int)gridDim.x; p += kThreads)
    s += __ldcg(parts + p);
  s = block_sum(s, red);
  if (tid == 0) {
    out[0] = s;
    *ticket = 0u;
  }
}

// d(loss)/d(pred component k) of weighted anchor i, times gout * w
__device__ __forceinline__ float grad_component(
    const float* __restrict__ gout, const float* __restrict__ pred,
    long long pred_row_stride, const float* __restrict__ tgt,
    const float* __restrict__ w, const float* __restrict__ anc, long long i,
    int k, int A, int HW, const Config& cfg) {
  Where at = locate(pred, pred_row_stride, tgt, anc, i, A, HW);
  float av[7];
  D tv[7], pv[7], bt[7], bp[7];
  load7(at.anc, av);
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    tv[j] = D{at.tgt[j], 0.f};
    pv[j] = D{at.pred[j], j == k ? 1.f : 0.f};
  }
  decode(av, tv, bt);
  decode(av, pv, bp);
  Gauss<D> gt = gaussian_params(bt, cfg);
  Gauss<D> gp = gaussian_params(bp, cfg);
  return gd_distance(gp, gt, cfg).d * (gout[0] * w[i]);
}

constexpr int kPerRound = 4;  // weighted anchors a warp runs at once (x 7 lanes)
// the most anchors a block owns: kQuadsInFlight weight quads a thread
constexpr int kSpan = 4 * kQuadsInFlight * kThreads;

// One wave of blocks: block b owns rows [rpb b, rpb b + rpb) of the
// contiguous (M, A*7) d(pred) (rpb even, so a span starts 16-byte aligned
// where d(pred) does; rpb * A <= kSpan).  It loads its span's weights (a
// float4 a quad where w is 16-byte aligned there), lists the anchors with
// weight > 0 in shared memory and marks them in a bit set.  Then its first
// warps run the listed anchors 4 at a time a warp, lane 7 * s + k
// computing component k of the s-th (a forward-mode dual number) and
// writing it, while the other warps fill the span with zeros in 16-byte
// evict-first stores, skipping the floats of marked anchors.  No row is
// written twice, so the dual pass needs no barrier before or after the
// fill and its latency hides under it.
__global__ void __launch_bounds__(kThreads) gd_loss_bwd_kernel(
    const float* __restrict__ gout, const float* __restrict__ pred,
    long long pred_row_stride, const float* __restrict__ tgt,
    const float* __restrict__ w, const float* __restrict__ anc, long long M,
    int A, int HW, Config cfg, long long rpb, float* __restrict__ dpred) {
  __shared__ int list[kSpan];
  __shared__ unsigned marked[kSpan / 32];
  __shared__ int listed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(M, r0 + rpb);
  const long long a0 = r0 * A;           // the span's first anchor
  const int na = (int)((r1 - r0) * A);   // and its anchor count

  // this thread's weights (quads tid + 256 u of the span)
  const float* ws = w + a0;
  const bool vec = aligned16(ws);
  float wq[kQuadsInFlight][4];
#pragma unroll
  for (int u = 0; u < kQuadsInFlight; ++u) {
    const int i0 = 4 * (tid + u * kThreads);
    if (vec && i0 + 4 <= na) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(ws + i0));
      wq[u][0] = v.x; wq[u][1] = v.y; wq[u][2] = v.z; wq[u][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) wq[u][e] = i0 + e < na ? ws[i0 + e] : 0.f;
    }
  }
  for (int t = tid; t < kSpan / 32; t += kThreads) marked[t] = 0u;
  if (tid == 0) listed = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kQuadsInFlight; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (wq[u][e] > 0.f) {
        const int a = 4 * (tid + u * kThreads) + e;
        list[atomicAdd(&listed, 1)] = a;
        atomicOr(&marked[a >> 5], 1u << (a & 31));
      }
  __syncthreads();
  const int count = listed;

  // the weighted anchors' rows, on the first `busy` warps
  const int busy = min(kWarps, (count + kPerRound - 1) / kPerRound);
  const int slot = lane / 7, k = lane - 7 * slot;
  if (warp < busy)
    for (int e = warp * kPerRound + slot; e - slot < count;
         e += busy * kPerRound)
      if (slot < kPerRound && e < count) {
        const long long ia = a0 + list[e];
        dpred[ia * 7 + k] = grad_component(gout, pred, pred_row_stride, tgt,
                                           w, anc, ia, k, A, HW, cfg);
      }

  // zeros everywhere else, on the other warps (on all of them, after
  // their dual passes, when every warp has one): a warp's share of the
  // fill takes about the whole kernel, so a warp that ran a dual pass
  // first would finish its share late
  const int f0 = busy < kWarps ? 32 * busy : 0;
  if (tid < f0) return;
  const int ft = tid - f0, nf = kThreads - f0;
  float* p = dpred + a0 * 7;
  const long long len = (long long)na * 7;
  const int head = (int)min(
      len, (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15)
                       / 4));
  const int n4 = (int)((len - head) / 4), tail = head + 4 * n4;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  auto weighted = [&](int f) {  // float f of the span is anchor f / 7's
    const int a = f / 7;
    return (marked[a >> 5] >> (a & 31)) & 1u;
  };
  for (int q = ft; q < n4; q += nf) {
    const int f = head + 4 * q;
    if (count == 0 || !(weighted(f) | weighted(f + 3))) {
      __stcs(p4 + q, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!weighted(f + j)) p[f + j] = 0.f;
    }
  }
  if (ft < head && !(count && weighted(ft))) p[ft] = 0.f;
  if (ft < len - tail && !(count && weighted(tail + ft)))
    p[tail + ft] = 0.f;
}

}  // namespace

// out[0] = sum over anchors of loss * w.  pred rows have stride
// pred_row_stride floats (the conv output's channel count); tgt (M, A*7)
// and w (M, A) are contiguous; anc (HW, A*7).  P blocks (chosen by the
// caller from the shape alone) write their partial sums to parts (P,);
// ticket is a zeroed counter that the last block sets back to 0.
KERNEL_API int gd_loss_fwd_launch(int device, const float* pred,
                                  long long pred_row_stride, const float* tgt,
                                  const float* w, const float* anc,
                                  long long M, int A, int HW, int loss_type,
                                  int fun, float tau, float alpha,
                                  float off0, float off1, float off2,
                                  float* parts, int P, unsigned int* ticket,
                                  float* out, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long n = M * A;
  Config cfg{loss_type, fun, tau, alpha, off0, off1, off2};
  gd_loss_fwd_kernel<<<P, kThreads, 0, stream>>>(pred, pred_row_stride, tgt,
                                                  w, anc, n, A, HW, cfg,
                                                  parts, ticket, out);
  return end_launch();
}

// dpred (M, A*7) contiguous = gout[0] * d(sum loss * w) / d(pred).
KERNEL_API int gd_loss_bwd_launch(int device, const float* gout,
                                  const float* pred,
                                  long long pred_row_stride, const float* tgt,
                                  const float* w, const float* anc,
                                  long long M, int A, int HW, int loss_type,
                                  int fun, float tau, float alpha,
                                  float off0, float off1, float off2,
                                  float* dpred, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if (M * A == 0) return 0;
  Config cfg{loss_type, fun, tau, alpha, off0, off1, off2};
  // one wave: as many blocks as stay resident, an even number of rows
  // each, at most kSpan anchors a block
  if (2 * A > kSpan) return static_cast<int>(cudaErrorInvalidValue);
  static ResidentCache resident;
  const long long wave = resident.get(gd_loss_bwd_kernel, device, kThreads);
  const long long blocks = wave > 0 ? wave : 1024;
  long long rpb = (M + blocks - 1) / blocks;
  rpb += rpb & 1;
  rpb = min(rpb, (long long)(kSpan / A) & ~1LL);
  gd_loss_bwd_kernel<<<blocks_for(M, (int)rpb), kThreads, 0, stream>>>(
      gout, pred, pred_row_stride, tgt, w, anc, M, A, HW, cfg, rpb, dpred);
  return end_launch();
}
