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
// and the loss math is written once as a template on the scalar type:
//   * forward: one thread per anchor, float; the sum is two-level with no
//     atomics (a fixed grid of blocks, each a fixed-order tree, then one
//     block over the partials in order), so repeated runs give bitwise
//     equal sums;
//   * backward: one thread per anchor writes the zero gradient row of an
//     unweighted anchor; the warp then shares out its weighted anchors, 4 at
//     a time, so lane 7 * s + k runs component k of the s-th: a forward-mode
//     dual number (value, one tangent along pred component k).  The d(pred)
//     row needs no hand-derived formulas, and the 7 passes of a weighted
//     anchor run side by side instead of one after another in one thread.
// The dual rules match JAX's: clip gives 0 gradient outside its range and
// splits 0.5 / 0.5 at a bound (jnp.clip is maximum then minimum), maximum /
// minimum split 0.5 / 0.5 on ties, rows with weight <= 0 get 0.
//
// Each thread reads its anchor's weight first and reads the rest only where
// the anchor contributes: 7 pred, 7 target and 7 anchor floats where w > 0
// (the backward's 7 lanes of that anchor read them from the same lines),
// the target and anchor where w < 0 (pred replaced by the target), nothing
// where w == 0 (its term w * loss(t, t) is 0 for any finite target, and its
// gradient is 0).  Dense targets weight a few hundred of ~1.3M anchors, so
// the forward reads little more than w and the backward writes the A*7
// gradient floats of every row.
// Built with --fmad=false: the KL terms subtract values near 1.5 and the
// distances go through sqrt near 0, so products must round as in the plain
// PyTorch version.
#include <math.h>

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

__global__ void gd_loss_fwd_kernel(const float* __restrict__ pred,
                                   long long pred_row_stride,
                                   const float* __restrict__ tgt,
                                   const float* __restrict__ w,
                                   const float* __restrict__ anc,
                                   long long n, int A, int HW, Config cfg,
                                   float* __restrict__ parts) {
  __shared__ float red[kThreads];
  float acc = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float wi = w[i];
    if (wi == 0.f) continue;
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
    acc += gd_distance(gp, gt, cfg) * wi;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) parts[blockIdx.x] = red[0];
}

__global__ void sum_parts_kernel(const float* __restrict__ parts, int P,
                                 float* __restrict__ out) {
  __shared__ float red[kThreads];
  float acc = 0.f;
  for (int p = threadIdx.x; p < P; p += kThreads) acc += parts[p];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
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

__global__ void gd_loss_bwd_kernel(const float* __restrict__ gout,
                                   const float* __restrict__ pred,
                                   long long pred_row_stride,
                                   const float* __restrict__ tgt,
                                   const float* __restrict__ w,
                                   const float* __restrict__ anc,
                                   long long n, int A, int HW, Config cfg,
                                   float* __restrict__ dpred) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool weighted = i < n && w[i] > 0.f;
  if (i < n && !weighted) {  // pred replaced by the target: no gradient
    float* out = dpred + i * 7;
#pragma unroll
    for (int k = 0; k < 7; ++k) out[k] = 0.f;
  }
  // every lane reaches the ballot (no early return above)
  unsigned todo = __ballot_sync(0xffffffffu, weighted);
  const int slot = lane / 7, k = lane - 7 * slot;
  while (todo) {  // the same on every lane
    unsigned rest = todo;
    int src = -1;
    for (int s = 0; s < kPerRound && rest; ++s) {
      if (s == slot) src = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    if (src >= 0) {
      long long ia = i - lane + src;
      dpred[ia * 7 + k] = grad_component(gout, pred, pred_row_stride, tgt, w,
                                         anc, ia, k, A, HW, cfg);
    }
    todo = rest;
  }
}

}  // namespace

// out[0] = sum over anchors of loss * w.  pred rows have stride
// pred_row_stride floats (the conv output's channel count); tgt (M, A*7)
// and w (M, A) are contiguous; anc (HW, A*7).  The first pass runs P
// blocks (chosen by the caller from the shape alone) into parts (P,).
KERNEL_API int gd_loss_fwd_launch(int device, const float* pred,
                                  long long pred_row_stride, const float* tgt,
                                  const float* w, const float* anc,
                                  long long M, int A, int HW, int loss_type,
                                  int fun, float tau, float alpha,
                                  float off0, float off1, float off2,
                                  float* parts, int P, float* out,
                                  cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long n = M * A;
  Config cfg{loss_type, fun, tau, alpha, off0, off1, off2};
  gd_loss_fwd_kernel<<<P, kThreads, 0, stream>>>(pred, pred_row_stride, tgt,
                                                  w, anc, n, A, HW, cfg,
                                                  parts);
  sum_parts_kernel<<<1, kThreads, 0, stream>>>(parts, P, out);
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
  long long n = M * A;
  if (n == 0) return 0;
  Config cfg{loss_type, fun, tau, alpha, off0, off1, off2};
  gd_loss_bwd_kernel<<<blocks_for(n, kThreads), kThreads, 0, stream>>>(
      gout, pred, pred_row_stride, tgt, w, anc, n, A, HW, cfg, dpred);
  return end_launch();
}
