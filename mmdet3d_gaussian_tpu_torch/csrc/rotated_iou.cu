// Pairwise rotated BEV IoU of P independent problems of K boxes each.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/rotated_iou_kernel.py::
// iou_bev_pallas (tile kernel _iou_tile_kernel).  Boxes are (cx, cy, w, h,
// yaw) rows of a (P, K, 5) f32 tensor; the output is (P, K, K) f32.  The
// algorithm is the TPU kernel's, step for step: 24 candidate vertices (4 + 4
// corners inside the other box, 16 edge intersections), centroid, ordering
// by the pseudo-angle sign(dy) * (1 - dx / (|dx| + |dy|)) with a stable
// odd-even transposition sort, invalid slots collapsed onto the first
// vertex, shoelace area, and the intersection clamped by both box areas.
//
// Bound on an H100: operations.  At predict time (12 problems of 1,024
// boxes) the kernel reads 0.25 MB and writes 50 MB, but does ~3,000 f32
// operations per pair (the 24-slot sort alone is ~2,000), ~38 G in all.  The
// function needs ~2,100 per pair (a 120-comparator 24-input sorting
// network), 26 G ops, ~0.79 ms at the 33.5 Tops/s non-FMA f32 rate.
// One thread computes one pair entirely in registers: the candidate arrays
// are indexed only by compile-time constants after full unrolling, so
// nothing spills to local memory and no intermediate reaches device memory;
// consecutive threads take consecutive columns, so the output stores
// coalesce.  Compiled with --fmad=false so each product and sum rounds as in
// the plain PyTorch version (no fused multiply-add).
#include "common.cuh"

namespace {

constexpr int kCand = 24;
constexpr float kBig = 1e9f;
constexpr int kThreads = 256;

struct Box {
  float cx, cy, w, h, c, s;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ b) {
  Box o;
  o.cx = b[0]; o.cy = b[1]; o.w = b[2]; o.h = b[3];
  o.c = cosf(b[4]); o.s = sinf(b[4]);
  return o;
}

__device__ __forceinline__ void corners(const Box& b, float* xs, float* ys) {
  float hw = 0.5f * b.w, hh = 0.5f * b.h;
  const float dx[4] = {-hw, hw, hw, -hw};
  const float dy[4] = {-hh, -hh, hh, hh};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xs[i] = b.cx + b.c * dx[i] - b.s * dy[i];
    ys[i] = b.cy + b.s * dx[i] + b.c * dy[i];
  }
}

__device__ __forceinline__ bool inside(float px, float py, const Box& b) {
  float dxv = px - b.cx, dyv = py - b.cy;
  float lx = b.c * dxv + b.s * dyv;
  float ly = -b.s * dxv + b.c * dyv;
  return (fabsf(lx) <= 0.5f * b.w + 1e-5f) && (fabsf(ly) <= 0.5f * b.h + 1e-5f);
}

__device__ __forceinline__ float pseudo_angle(float dx, float dy) {
  float denom = fabsf(dx) + fabsf(dy) + 1e-12f;
  float p = 1.0f - dx / denom;
  return dy >= 0.0f ? p : -p;
}

__device__ float pair_iou(const float* __restrict__ pa,
                          const float* __restrict__ pb) {
  Box a = load_box(pa), b = load_box(pb);
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);

  float vx[kCand], vy[kCand], key[kCand];
  bool ok[kCand];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vx[i] = ax[i]; vy[i] = ay[i]; ok[i] = inside(ax[i], ay[i], b);
    vx[4 + i] = bx[i]; vy[4 + i] = by[i]; ok[4 + i] = inside(bx[i], by[i], a);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float px = ax[i], py = ay[i];
    float rx = ax[(i + 1) % 4] - px, ry = ay[(i + 1) % 4] - py;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float qx = bx[j], qy = by[j];
      float sx = bx[(j + 1) % 4] - qx, sy = by[(j + 1) % 4] - qy;
      float rxs = rx * sy - ry * sx;
      bool par = fabsf(rxs) < 1e-8f;
      float safe = par ? 1.0f : rxs;
      float qpx = qx - px, qpy = qy - py;
      float t = (qpx * sy - qpy * sx) / safe;
      float u = (qpx * ry - qpy * rx) / safe;
      int k = 8 + 4 * i + j;
      ok[k] = !par && t >= -1e-6f && t <= 1.0f + 1e-6f && u >= -1e-6f
              && u <= 1.0f + 1e-6f;
      vx[k] = px + t * rx;
      vy[k] = py + t * ry;
    }
  }

  float nvalid = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    nvalid += ok[k] ? 1.0f : 0.0f;
    sx += ok[k] ? vx[k] : 0.0f;
    sy += ok[k] ? vy[k] : 0.0f;
  }
  float inv_n = 1.0f / fmaxf(nvalid, 1.0f);
  float ctr_x = sx * inv_n, ctr_y = sy * inv_n;
#pragma unroll
  for (int k = 0; k < kCand; ++k)
    key[k] = ok[k] ? pseudo_angle(vx[k] - ctr_x, vy[k] - ctr_y) : kBig;

  // stable odd-even transposition sort (invalid slots carry kBig -> last)
#pragma unroll
  for (int rnd = 0; rnd < kCand; ++rnd) {
#pragma unroll
    for (int i = rnd % 2; i < kCand - 1; i += 2) {
      bool swap = key[i] > key[i + 1];
      float k0 = key[i], k1 = key[i + 1];
      float x0 = vx[i], x1 = vx[i + 1];
      float y0 = vy[i], y1 = vy[i + 1];
      key[i] = swap ? k1 : k0; key[i + 1] = swap ? k0 : k1;
      vx[i] = swap ? x1 : x0; vx[i + 1] = swap ? x0 : x1;
      vy[i] = swap ? y1 : y0; vy[i + 1] = swap ? y0 : y1;
    }
  }

  float fx = vx[0], fy = vy[0];
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    bool v = key[k] < kBig;
    vx[k] = v ? vx[k] : fx;
    vy[k] = v ? vy[k] : fy;
  }
  float area2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    int n = (k + 1) % kCand;
    area2 = area2 + (vx[k] * vy[n] - vy[k] * vx[n]);
  }
  float inter = nvalid >= 3.0f ? 0.5f * fabsf(area2) : 0.0f;
  float area_a = a.w * a.h, area_b = b.w * b.h;
  inter = fminf(fminf(inter, area_a), area_b);
  return inter / fmaxf(area_a + area_b - inter, 1e-6f);
}

__global__ void rotated_iou_kernel(const float* __restrict__ boxes,
                                   float* __restrict__ out, int P, int K) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long kk = (long long)K * K;
  if (t >= (long long)P * kk) return;
  long long p = t / kk;
  long long rem = t - p * kk;
  int i = (int)(rem / K);
  int j = (int)(rem - (long long)i * K);
  const float* base = boxes + p * K * 5;
  out[t] = pair_iou(base + (long long)i * 5, base + (long long)j * 5);
}

}  // namespace

KERNEL_API int rotated_iou_launch(int device, const float* boxes, float* out,
                                  int P, int K, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  long long work = (long long)P * K * K;
  if (work == 0) return 0;
  rotated_iou_kernel<<<blocks_for(work, kThreads), kThreads, 0, stream>>>(
      boxes, out, P, K);
  return end_launch();
}
