// Pairwise rotated BEV IoU of P independent problems of K boxes each.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/rotated_iou_kernel.py::
// iou_bev_pallas (tile kernel _iou_tile_kernel).  Boxes are (cx, cy, w, h,
// yaw) rows of a (P, K, 5) f32 tensor; the output is (P, K, K) f32.  The
// algorithm of a pair is the TPU kernel's, step for step: 24 candidate
// vertices (4 + 4 corners inside the other box, 16 edge intersections),
// centroid, ordering by the pseudo-angle sign(dy) * (1 - dx / (|dx| + |dy|))
// with a stable odd-even transposition sort, invalid slots collapsed onto
// the first vertex, shoelace area, and the intersection clamped by both box
// areas.
//
// Bound on an H100: operations, but only for the pairs whose boxes can
// meet.  A pair costs ~3,000 f32 operations in full (the 24-slot sort alone
// is ~2,000; the function needs ~2,100 with a 120-comparator sorting
// network), but the NMS candidates of a predict (12 problems of 1,024 boxes
// a few metres across, on a 69 x 79 m range) overlap in a few per cent of
// the pairs, and a pair of boxes that cannot meet has IoU exactly 0.  So the
// work is the 50 MB output write (0.015 ms at 3.35 TB/s), a cheap test of
// every pair, and the full polygon of the near pairs only.
//
// Design.  A block owns a 64 x 128 tile of one problem's output (64 row
// boxes against 128 column boxes; 60 KB of shared memory):
//  1. It stages its 64 row and 128 column boxes into shared memory: centre,
//     size, cos, sin, the 4 corners, the area and the cull radius R, by the
//     same expressions the polygon used per pair before, so every bit of the
//     per-pair arithmetic is unchanged.
//  2. Every thread tests 32 pairs (one column box in registers, 32 rows).
//     A far pair (below) gets its value, that of an empty intersection, in
//     the shared output tile; a near pair is appended to a block-wide
//     queue: each warp gathers its near pairs with __ballot_sync and takes
//     one offset for all of them from a shared counter.
//  3. The block drains the queue one pair a thread through the polygon, so
//     the 24-candidate path runs in full warps instead of diverging across
//     far pairs.  (At the predict's near share, 2-3 %, a 64 x 64 tile
//     holds 80-120 near pairs, under half the block's threads; 64 x 128
//     fills about one round of 256.)
//  4. The tile leaves in 16-byte stores, a row of 128 floats by a warp
//     (4-byte stores where K is not a multiple of 4): every output element
//     is written once.
// Compiled with --fmad=false so each product and sum rounds as in the plain
// PyTorch version (no fused multiply-add).
//
// The cull, and why it is exact.  Pair (a, b) is far iff
//     d^2 > (R_a + R_b)^2  and  d^2 <= FLT_MAX,
// d^2 = (cx_a - cx_b)^2 + (cy_a - cy_b)^2 in f32, with
//     R = (1 + 2^-6) hd + 2^-10 + 2^-17 (|cx| + |cy|),  hd = sqrt(w^2 + h^2)/2,
// R = +inf for a thin box (0 < min(|w|, |h|) < 2^-10 hd + 2^-16 (|cx| +
// |cy|)) and R = NaN for a box with a non-finite field, so a NaN, inf or
// thin box is near every box (a compare with NaN is false).  A far pair
// takes inter = 0 through the same last two lines as the polygon: the clamp
// by both areas and the division, exactly 0 for sizes >= 0 and the plain
// version's value for a negative size (min(inter, area) = area for any
// inter >= 0 when area < 0).  u = 2^-24; H = hd_a + hd_b.
//  a. Far implies the real distance d > (R_a + R_b)(1 - 13u) (the f32
//     rounding of d^2, of R and of its square, at most 13 ulps relative).
//     The f32 corners lie within hd (1 + 1e-6) + 3u (|cx| + |cy| + 4 hd) of
//     their centre (|cos|, |sin| <= 1, cos^2 + sin^2 = 1 +- 1e-6 for cosf
//     and sinf within 2 ulps; 3 roundings a coordinate).  So every corner
//     of a lies more than hd_b (1 + 2^-6) + 2^-10 from b's centre, and the
//     gap G between the two f32 rectangles is at least 0.99 (2^-6 H +
//     2^-9), and at least d - H - 1e-6 H.
//  b. Corner of a inside b: the test rotates the corner's offset from b's
//     centre (norm kept to 1 +- 2e-6 with rounding) and compares with half
//     the sides plus 1e-5, so it passes only within hd_b (1 + 3e-6) + 2e-5
//     of b's centre: never, by (a).  The same holds for b's corners.
//  c. Edge p + t r of a against edge q + v s of b: rxs = r x s and the
//     numerators (q - p) x s and (q - p) x r are off by at most 3u |r||s|
//     and 4u |q - p||s| (4u |q - p||r|).  A candidate is valid only if t
//     and v lie in [-1e-6, 1 + 1e-6]; then X = p + t r is on a's edge and
//     within eta = 4.3u (|q - p| + |r|) of b's line.  Where the lines meet
//     at an angle whose sine exceeds Theta = 4.4u (2 + 6 H / G) <= 1.1e-4
//     (|q - p| <= G + 2H, |r| + |s| <= 2H), the same bounds put X within
//     G / 2 of b's edge: impossible.  So a valid edge candidate needs a
//     nearly collinear pair of edges, within angle Theta and distance eta.
//  d. Such pairs give at most 2 candidates, and a polygon needs 3 (nvalid
//     >= 3): (i) two adjacent edges of b nearly collinear with two (then
//     adjacent) edges of a put b's corner within sqrt(2) (eta + 2 hd_b
//     Theta) < G of a's corner, so only one family of parallel edges of b
//     takes part; (ii) of the box with the larger |cx| + |cy| + hd, two
//     parallel edges can both lie near one line only if its shorter side is
//     under 2 eta + 2 hd Theta, i.e. under 2^-10 hd + 2^-16 (|cx| + |cy|):
//     that box would be thin, and thin boxes are never far.  So each edge
//     of one family meets at most one edge of the other box: at most 2.
//     Edges of length 0 (a size 0) have rxs = 0 exactly and never count.
//  The margins cover the inside slack (1e-5 of a half-side), the t and v
//  slack (1e-6 of an edge) and the rounding of corners at the coordinates
//  that occur with room to spare; a larger margin costs time, never bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCand = 24;
constexpr float kBig = 1e9f;
constexpr int kRows = 64;                  // row boxes of a block's tile
constexpr int kCols = 128;                 // column boxes of a block's tile
constexpr int kThreads = 256;
constexpr int kPairs = kRows * kCols;
constexpr int kTestsPerThread = kPairs / kThreads;
static_assert(kThreads % kCols == 0, "a thread keeps one column");
// cull radius and thin test (ops/rotated_iou.py holds the same constants)
constexpr float kCullRel = 1.0f + 0x1p-6f;
constexpr float kCullAbs = 0x1p-10f;
constexpr float kCullPos = 0x1p-17f;
constexpr float kThinRel = 0x1p-10f;
constexpr float kThinPos = 0x1p-16f;

// fields of a staged box, one shared-memory row of a table each
enum Field { kCx, kCy, kW, kH, kC, kS, kX0, kY0 = kX0 + 4, kArea = kY0 + 4,
             kR, kFields };
// dynamic shared memory: the output tile, the row and column box tables
// and the queue of near pairs (tile positions), 60 KB
constexpr int kTileBytes = kPairs * 4;
constexpr int kRowTabBytes = kFields * kRows * 4;
constexpr int kColTabBytes = kFields * kCols * 4;
constexpr int kSmemBytes = kTileBytes + kRowTabBytes + kColTabBytes
                           + kPairs * 2;

struct Box {
  float cx, cy, w, h, c, s;
};

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

// IoU once the intersection area is known: clamped by both areas
__device__ __forceinline__ float iou_of(float inter, float area_a,
                                        float area_b) {
  inter = fminf(fminf(inter, area_a), area_b);
  return inter / fmaxf(area_a + area_b - inter, 1e-6f);
}

// Stage box `src` (5 floats) into column `col` of a table of kFields rows.
template <int W>
__device__ __forceinline__ void stage_box(const float* __restrict__ src,
                                          float (*tab)[W], int col) {
  float cx = src[0], cy = src[1], w = src[2], h = src[3], yaw = src[4];
  float c = cosf(yaw), s = sinf(yaw);
  float hw = 0.5f * w, hh = 0.5f * h;
  const float dx[4] = {-hw, hw, hw, -hw};
  const float dy[4] = {-hh, -hh, hh, hh};
  tab[kCx][col] = cx; tab[kCy][col] = cy; tab[kW][col] = w; tab[kH][col] = h;
  tab[kC][col] = c; tab[kS][col] = s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tab[kX0 + i][col] = cx + c * dx[i] - s * dy[i];
    tab[kY0 + i][col] = cy + s * dx[i] + c * dy[i];
  }
  tab[kArea][col] = w * h;
  float hd = 0.5f * sqrtf(w * w + h * h);
  float pos = fabsf(cx) + fabsf(cy);
  float r = hd * kCullRel + kCullAbs + kCullPos * pos;
  float side = fminf(fabsf(w), fabsf(h));
  if (side > 0.0f && side < hd * kThinRel + kThinPos * pos)
    r = __int_as_float(0x7f800000);                       // +inf
  bool finite = isfinite(cx) && isfinite(cy) && isfinite(w) && isfinite(h)
                && isfinite(yaw);
  tab[kR][col] = finite ? r : __int_as_float(0x7fffffff);  // NaN
}

template <int W>
__device__ __forceinline__ Box load_box(float (*tab)[W], int col,
                                        float* xs, float* ys) {
  Box o;
  o.cx = tab[kCx][col]; o.cy = tab[kCy][col];
  o.w = tab[kW][col]; o.h = tab[kH][col];
  o.c = tab[kC][col]; o.s = tab[kS][col];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xs[i] = tab[kX0 + i][col];
    ys[i] = tab[kY0 + i][col];
  }
  return o;
}

// The full polygon of one pair, from staged boxes and corners.
__device__ float pair_iou(const Box& a, const float* ax, const float* ay,
                          const Box& b, const float* bx, const float* by) {
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
  return iou_of(inter, a.w * a.h, b.w * b.h);
}

// 3 blocks an SM (80 registers, a few spilled to L1) rather than 2 at 112:
// the polygon's dependent chains need more warps to hide their latency.
__global__ void __launch_bounds__(kThreads, 3)
rotated_iou_kernel(const float* __restrict__ boxes, float* __restrict__ out,
                   int K, int row_tiles, int col_tiles, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = reinterpret_cast<float (*)[kCols]>(smem);
  auto rows = reinterpret_cast<float (*)[kRows]>(smem + kTileBytes);
  auto cols = reinterpret_cast<float (*)[kCols]>(smem + kTileBytes
                                                 + kRowTabBytes);
  auto queue = reinterpret_cast<unsigned short*>(
      smem + kTileBytes + kRowTabBytes + kColTabBytes);
  __shared__ int queued;

  const int tid = threadIdx.x, lane = tid & 31;
  const int per_problem = row_tiles * col_tiles;
  const long long p = blockIdx.x / per_problem;
  const int t = blockIdx.x - (int)(p * per_problem);
  const int r0 = (t / col_tiles) * kRows, c0 = (t % col_tiles) * kCols;
  const int nr = min(kRows, K - r0), nc = min(kCols, K - c0);
  const float* base = boxes + p * K * 5;

  for (int b = tid; b < kRows + kCols; b += kThreads) {   // 1. stage
    if (b < kRows) {
      if (b < nr) stage_box(base + (long long)(r0 + b) * 5, rows, b);
    } else if (b - kRows < nc) {
      stage_box(base + (long long)(c0 + b - kRows) * 5, cols, b - kRows);
    }
  }
  if (tid == 0) queued = 0;
  __syncthreads();

  // 2. cull, queue near pairs: a thread keeps one column box in registers
  // and walks down the rows (a warp: 32 neighbouring columns of one row)
  const int j = tid % kCols;
  const bool col_live = j < nc;
  const float bx = col_live ? cols[kCx][j] : 0.0f;
  const float by = col_live ? cols[kCy][j] : 0.0f;
  const float br = col_live ? cols[kR][j] : 0.0f;
  const float barea = col_live ? cols[kArea][j] : 0.0f;
#pragma unroll 4
  for (int m = 0; m < kTestsPerThread; ++m) {
    const int i = m * (kThreads / kCols) + tid / kCols;
    const int idx = i * kCols + j;
    bool near = false;
    if (col_live && i < nr) {
      const float dx = rows[kCx][i] - bx;
      const float dy = rows[kCy][i] - by;
      const float d2 = dx * dx + dy * dy;
      const float s = rows[kR][i] + br;
      near = !(d2 > s * s && d2 <= 3.402823466e38f);
      if (!near) {
        // an empty intersection: +0 for two positive areas, as iou_of
        // gives, but without its division, which doubles the cull's cost
        // (k5_phases.py --other on an H100 80GB HBM3 at 700 W: none near
        // 0.0720 ms with the division for every far pair, 0.0472 without)
        const float aa = rows[kArea][i];
        tile[i][j] = aa > 0.0f && barea > 0.0f ? 0.0f
                                               : iou_of(0.0f, aa, barea);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, near);
    if (mask) {                            // the same on every lane
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&queued, __popc(mask));
      slot = __shfl_sync(0xffffffffu, slot, 0);
      if (near)
        queue[slot + __popc(mask & ((1u << lane) - 1u))] =
            (unsigned short)idx;
    }
  }
  __syncthreads();

  const int n_near = queued;               // 3. near pairs in full warps
  for (int q = tid; q < n_near; q += kThreads) {
    const int idx = queue[q];
    const int i = idx / kCols, k = idx % kCols;
    float ax[4], ay[4], bx4[4], by4[4];
    const Box a = load_box(rows, i, ax, ay);
    const Box b = load_box(cols, k, bx4, by4);
    tile[i][k] = pair_iou(a, ax, ay, b, bx4, by4);
  }
  __syncthreads();

  float* dst = out + (p * K + r0) * (long long)K + c0;   // 4. store
  if (vec4) {
    constexpr int kVecs = kCols / 4;
    for (int v = tid; v < kRows * kVecs; v += kThreads) {
      const int i = v / kVecs, j = (v % kVecs) * 4;
      if (i < nr && j < nc)
        *reinterpret_cast<float4*>(dst + (long long)i * K + j) =
            *reinterpret_cast<const float4*>(&tile[i][j]);
    }
  } else {
    for (int e = tid; e < kPairs; e += kThreads) {
      const int i = e / kCols, j = e % kCols;
      if (i < nr && j < nc) dst[(long long)i * K + j] = tile[i][j];
    }
  }
}

// Devices whose kernel attribute allows kSmemBytes of dynamic shared memory.
std::atomic<bool> smem_ready[64];

}  // namespace

KERNEL_API int rotated_iou_launch(int device, const float* boxes, float* out,
                                  int P, int K, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if ((long long)P * K == 0) return 0;
  if (device < 0 || device >= 64 || !smem_ready[device].load()) {
    cudaError_t e = cudaFuncSetAttribute(
        rotated_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= 0 && device < 64) smem_ready[device].store(true);
  }
  const int row_tiles = (K + kRows - 1) / kRows;
  const int col_tiles = (K + kCols - 1) / kCols;
  const long long blocks = (long long)P * row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte stores need every row start 16-byte aligned
  const bool vec4 = K % 4 == 0
                    && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rotated_iou_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      boxes, out, K, row_tiles, col_tiles, vec4);
  return end_launch();
}
