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
// Bound on an H100: bytes.  The function reads only the strict upper
// triangle (j > i): 25 MB for the predict's 12 problems of 1,024, ~7.5 us
// of HBM time.  What held the first port back was not bytes but its K
// dependent steps, each a block barrier.  Two kernels, one launcher:
//
// 1. nms_pack_kernel, one warp per row (P * K warps): 16-byte loads of the
//    row's upper part, 128 columns a warp load; each lane's 4 "iou > thr"
//    bits meet in four warp OR-reductions, two 64-bit words a load (four
//    ballots spread to every 4th bit took 4x the instructions and left the
//    pack issue-bound).  Bit (j - 64 w) of word w of row i is set iff
//    j > i, j < K and iou[i, j] > thr.  Words are stored in a triangular
//    layout per problem: row block b (rows 64 b .. 64 b + 63) keeps words
//    b .. W-1 of each of its 64 rows, W = ceil(K / 64), so the workspace
//    holds 32 W (W + 1) words a problem and a stage of consecutive row
//    blocks is one contiguous copy.  Row i writes words (i + 1) / 64 ..
//    W-1: every word the sweep reads (the diagonal word of row 64 b + 63
//    has no bit and is never read).
// 2. nms_sweep_kernel, one block per problem.  `alive` (valid and not yet
//    suppressed) lives in warp 0's registers, lane l holding words l,
//    l + 32, ... (a template on the words a lane: 1, 4 or 12).  The block
//    copies as many row blocks of the triangle into shared memory as fit
//    (all 16 at K = 1,024: 68 KB; one or more at a time up to K = 24,576,
//    whose first row block is 192 KB), then warp 0 resolves them in order,
//    64 rows at a time: the lane holding word b walks rows 64 b + r in
//    registers (row r clears its diagonal word's later bits if its own bit
//    is still set), with no shuffle and no barrier; one __shfl_sync
//    broadcasts the block's final alive word, and every lane clears the
//    bits of the kept rows' masks in its later words.  Two block barriers
//    a stage, none a row.  What bounds it is the walk's dependent chain
//    (a test, a select and an AND a row, ~20 SM cycles) and one warp's
//    issue rate in the clears, not bytes.
#include <cstdint>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kPackWarps = 8;         // rows a pack block
constexpr int kSweepThreads = 256;    // stagers; warp 0 also sweeps
constexpr int kMaxLaneWords = 12;     // alive words a lane: W <= 384
constexpr int kWalkChunk = 16;        // rows' words loaded together
constexpr unsigned kChunkMask = (1u << kWalkChunk) - 1;
constexpr unsigned kFull = 0xffffffffu;

// first word of row block b in a problem's triangle (64 rows of W - b'
// words for every earlier block b')
__device__ __forceinline__ long long tri_offset(int b, int W) {
  return 64LL * ((long long)b * W - (long long)b * (b - 1) / 2);
}

// Columns 128 c + 4 lane .. + 3 of row i (vector: one 16-byte load).
template <bool kVec>
__device__ __forceinline__ void load_quad(const float* row, int c, int lane,
                                          int i, int K, float v[4]) {
  const int j0 = 128 * c + 4 * lane;
  if (kVec) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + 3 > i && j0 < K)
      q = *reinterpret_cast<const float4*>(row + j0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (j0 + e > i && j0 + e < K) ? row[j0 + e] : 0.f;
  }
}

// The two words of a 128-column chunk from lane-held quads.  Lane l holds
// columns 4 l .. 4 l + 3, so its 4 bits are a nibble at bit 4 (l mod 8) of
// 32-bit quarter l / 8 of the chunk; four warp OR-reductions (one
// instruction each) give the quarters, two of them a word.
__device__ __forceinline__ void pack_quad(const float v[4], int c, int lane,
                                          int i, int K, float thr, u64* lo,
                                          u64* hi) {
  const int j0 = 128 * c + 4 * lane;
  unsigned nib = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    nib |= (j > i && j < K && v[e] > thr) ? 1u << e : 0u;
  }
  const unsigned x = nib << (4 * (lane & 7));
  const int g = lane >> 3;
  unsigned q[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) q[h] = __reduce_or_sync(kFull, g == h ? x : 0u);
  *lo = q[0] | ((u64)q[1] << 32);
  *hi = q[2] | ((u64)q[3] << 32);
}

template <bool kVec>
__global__ void __launch_bounds__(kPackWarps * 32)
nms_pack_kernel(const float* __restrict__ iou, u64* __restrict__ words,
                int P, int K, int W, float thr) {
  const long long row_id = (long long)blockIdx.x * kPackWarps
                           + (threadIdx.x >> 5);
  if (row_id >= (long long)P * K) return;           // whole warps leave
  const int lane = threadIdx.x & 31;
  const long long p = row_id / K;
  const int i = static_cast<int>(row_id - p * K);
  const int b = i >> 6, r = i & 63;
  const int w0 = (i + 1) >> 6;                      // first word with j > i
  // word w of row i sits at out[w]
  u64* out = words + p * (32LL * W * (W + 1)) + tri_offset(b, W)
             + (long long)r * (W - b) - b;
  const float* row = iou + row_id * K;
  const int chunks = (K + 127) >> 7;
  int c = w0 >> 1;
  for (; c + 1 < chunks; c += 2) {                  // two loads in flight
    float v0[4], v1[4];
    load_quad<kVec>(row, c, lane, i, K, v0);
    load_quad<kVec>(row, c + 1, lane, i, K, v1);
    u64 lo0, hi0, lo1, hi1;
    pack_quad(v0, c, lane, i, K, thr, &lo0, &hi0);
    pack_quad(v1, c + 1, lane, i, K, thr, &lo1, &hi1);
    if (lane == 0 && 2 * c >= w0) out[2 * c] = lo0;
    if (lane == 1) out[2 * c + 1] = hi0;            // 2c + 1 >= w0
    if (lane == 2) out[2 * c + 2] = lo1;
    if (lane == 3 && 2 * c + 3 < W) out[2 * c + 3] = hi1;
  }
  if (c < chunks) {
    float v0[4];
    load_quad<kVec>(row, c, lane, i, K, v0);
    u64 lo0, hi0;
    pack_quad(v0, c, lane, i, K, thr, &lo0, &hi0);
    if (lane == 0 && 2 * c >= w0) out[2 * c] = lo0;
    if (lane == 1 && 2 * c + 1 < W) out[2 * c + 1] = hi0;
  }
}

// OR of col[r * stride] over the rows r < n (a multiple of kWalkChunk) whose
// bit is set in `bits`: 16 loads issued together, then predicated ORs.
__device__ __forceinline__ u64 kept_rows(const u64* col, int stride,
                                         unsigned bits, int n) {
  unsigned lo = 0, hi = 0;
#pragma unroll 1
  for (int r0 = 0; r0 < n; r0 += kWalkChunk) {
    const unsigned sel = (bits >> r0) & kChunkMask;
    if (sel == 0) continue;
    u64 x[kWalkChunk];
#pragma unroll
    for (int q = 0; q < kWalkChunk; ++q) x[q] = col[(r0 + q) * stride];
#pragma unroll
    for (int q = 0; q < kWalkChunk; ++q)
      if (sel & (1u << q)) {
        lo |= static_cast<unsigned>(x[q]);
        hi |= static_cast<unsigned>(x[q] >> 32);
      }
  }
  return lo | (static_cast<u64>(hi) << 32);
}

// kLaneWords: alive words a lane holds (W <= 32 kLaneWords), a compile-time
// count, so the words stay in registers and the code stays small (an
// instruction cache miss costs a single warp hundreds of cycles).
template <int kLaneWords>
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ words,
                 const unsigned char* __restrict__ valid,
                 unsigned char* __restrict__ keep_out, int K, int W,
                 long long cap) {
  extern __shared__ uint4 smem_raw[];
  u64* alive_s = reinterpret_cast<u64*>(smem_raw);          // W words
  u64* stage = alive_s + ((W + 1) & ~1);                    // 16B aligned
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = blockIdx.x;
  const u64* tri = words + p * (32LL * W * (W + 1));
  const unsigned char* vp = valid + p * K;

  for (int w = warp; w < W; w += kSweepThreads / 32) {
    const int j = 64 * w + lane;
    const unsigned lo = __ballot_sync(kFull, j < K && vp[j]);
    const unsigned hi = __ballot_sync(kFull, j + 32 < K && vp[j + 32]);
    if (lane == 0) alive_s[w] = lo | ((u64)hi << 32);
  }
  __syncthreads();
  u64 alive[kLaneWords];
#pragma unroll
  for (int t = 0; t < kLaneWords; ++t) {
    const int w = lane + 32 * t;
    alive[t] = (warp == 0 && w < W) ? alive_s[w] : 0;
  }

  long long off = 0;                     // triangle word of block b0
  for (int b0 = 0; b0 < W;) {
    int b1 = b0;
    long long n = 0;
    while (b1 < W && n + 64LL * (W - b1) <= cap) n += 64LL * (W - b1++);
    const uint4* src = reinterpret_cast<const uint4*>(tri + off);
    uint4* dst = reinterpret_cast<uint4*>(stage);
    const long long n2 = n / 2;
    long long e = tid;
    for (; e + 3 * kSweepThreads < n2; e += 4 * kSweepThreads) {
      uint4 x[4];                        // four loads in flight
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = src[e + q * kSweepThreads];
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[e + q * kSweepThreads] = x[q];
    }
    for (; e < n2; e += kSweepThreads) dst[e] = src[e];
    __syncthreads();
    if (warp == 0) {
      const u64* blk = stage;
      for (int b = b0; b < b1; ++b) {
        const int stride = W - b;        // words of each row of block b
        const int owner = b & 31, tb = b >> 5;
        u64 a = 0;
#pragma unroll
        for (int t = 0; t < kLaneWords; ++t)
          if (t == tb) a = alive[t];
        if (lane == owner) {
          // rows 0 .. 62 of the block in order, every shift a constant, in
          // 32-bit halves: a row of the low half tests and clears only the
          // low half (its high bits are gathered aside), so each step is a
          // test and a predicated clear; row 63's diagonal word has no bit
          // (and is never written)
          unsigned lo = static_cast<unsigned>(a);
          unsigned hi = static_cast<unsigned>(a >> 32), hi_kill = 0;
#pragma unroll
          for (int r0 = 0; r0 < 32; r0 += kWalkChunk) {
            if (((lo >> r0) & kChunkMask) == 0) continue;
            u64 d[kWalkChunk];
#pragma unroll
            for (int q = 0; q < kWalkChunk; ++q)
              d[q] = blk[(r0 + q) * stride];
#pragma unroll
            for (int q = 0; q < kWalkChunk; ++q)
              if (lo & (1u << (r0 + q))) {
                lo &= ~static_cast<unsigned>(d[q]);
                hi_kill |= static_cast<unsigned>(d[q] >> 32);
              }
          }
          hi &= ~hi_kill;
          const unsigned* blk_hi = reinterpret_cast<const unsigned*>(blk) + 1;
#pragma unroll
          for (int r0 = 0; r0 < 32; r0 += kWalkChunk) {
            if (((hi >> r0) & kChunkMask) == 0) continue;
            unsigned d[kWalkChunk];
#pragma unroll
            for (int q = 0; q < kWalkChunk; ++q)
              d[q] = r0 + q < 31 ? blk_hi[2 * (32 + r0 + q) * stride] : 0u;
#pragma unroll
            for (int q = 0; q < kWalkChunk; ++q)
              if (hi & (1u << (r0 + q))) hi &= ~d[q];
          }
          a = lo | (static_cast<u64>(hi) << 32);
        }
        a = __shfl_sync(kFull, a, owner);
#pragma unroll
        for (int t = 0; t < kLaneWords; ++t)
          if (t == tb && lane == owner) alive[t] = a;
        // the kept rows clear their bits in every later word, 16 rows at a
        // time: every load issued before the first OR.  With at most 16
        // words (K <= 1,024) the two half-warps take 32 rows each of the
        // same word and meet in one shuffle.
        if (kLaneWords == 1 && W <= 16) {
          const int w = lane & 15, half = lane >> 4;
          const unsigned bits = static_cast<unsigned>(a >> (32 * half));
          u64 acc = 0;
          if (w > b && w < W)
            acc = kept_rows(blk + (long long)(32 * half) * stride + (w - b),
                            stride, bits, 32);
          acc |= __shfl_xor_sync(kFull, acc, 16);
          if (half == 0 && w > b && w < W) alive[0] &= ~acc;
        } else {
#pragma unroll
          for (int t = 0; t < kLaneWords; ++t) {
            const int w = lane + 32 * t;
            if (w > b && w < W) {
              const u64* col = blk + (w - b);
              alive[t] &= ~(kept_rows(col, stride,
                                      static_cast<unsigned>(a), 32)
                            | kept_rows(col + 32LL * stride, stride,
                                        static_cast<unsigned>(a >> 32),
                                        32));
            }
          }
        }
        blk += 64LL * stride;
      }
    }
    __syncthreads();                     // stage consumed before the next
    off += n;
    b0 = b1;
  }
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int w = lane + 32 * t;
      if (w < W) alive_s[w] = alive[t];
    }
  }
  __syncthreads();
  for (int j = tid; j < K; j += kSweepThreads)
    keep_out[p * K + j] = (alive_s[j >> 6] >> (j & 63)) & 1;
}

// Launch the sweep with kLaneWords alive words a lane.  The largest
// dynamic shared memory a block may take is opted into once per device.
template <int kLaneWords>
int launch_sweep(int device, const u64* ws, const unsigned char* valid,
                 unsigned char* keep, int P, int K, int W,
                 cudaStream_t stream) {
  static std::atomic<int> cache[ResidentCache::kMaxDevices];
  const bool cached = device >= 0 && device < ResidentCache::kMaxDevices;
  int limit = cached ? cache[device].load(std::memory_order_relaxed) : 0;
  if (limit == 0) {
    cudaError_t e = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_sweep_kernel<kLaneWords>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (cached) cache[device].store(limit, std::memory_order_relaxed);
  }
  const long long alive_words = (W + 1) & ~1;
  const long long tri_words = 32LL * W * (W + 1);
  long long cap = (limit / 8 - alive_words) & ~1LL;   // stage words
  if (cap > tri_words) cap = tri_words;
  if (cap < 64LL * W) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(alive_words + cap) * 8;
  nms_sweep_kernel<kLaneWords><<<P, kSweepThreads, smem, stream>>>(
      ws, valid, keep, K, W, cap);
  return end_launch();
}

}  // namespace

// words: the (P, 32 W (W + 1)) u64 workspace, W = ceil(K / 64), allocated
// by the caller; no word of it needs to be set.
KERNEL_API int nms_sweep_launch(int device, const float* iou,
                                const unsigned char* valid,
                                unsigned char* keep, void* words, int P,
                                int K, float thr, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if (P == 0 || K == 0) return 0;
  const int W = (K + 63) / 64;
  if (W > 32 * kMaxLaneWords) return static_cast<int>(cudaErrorInvalidValue);
  u64* ws = static_cast<u64*>(words);
  const long long rows = (long long)P * K;
  const unsigned pack_blocks = blocks_for(rows, kPackWarps);
  const bool vec = K % 4 == 0
                   && reinterpret_cast<uintptr_t>(iou) % 16 == 0;
  if (vec)
    nms_pack_kernel<true><<<pack_blocks, kPackWarps * 32, 0, stream>>>(
        iou, ws, P, K, W, thr);
  else
    nms_pack_kernel<false><<<pack_blocks, kPackWarps * 32, 0, stream>>>(
        iou, ws, P, K, W, thr);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (W <= 32) return launch_sweep<1>(device, ws, valid, keep, P, K, W,
                                      stream);
  if (W <= 128) return launch_sweep<4>(device, ws, valid, keep, P, K, W,
                                       stream);
  return launch_sweep<kMaxLaneWords>(device, ws, valid, keep, P, K, W,
                                     stream);
}
