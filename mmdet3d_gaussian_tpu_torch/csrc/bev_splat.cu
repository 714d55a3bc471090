// K2 and K7 on Hopper: a persistent grid of contiguous runs of key rows, cut by cost (half-rows written plus rows read) at key-row granularity; each block copies its run's source rows into shared memory with one bulk (TMA) copy first, then streams every element of its tiles of 256 half-rows once with evict-first 16-byte stores (row width a compile-time shift), each window carried from the last. Bound: bytes (K2 236 MB f32 / 118 MB bf16, 0.0705 / 0.0353 ms at 3.35 TB/s).
//
// Sorted voxel rows -> dense BEV canvas: the plain canvas (K2) and the
// parity-pair canvas of the space-to-depth layout (K7).
//
// K2 replaces mmdet3d_gaussian_tpu/ops/pallas/bev_splat_kernel.py::
// bev_splat_pallas (kernel _splat_kernel).  Input: V rows of C features with
// linear cell ids `lin`, ascending, unique below ncell; ids >= ncell (unused
// voxel rows) sort last and are dropped.  Output: (ncell, C), cells without
// a voxel are 0.
//
// K7 replaces bev_splat_kernel.py::bev_splat_pairs_pallas (kernel
// _splat_pairs_kernel).  Input: V rows of C features with paired-cell ids
// `lin2`, non-decreasing, at most two rows per id (one per parity), and
// each row's lane half `par` (0 or 1); ids >= ncell2 are dropped.  Output:
// (ncell2, 2C), row i landing in columns [par*C, par*C + C) of row lin2[i].
// Seen as (2 * ncell2, C) half-rows, that is K2 with the id 2 * lin2 + par,
// so both are one kernel template: a key row of the output has kHalves
// slots of C elements (1 for K2, 2 for K7).
//
// Values are copied exactly, f32 or bf16, and the canvas has the rows' type
// (the TPU kernels place rows through one-hot bf16 matmuls; this is the
// exact path of ops/voxelize.py::_splat and ::_splat_pairs).  A copy moves
// bits only, so the kernel is written over the element's width (4 or 2
// bytes), not its type.
//
// Bound on an H100: bytes.  At KITTI batch 4 the plain canvas is 857,088 x
// 64 f32 (219 MB) and the s2d pair canvas 428,544 x 128 bf16 (110 MB),
// against 16 or 8 MB of voxel rows, so both kernels are write streams.
// Design: a tile is 256 half-rows (256 key rows of K2, 128 of K7), so the
// ids of a tile's window (at most one per half-row) are one load a thread.
// The grid is as many blocks as stay resident (two an SM, each with 96 KB of
// shared memory); each block owns a contiguous run of key rows, cut by
// cost: a key row costs the half-rows it writes, a row the half-row read
// for it, and block b's run starts at the first key row where the cost of
// the key rows before it reaches b / grid of the whole, so its first and
// last tiles may be partial.  A LiDAR sweep is dense near the sensor, so
// runs cut by key rows alone would leave a few blocks with most of the
// rows; runs cut at whole tiles left the costliest block 6-7 % over the
// mean (a tile is a twelfth of a block's share), and the last block to end
// sets the kernel's time.  One search finds both ends of the run (each
// half of the block one end, 256 probes a round: 2 dependent loads at V =
// 64,000), and the block reads its rows into shared memory (a bulk copy
// where the rows are 16-byte units) before it stores anything: all of the
// kernel's reads come in one burst at its start, and its stores then
// stream with no reads among them (mixed in, the 16 MB of f32 rows cost K2
// ~12 us more, from L2 too; a grid that takes tiles from a counter as its
// blocks finish, which streams zeros ~5 % faster than fixed runs, lost
// more than that to the reads it then mixes in: splat_stream.py).  Each
// window starts where the last one ended, its length the count of loaded
// ids below the tile's end in the run, its ids loaded one tile ahead.  The
// slot of each half-row holds the index of its source row; an entry below
// the window's start is stale (windows only move forward), so the slots are
// cleared once per block.  Every element of the canvas is written exactly
// once (source value or 0), with streaming 16-byte stores where the row
// width and alignment allow: no memset pass, no atomics, each input row
// read by exactly one block.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // half-rows of a tile; window ids a tile

// First index of [0, n) where less(i) turns false (less holds on a
// prefix), searched by the kWidth threads of this thread's group (threads
// [g * kWidth, (g + 1) * kWidth)), each probing kProbes of kWidth *
// kProbes evenly spaced indices a round (the loads of a round issued
// together).  Every thread of the block runs the same rounds (barriers
// inside), so groups search side by side; counts: one int of shared memory
// a warp.
template <int kWidth, int kProbes, typename Less>
__device__ long long group_search(long long n, Less less, int* counts) {
  constexpr int kGroupWarps = kWidth / 32, kAll = kWidth * kProbes;
  const int j = threadIdx.x % kWidth, warp = threadIdx.x / 32;
  const int first = warp / kGroupWarps * kGroupWarps;
  long long lo = 0, hi = n;
  for (long long size = n; size > 0; size = (size + kAll - 1) / kAll - 1) {
    const long long step = lo < hi ? (hi - lo + kAll - 1) / kAll : 0;
    bool below[kProbes];
#pragma unroll
    for (int k = 0; k < kProbes; ++k) {
      const long long q = lo + (k * kWidth + j + 1) * step - 1;
      below[k] = step > 0 && q < hi && less(q);
    }
    int got = 0;
#pragma unroll
    for (int k = 0; k < kProbes; ++k)
      got += __popc(__ballot_sync(0xffffffffu, below[k]));
    if ((threadIdx.x & 31) == 0) counts[warp] = got;
    __syncthreads();
    int cnt = 0;
    for (int w = 0; w < kGroupWarps; ++w) cnt += counts[first + w];
    __syncthreads();
    if (step > 0) {
      lo += cnt * step;
      hi = min(hi, lo + step - 1);
    }
  }
  return lo;
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory with the TMA, completing on the mbarrier `bar` (one
// arrival, this one)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned int bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                          unsigned int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  __stcs(p, v);
}
__device__ __forceinline__ void store_stream(uint32_t* p, uint32_t v) {
  __stcs(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(v));
}
__device__ __forceinline__ void store_stream(uint16_t* p, uint16_t v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         static_cast<unsigned short>(v));
}

// W: the unit of one load / store (uint4 = 16 bytes, or one element); a
// slot (C elements) is cw units, cw = 1 << kShift, or any cw when kShift
// is -1; rows: key rows of the output; stage: the units of dynamic shared
// memory that hold the block's source rows.
//
// Reads first, then writes: the block loads the source rows of its whole
// run (contiguous in feats) into shared memory before its first store; the
// store phase reads nothing but the next window's ids, loaded one tile
// ahead.  A run denser than the stage reads its next rows in one burst
// between two tiles when a window leaves the stage; a window wider than the
// stage (rows over 96 KB / 256) reads the rest where they are needed.
template <typename W, int kHalves, int kShift>
__global__ void __launch_bounds__(kThreads) splat_kernel(
    const W* __restrict__ feats, const int* __restrict__ ids,
    const int* __restrict__ par, W* __restrict__ out, int V, int cw,
    long long rows, int stage) {
  constexpr int kTile = kThreads / kHalves;   // key rows a tile
  extern __shared__ uint4 dynamic_smem[];
  W* staged_rows = reinterpret_cast<W*>(dynamic_smem);
  __shared__ int src[kThreads];
  __shared__ int counts[kThreads / 32];
  __shared__ long long span[2];                // the run's key rows
  __shared__ int run[2];                       // ... and its rows
  const int tid = threadIdx.x;
  // The run: the cost of key rows [0, k) is kHalves * k half-rows written
  // plus R(k) rows read (R(k): live rows, ids below the canvas's end, with
  // an id below k); block b owns key rows [k_b, k_b+1), k_b the least k
  // whose cost reaches b * total / grid, so no block's cost is over its
  // share by more than a key row's.  Half the block finds k_b, the other
  // half k_b+1.  The total counts all V rows, live or not (ids past the
  // canvas sort last), so that no search for the live count comes first:
  // the shares then run (V - live) / grid over the live cost, and the last
  // block ends early by V - live.
  const int side = tid / (kThreads / 2);
  const long long goal = (rows * kHalves + V)
      * (blockIdx.x + side) / gridDim.x;
  // r: the least row with kHalves * id(r) + r >= goal, or the first row
  // past the canvas (ids >= rows sort last); then k_b is the least key
  // past row r - 1's with kHalves * k + r >= goal, and R(k_b) is r, or
  // r + 1 where row r shares row r - 1's key (K7's pair)
  const long long r = group_search<kThreads / 2, 2>(
      V, [&](long long q) {
        const long long id = __ldg(ids + q);
        return id < rows && id * kHalves + q < goal;
      }, counts);
  long long kb = (goal - r + kHalves - 1) / kHalves;
  if (r > 0) kb = max(kb, (long long)__ldg(ids + r - 1) + 1);
  kb = min(kb, rows);
  const bool pair_below = r < V && (long long)__ldg(ids + r) < kb;
  if (tid % (kThreads / 2) == 0) {
    span[side] = kb;
    run[side] = (int)r + pair_below;
  }
  __syncthreads();
  const long long k_begin = span[0], k_end = span[1];
  if (k_begin >= k_end) return;
  const long long t_begin = k_begin / kTile;
  const long long t_end = (k_end + kTile - 1) / kTile;
  if constexpr (kShift >= 0) cw = 1 << kShift;
  src[tid] = -1;
  // the stage holds rows [first, first + staged / cw) of the run; 16-byte
  // units come in one bulk copy (issued by thread 0, waited for by all:
  // restage_wait), others a unit a thread
  __shared__ uint64_t stage_bar;
  unsigned int stage_phase = 0;
  int first = 0, staged = 0;
  if (sizeof(W) == 16 && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&stage_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto restage = [&](int from) {
    first = from;
    staged = (int)min((long long)(run[1] - from) * cw, (long long)stage);
    if constexpr (sizeof(W) == 16) {
      if (tid == 0 && staged > 0)
        bulk_load(staged_rows, feats + (long long)from * cw,
                  (unsigned int)staged * 16u, &stage_bar);
    } else {
      for (int e = tid; e < staged; e += kThreads)
        staged_rows[e] = __ldg(feats + (long long)from * cw + e);
    }
  };
  auto restage_wait = [&]() {
    if constexpr (sizeof(W) == 16) {
      if (staged > 0) {
        mbar_wait(&stage_bar, stage_phase);
        stage_phase ^= 1u;
      }
    }
  };
  restage(run[0]);

  // this thread's id of window t (its start s0) and of window t + 1 (s1)
  auto load_key = [&](int at, long long t, int& key, int& half) {
    key = INT_MAX;
    half = 0;
    if (t < t_end && (long long)at + tid < V) {
      key = __ldg(ids + at + tid);
      if (kHalves == 2) half = __ldg(par + at + tid) & 1;
    }
  };
  // count of window t's ids (sorted, so the first ones) below tile t's end
  // in the run
  auto window = [&](long long t, int key, bool& in) {
    const long long base = t * kTile;
    in = key >= base && key < min(base + kTile, k_end);
    return __syncthreads_count(in);
  };
  auto fill = [&](long long t, int at, bool in, int key, int half) {
    if (in) src[(int)(key - t * kTile) * kHalves + half] = at + tid;
  };

  int s0 = run[0], key0, half0;
  bool in0;
  load_key(s0, t_begin, key0, half0);
  const int cnt0 = window(t_begin, key0, in0);
  int s1 = s0 + cnt0, key1, half1;
  load_key(s1, t_begin + 1, key1, half1);
  fill(t_begin, s0, in0, key0, half0);
  restage_wait();
  __syncthreads();
  for (long long t = t_begin; t < t_end; ++t) {
    bool in1;
    const int cnt1 = window(t + 1, key1, in1);
    const int s2 = s1 + cnt1;
    int key2, half2;
    load_key(s2, t + 2, key2, half2);

    // the tile's key rows in the run
    const long long base = t * kTile;
    W* o = out + base * kHalves * cw;
    const int u0 = (int)(max(k_begin, base) - base) * kHalves * cw;
    const int u1 = (int)(min(k_end, base + kTile) - base) * kHalves * cw;
#pragma unroll 4
    for (int e = u0 + tid; e < u1; e += kThreads) {
      int h;
      if constexpr (kShift >= 0) h = e >> kShift; else h = e / cw;
      const int s = src[h];
      W v{};
      if (s >= s0) {
        const int u = (s - first) * cw + (e - h * cw);
        v = u < staged ? staged_rows[u]
                       : __ldg(feats + (long long)first * cw + u);
      }
      store_stream(o + e, v);
    }
    __syncthreads();                    // slots and stage read
    if (t + 1 < t_end) {
      // a run denser than the stage: read its next rows in one burst
      if ((long long)(s2 - first) * cw > staged) {
        restage(s1);
        fill(t + 1, s1, in1, key1, half1);
        restage_wait();
      } else {
        fill(t + 1, s1, in1, key1, half1);
      }
    }
    __syncthreads();
    s0 = s1;
    s1 = s2;
    key1 = key2;
    half1 = half2;
  }
}

struct Plan {
  long long tiles;
  unsigned int grid;
  int unit_bytes;   // 16, or the element's width
  int shift;        // slot width in units as a shift, or -1
};

// Shared memory for a block's source rows: two blocks fit on an SM.
constexpr int kStageBytes = 96 * 1024;

// Blocks that stay resident with the stage (and allows the stage first).
template <typename W, int kHalves, int kShift>
int resident(int device) {
  static ResidentCache cache;
  const auto kernel = splat_kernel<W, kHalves, kShift>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStageBytes) != cudaSuccess)
    return 0;
  return cache.get(kernel, device, kThreads, kStageBytes);
}

template <int kHalves>
int plan_splat(int device, const void* feats, const void* out, int C,
               long long rows, int elem_bytes, Plan* plan) {
  if (elem_bytes != 4 && elem_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = (long long)C * elem_bytes;
  const bool vec16 = (row_bytes % 16 == 0)
      && (reinterpret_cast<uintptr_t>(feats) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  plan->unit_bytes = vec16 ? 16 : elem_bytes;
  plan->shift = -1;
  int cap;
  if (vec16 && row_bytes == 256) {
    plan->shift = 4;
    cap = resident<uint4, kHalves, 4>(device);
  } else if (vec16 && row_bytes == 128) {
    plan->shift = 3;
    cap = resident<uint4, kHalves, 3>(device);
  } else if (vec16) {
    cap = resident<uint4, kHalves, -1>(device);
  } else if (elem_bytes == 4) {
    cap = resident<uint32_t, kHalves, -1>(device);
  } else {
    cap = resident<uint16_t, kHalves, -1>(device);
  }
  if (cap <= 0) {
    const int err = static_cast<int>(cudaGetLastError());
    return err ? err : static_cast<int>(cudaErrorUnknown);
  }
  const int tile = kThreads / kHalves;
  plan->tiles = (rows + tile - 1) / tile;
  plan->grid = (unsigned int)(plan->tiles < cap ? plan->tiles : cap);
  return 0;
}

template <typename W, int kHalves, int kShift>
void run(const Plan& p, const void* feats, const int* ids, const int* par,
         void* out, int V, int cw, long long rows, cudaStream_t stream) {
  splat_kernel<W, kHalves, kShift><<<p.grid, kThreads, kStageBytes,
                                     stream>>>(
      static_cast<const W*>(feats), ids, par, static_cast<W*>(out), V, cw,
      rows, kStageBytes / (int)sizeof(W));
}

template <int kHalves>
int launch_splat(int device, const void* feats, const int* ids,
                 const int* par, void* out, int V, int C, long long rows,
                 int elem_bytes, cudaStream_t stream) {
  if (rows == 0 || C == 0) return 0;
  Plan p;
  int err = plan_splat<kHalves>(device, feats, out, C, rows, elem_bytes, &p);
  if (err) return err;
  const int cw = (int)((long long)C * elem_bytes / p.unit_bytes);
  if (p.unit_bytes == 16) {
    if (p.shift == 4)
      run<uint4, kHalves, 4>(p, feats, ids, par, out, V, cw, rows, stream);
    else if (p.shift == 3)
      run<uint4, kHalves, 3>(p, feats, ids, par, out, V, cw, rows, stream);
    else
      run<uint4, kHalves, -1>(p, feats, ids, par, out, V, cw, rows, stream);
  } else if (p.unit_bytes == 4) {
    run<uint32_t, kHalves, -1>(p, feats, ids, par, out, V, cw, rows, stream);
  } else {
    run<uint16_t, kHalves, -1>(p, feats, ids, par, out, V, cw, rows, stream);
  }
  return end_launch();
}

}  // namespace

// K2: out (ncell, C); elem_bytes 4 (f32) or 2 (bf16), the rows' and the
// canvas's element width.
KERNEL_API int bev_splat_launch(int device, const void* feats,
                                const int* lin, void* out, int V, int C,
                                long long ncell, int elem_bytes,
                                cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  return launch_splat<1>(device, feats, lin, nullptr, out, V, C, ncell,
                         elem_bytes, stream);
}

// K7: out (ncell2, 2C), laid out as (2 * ncell2, C) half-rows.
KERNEL_API int bev_splat_pairs_launch(int device, const void* feats,
                                      const int* lin2, const int* par,
                                      void* out, int V, int C,
                                      long long ncell2, int elem_bytes,
                                      cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  return launch_splat<2>(device, feats, lin2, par, out, V, C, ncell2,
                         elem_bytes, stream);
}

// What a launch with these arguments runs (halves 1: K2, 2: K7), no launch:
// result = (grid, tiles, bytes a load / store, slot width in units as a
// shift or -1).
KERNEL_API int bev_splat_plan(int device, const void* feats, const void* out,
                              int C, long long rows, int elem_bytes,
                              int halves, long long* result) {
  int err = begin_launch(device);
  if (err) return err;
  Plan p;
  err = halves == 2
      ? plan_splat<2>(device, feats, out, C, rows, elem_bytes, &p)
      : plan_splat<1>(device, feats, out, C, rows, elem_bytes, &p);
  if (err) return err;
  result[0] = p.grid;
  result[1] = p.tiles;
  result[2] = p.unit_bytes;
  result[3] = p.shift;
  return 0;
}
