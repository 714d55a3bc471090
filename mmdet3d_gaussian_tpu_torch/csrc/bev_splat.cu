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
// Each block owns a tile of kTile key rows, finds its input window by two
// binary searches on the sorted ids, records in shared memory which slot of
// the tile each source row fills, then writes every element of its tile
// exactly once (source value or 0) with 16-byte stores where the row width
// and alignment allow: no separate memset pass, no atomics, each input row
// read by exactly one block.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 128;     // key rows per block
constexpr int kThreads = 256;

__device__ __forceinline__ int first_not_less(const int* __restrict__ a, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// W: the unit of one load / store (uint4 = 16 bytes, or one element);
// cw: units per slot (C elements); rows: key rows of the output.
template <typename W, int kHalves>
__global__ void splat_kernel(const W* __restrict__ feats,
                             const int* __restrict__ ids,
                             const int* __restrict__ par,
                             W* __restrict__ out, int V, int cw,
                             long long rows) {
  __shared__ int src[kTile * kHalves];
  __shared__ int window[2];
  long long base = (long long)blockIdx.x * kTile;
  int n = (int)min((long long)kTile, rows - base);
  for (int r = threadIdx.x; r < kTile * kHalves; r += blockDim.x) src[r] = -1;
  if (threadIdx.x == 0) window[0] = first_not_less(ids, V, base);
  if (threadIdx.x == 32) window[1] = first_not_less(ids, V, base + n);
  __syncthreads();
  for (int i = window[0] + threadIdx.x; i < window[1]; i += blockDim.x) {
    int slot = (int)(ids[i] - base) * kHalves;
    if constexpr (kHalves == 2) slot += par[i];
    src[slot] = i;
  }
  __syncthreads();

  W* o = out + base * kHalves * cw;
  for (int e = threadIdx.x; e < n * kHalves * cw; e += blockDim.x) {
    int h = e / cw;
    int s = src[h];
    W v;
    if (s >= 0) {
      v = feats[(long long)s * cw + (e - h * cw)];
    } else {
      v = W{};
    }
    o[e] = v;
  }
}

template <int kHalves>
int launch_splat(const void* feats, const int* ids, const int* par,
                 void* out, int V, int C, long long rows, int elem_bytes,
                 cudaStream_t stream) {
  if (rows == 0 || C == 0) return 0;
  if (elem_bytes != 4 && elem_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks = (unsigned int)((rows + kTile - 1) / kTile);
  long long row_bytes = (long long)C * elem_bytes;
  bool vec16 = (row_bytes % 16 == 0)
      && (reinterpret_cast<uintptr_t>(feats) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec16) {
    splat_kernel<uint4, kHalves><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(feats), ids, par, static_cast<uint4*>(out),
        V, (int)(row_bytes / 16), rows);
  } else if (elem_bytes == 4) {
    splat_kernel<uint32_t, kHalves><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(feats), ids, par,
        static_cast<uint32_t*>(out), V, C, rows);
  } else {
    splat_kernel<uint16_t, kHalves><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(feats), ids, par,
        static_cast<uint16_t*>(out), V, C, rows);
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
  return launch_splat<1>(feats, lin, nullptr, out, V, C, ncell, elem_bytes,
                         stream);
}

// K7: out (ncell2, 2C), laid out as (2 * ncell2, C) half-rows.
KERNEL_API int bev_splat_pairs_launch(int device, const void* feats,
                                      const int* lin2, const int* par,
                                      void* out, int V, int C,
                                      long long ncell2, int elem_bytes,
                                      cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  return launch_splat<2>(feats, lin2, par, out, V, C, ncell2, elem_bytes,
                         stream);
}
