// Sorted unique voxel rows -> dense BEV canvas.
//
// Replaces mmdet3d_gaussian_tpu/ops/pallas/bev_splat_kernel.py::
// bev_splat_pallas (kernel _splat_kernel).  Input: V rows of C f32 features
// with linear cell ids `lin`, ascending, unique below ncell; ids >= ncell
// (unused voxel rows) sort last and are dropped.  Output: (ncell, C), cells
// without a voxel are 0.  Values are copied exactly in f32 (the TPU kernel
// rounds them to bf16 through a one-hot matmul; this is the exact f32 path
// of ops/voxelize.py::_splat).
//
// Bound on an H100: bytes.  At KITTI batch 4 the canvas is 857,088 x 64 f32
// (219 MB) against 16 MB of voxel rows, so the kernel is a write stream.
// Each block owns a tile of kTile canvas rows, finds its input window by two
// binary searches on the sorted ids, records which tile rows have a source
// row in shared memory, then writes every element of its tile exactly once
// (source value or 0) with 16-byte stores where C allows it: no separate
// memset pass, no atomics, each input row read by exactly one block.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 128;     // canvas rows per block
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

template <int VEC>
__global__ void bev_splat_kernel(const float* __restrict__ feats,
                                 const int* __restrict__ lin,
                                 float* __restrict__ out, int V, int C,
                                 long long ncell) {
  __shared__ int src[kTile];
  __shared__ int window[2];
  long long base = (long long)blockIdx.x * kTile;
  int rows = (int)min((long long)kTile, ncell - base);
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) src[r] = -1;
  if (threadIdx.x == 0) window[0] = first_not_less(lin, V, base);
  if (threadIdx.x == 32) window[1] = first_not_less(lin, V, base + rows);
  __syncthreads();
  for (int i = window[0] + threadIdx.x; i < window[1]; i += blockDim.x)
    src[(int)(lin[i] - base)] = i;
  __syncthreads();

  typedef typename std::conditional<VEC == 4, float4, float>::type vec_t;
  const int cv = C / VEC;
  vec_t* o = reinterpret_cast<vec_t*>(out + base * C);
  for (int e = threadIdx.x; e < rows * cv; e += blockDim.x) {
    int r = e / cv;
    int q = e - r * cv;
    int s = src[r];
    vec_t v;
    if (s >= 0) {
      v = reinterpret_cast<const vec_t*>(feats + (long long)s * C)[q];
    } else {
      if constexpr (VEC == 4) v = make_float4(0.f, 0.f, 0.f, 0.f);
      else v = 0.f;
    }
    o[e] = v;
  }
}

}  // namespace

KERNEL_API int bev_splat_launch(int device, const float* feats,
                                const int* lin, float* out, int V, int C,
                                long long ncell, cudaStream_t stream) {
  int err = begin_launch(device);
  if (err) return err;
  if (ncell == 0 || C == 0) return 0;
  unsigned int blocks = (unsigned int)((ncell + kTile - 1) / kTile);
  bool vec4 = (C % 4 == 0)
      && (reinterpret_cast<unsigned long long>(feats) % 16 == 0)
      && (reinterpret_cast<unsigned long long>(out) % 16 == 0);
  if (vec4)
    bev_splat_kernel<4><<<blocks, kThreads, 0, stream>>>(feats, lin, out, V,
                                                         C, ncell);
  else
    bev_splat_kernel<1><<<blocks, kThreads, 0, stream>>>(feats, lin, out, V,
                                                         C, ncell);
  return end_launch();
}
