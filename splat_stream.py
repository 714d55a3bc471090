#!/usr/bin/env python3
"""K2 and K7 (the BEV splats, ``ops.voxelize.bev_splat`` and
``bev_splat_pairs``) on one CUDA card, beside the write stream they are
bound by and two other ways to order the splat's work.

    python3 splat_stream.py [--other CHECKOUT]

First it builds, under ``build/``, kernels that only write the KITTI
batch-4 f32 canvas (857,088 x 64, 219 MB) in 16-byte stores: 256-thread
blocks writing 64 KB tiles, each block a fixed contiguous run of tiles
(``runs``, the splat's order), the tiles dealt out in turn (``dealt``),
one block a tile, or persistent blocks taking the next tile from a counter
as they finish (``tickets``); with streaming (evict-first) or plain stores,
with or without the splat's two barriers a tile; bulk (TMA) copies of a
zeroed shared buffer; a grid-stride fill (``flat``); ``cudaMemsetAsync``
and ``zero_``; then the splat's order, the tickets and ``fill_`` writing
a non-zero word and an address hash.  Then it times the port's K2 and K7
on three sets of ids for the same 64,000 rows (no live row; rows every 8th
cell; rows at cells whose density falls as 1/r^2 from the sensor,
``chip_smoke.falloff_ids``), in f32 and bf16, each held to its plain
version, beside two splats of the same template whose tiles find their
own rows and read them in the store loop (one block a tile; tickets, two
blocks an SM) and beside ``zero_`` + ``index_copy_`` (the yardstick that
``chip_smoke.py`` holds K2 and K7 to).  ``--other`` also imports the port
of another checkout (an earlier commit unpacked with ``git archive`` into
a git-ignored directory) and times its splats in the same process.

Every time is the median over ``ROUNDS`` rounds, taken in turns (the
order reversed every other round), of CUDA-event time over ``ITERS``
back-to-back calls, per call.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import importlib.util
import os
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS, ITERS = 7, 20

STREAM_SRC = r'''
#include <climits>
#include <cstdint>
constexpr int kThreads = 256, kTile = 4096;   // 16-byte units a tile

__device__ unsigned int g_fill = 0;   // the word the streams write
template <bool kStream>
__device__ __forceinline__ void put(uint4* p) {
  const unsigned int f = g_fill;
  const unsigned int m = f == 1u ? (unsigned int)(size_t)p * 2654435761u : f;
  const uint4 z = make_uint4(m, m ^ 1u, m ^ 2u, m ^ 3u);
  if (kStream) __stcs(p, z); else *p = z;
}
extern "C" int set_fill(unsigned int f) {
  return cudaMemcpyToSymbol(g_fill, &f, sizeof(f)) != cudaSuccess;
}

template <bool kStream, bool kSync, bool kDealt>
__global__ void __launch_bounds__(kThreads) tiles_kernel(uint4* out,
                                                         long long tiles) {
  extern __shared__ uint4 smem[];
  long long t0 = tiles * blockIdx.x / gridDim.x;
  long long t1 = tiles * (blockIdx.x + 1) / gridDim.x, step = 1;
  if (kDealt) { t0 = blockIdx.x; t1 = tiles; step = gridDim.x; }
  for (long long t = t0; t < t1; t += step) {
    uint4* o = out + t * kTile;
#pragma unroll 4
    for (int e = threadIdx.x; e < kTile; e += kThreads) put<kStream>(o + e);
    if (kSync) { __syncthreads(); __syncthreads(); }
  }
}

// one thread of the block stores a zeroed shared buffer of kChunk bytes
// over its run of chunks with bulk asynchronous copies (the TMA)
template <int kChunk>
__global__ void __launch_bounds__(kThreads) bulk_kernel(char* out,
                                                        long long bytes) {
  extern __shared__ uint4 smem[];
  for (int e = threadIdx.x; e < kChunk / 16; e += kThreads)
    smem[e] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long chunks = bytes / kChunk;
  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const long long c1 = chunks * (blockIdx.x + 1) / gridDim.x;
  const unsigned int s = static_cast<unsigned int>(
      __cvta_generic_to_shared(smem));
  for (long long c = c0; c < c1; ++c) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(out + c * kChunk), "r"(s), "n"(kChunk) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int kChunk>
int bulk(int grid, void* out, long long bytes, cudaStream_t st) {
  auto k = bulk_kernel<kChunk>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kChunk) != cudaSuccess) return 1;
  k<<<grid, kThreads, kChunk, st>>>(static_cast<char*>(out), bytes);
  return cudaGetLastError() != cudaSuccess;
}

// one block a tile of kUnits 16-byte units (a grid of all the tiles)
template <bool kStream, int kUnits, int kBlock>
__global__ void __launch_bounds__(kBlock) tile_block_kernel(uint4* out) {
  uint4* o = out + blockIdx.x * (long long)kUnits;
#pragma unroll
  for (int e = threadIdx.x; e < kUnits; e += kBlock) put<kStream>(o + e);
}

// persistent blocks that take the next tile from a counter; ``base`` is
// the counter's value at the launch
__global__ void __launch_bounds__(kThreads) ticket_kernel(
    uint4* out, long long tiles, unsigned long long* counter,
    unsigned long long base) {
  __shared__ long long t;
  for (;;) {
    if (threadIdx.x == 0) t = (long long)(atomicAdd(counter, 1ull) - base);
    __syncthreads();
    const long long mine = t;
    __syncthreads();
    if (mine >= tiles) return;
    uint4* o = out + mine * kTile;
#pragma unroll 4
    for (int e = threadIdx.x; e < kTile; e += kThreads) put<true>(o + e);
  }
}

// Prototype splats (uint4 units, a slot 1 << kShift units): each tile
// finds its own window of rows (the first id at or past the tile's start,
// searched over all V ids: those past the canvas sort last) and reads its
// live rows straight from global memory in the store loop.
//   kTickets false: one block a tile (a grid of all the tiles);
//   kTickets true: persistent blocks taking tiles from a counter, the next
//   ticket taken while the tile streams.
__device__ __forceinline__ long long lower_bound_block(
    const int* ids, long long from, long long n, long long key, int* counts) {
  // first index in [from, n) with ids >= key, 256 probes a round
  long long lo = from, hi = n;
  while (hi - lo > 0) {
    const long long step = (hi - lo + kThreads - 1) / kThreads;
    const long long q = lo + (threadIdx.x + 1) * step - 1;
    const unsigned b = __ballot_sync(0xffffffffu,
                                     q < hi && (long long)__ldg(ids + q) < key);
    if ((threadIdx.x & 31) == 0) counts[threadIdx.x / 32] = __popc(b);
    __syncthreads();
    int cnt = 0;
    for (int w = 0; w < kThreads / 32; ++w) cnt += counts[w];
    __syncthreads();
    lo += cnt * step;
    hi = min(hi, lo + step - 1);
    if (step == 1) break;
  }
  return lo;
}

template <int kHalves, int kShift, bool kTickets>
__global__ void __launch_bounds__(kThreads) proto_splat(
    const uint4* __restrict__ feats, const int* __restrict__ ids,
    const int* __restrict__ par, uint4* __restrict__ out, int V,
    long long rows, long long tiles, unsigned long long* counter,
    unsigned long long base) {
  constexpr int kTileKeys = kThreads / kHalves, cw = 1 << kShift;
  __shared__ int src[kThreads];
  __shared__ int counts[kThreads / 32];
  __shared__ long long ticket[2];
  const int tid = threadIdx.x;
  src[tid] = -1;
  long long t = blockIdx.x, from = 0;
  if (kTickets) {
    if (tid == 0) {
      ticket[0] = (long long)(atomicAdd(counter, 1ull) - base);
      ticket[1] = (long long)(atomicAdd(counter, 1ull) - base);
    }
    __syncthreads();
    t = ticket[0];
  }
  for (int it = 0; t < tiles; ++it) {
    const long long key0 = t * kTileKeys;
    const long long lo = lower_bound_block(ids, from, V, key0, counts);
    const long long end = min(key0 + kTileKeys, rows);
    int key = INT_MAX, half = 0;
    if (lo + tid < V) {
      key = __ldg(ids + lo + tid);
      if (kHalves == 2) half = __ldg(par + lo + tid) & 1;
    }
    if (key < end) src[(int)(key - key0) * kHalves + half] = (int)(lo + tid);
    __syncthreads();
    uint4* o = out + key0 * kHalves * cw;
    const int units = (int)(end - key0) * kHalves * cw;
#pragma unroll 4
    for (int e = tid; e < units; e += kThreads) {
      const int h = e >> kShift;
      const int s = src[h];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (s >= lo) v = __ldg(feats + (long long)s * cw + (e & (cw - 1)));
      __stcs(o + e, v);
    }
    if (!kTickets) return;
    from = lo;
    const long long next = ticket[(it + 1) & 1];
    __syncthreads();
    if (tid == 0) ticket[it & 1] = (long long)(atomicAdd(counter, 1ull) - base);
    t = next;
  }
}

unsigned long long* g_counter = nullptr;
unsigned long long g_base = 0;

__global__ void flat_kernel(uint4* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    put<false>(out + i);
}

template <bool S, bool Y, bool D>
int go(int grid, int smem, uint4* out, long long tiles, cudaStream_t st) {
  auto k = tiles_kernel<S, Y, D>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) return 1;
  k<<<grid, kThreads, smem, st>>>(out, tiles);
  return cudaGetLastError() != cudaSuccess;
}

template <int H, int S, bool T>
int proto(int per_sm, const void* f, const int* ids, const int* par,
          void* out, int V, long long rows, cudaStream_t st) {
  const long long tiles = (rows + kThreads / H - 1) / (kThreads / H);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  if (!g_counter) {
    if (cudaMalloc(&g_counter, 8) != cudaSuccess) return 1;
    if (cudaMemset(g_counter, 0, 8) != cudaSuccess) return 1;
  }
  const long long grid = T ? (long long)per_sm * sms : tiles;
  proto_splat<H, S, T><<<(unsigned)grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(f), ids, par, static_cast<uint4*>(out), V,
      rows, tiles, g_counter, g_base);
  if (T) g_base += tiles + 2 * grid;
  return cudaGetLastError() != cudaSuccess;
}

// kind: 0 one block a tile, 1 tickets; halves 1 (K2) or 2 (K7); row bytes
// 256 (f32 x 64) or 128 (bf16 x 64)
extern "C" int proto_launch(int kind, int halves, int per_sm, int row_bytes,
                            const void* f, const int* ids, const int* par,
                            void* out, int V, long long rows,
                            cudaStream_t st) {
  const int k = kind * 100 + halves * 10 + (row_bytes == 256 ? 4 : 3);
  switch (k) {
    case 14: return proto<1, 4, false>(per_sm, f, ids, par, out, V, rows, st);
    case 13: return proto<1, 3, false>(per_sm, f, ids, par, out, V, rows, st);
    case 24: return proto<2, 4, false>(per_sm, f, ids, par, out, V, rows, st);
    case 23: return proto<2, 3, false>(per_sm, f, ids, par, out, V, rows, st);
    case 114: return proto<1, 4, true>(per_sm, f, ids, par, out, V, rows, st);
    case 113: return proto<1, 3, true>(per_sm, f, ids, par, out, V, rows, st);
    case 124: return proto<2, 4, true>(per_sm, f, ids, par, out, V, rows, st);
    case 123: return proto<2, 3, true>(per_sm, f, ids, par, out, V, rows, st);
  }
  return 1;
}

// which: 0-7 tiles_kernel (bit 0 streaming stores, bit 1 barriers, bit 2
// dealt tiles); 8 flat; 16, 17 bulk copies of 16 and 64 KB; 18 memset;
// 32 a tile a block; 34 8 KB a 128-thread block; 35 tickets
extern "C" int stream_launch(int which, int grid, int smem, void* out,
                             long long tiles, cudaStream_t st) {
  uint4* o = static_cast<uint4*>(out);
  switch (which) {
    case 0: return go<false, false, false>(grid, smem, o, tiles, st);
    case 1: return go<true, false, false>(grid, smem, o, tiles, st);
    case 3: return go<true, true, false>(grid, smem, o, tiles, st);
    case 7: return go<true, true, true>(grid, smem, o, tiles, st);
    case 8:
      flat_kernel<<<grid, kThreads, 0, st>>>(o, tiles * kTile);
      return cudaGetLastError() != cudaSuccess;
    case 16: return bulk<16384>(grid, out, tiles * kTile * 16, st);
    case 17: return bulk<65536>(grid, out, tiles * kTile * 16, st);
    case 18: return cudaMemsetAsync(out, 0, tiles * kTile * 16, st);
    case 32:
      tile_block_kernel<true, kTile, kThreads><<<tiles, kThreads, 0, st>>>(o);
      return cudaGetLastError() != cudaSuccess;
    case 34:
      tile_block_kernel<false, 512, 128><<<tiles * 8, 128, 0, st>>>(o);
      return cudaGetLastError() != cudaSuccess;
    case 35: {
      if (!g_counter) {
        if (cudaMalloc(&g_counter, 8) != cudaSuccess) return 1;
        if (cudaMemset(g_counter, 0, 8) != cudaSuccess) return 1;
      }
      ticket_kernel<<<grid, kThreads, smem, st>>>(o, tiles, g_counter,
                                                  g_base);
      g_base += tiles + grid;
      return cudaGetLastError() != cudaSuccess;
    }
  }
  return 1;
}
'''

# name -> (which, blocks an SM, dynamic shared memory bytes)
STREAMS = {
    'runs, stream stores, 2 barriers a tile, 2/SM (the splat)': (3, 2, 96 << 10),
    'runs, stream stores, no barrier, 2/SM': (1, 2, 96 << 10),
    'runs, plain stores, no barrier, 2/SM': (0, 2, 96 << 10),
    'runs, stream stores, 2 barriers, 4/SM': (3, 4, 48 << 10),
    'dealt, stream stores, 2 barriers, 2/SM': (7, 2, 96 << 10),
    'flat grid-stride, 8/SM': (8, 8, 0),
    'bulk copies of 16 KB, 1/SM': (16, 1, 0),
    'bulk copies of 64 KB, 1/SM': (17, 1, 0),
    'cudaMemsetAsync': (18, 1, 0),
    'a 64 KB tile a block (3,348 blocks)': (32, 1, 0),
    '8 KB a 128-thread block, plain stores': (34, 1, 0),
    'tickets, stream stores, 2/SM': (35, 2, 0),
    'tickets, stream stores, 8/SM': (35, 8, 0),
}


def build_stream() -> ctypes.CDLL:
    out = Path(ROOT) / 'build' / 'splat_stream'
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(STREAM_SRC.encode()).hexdigest()[:12]
    so = out / f'stream_{tag}.so'
    if not so.exists():
        src = out / f'stream_{tag}.cu'
        src.write_text(STREAM_SRC)
        nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                            'bin', 'nvcc')
        subprocess.run([nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                        '-O3', '-std=c++17', '-Xcompiler', '-fPIC',
                        '-shared', str(src), '-o', str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.stream_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p]
    lib.stream_launch.restype = ctypes.c_int
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.proto_launch.argtypes = [I, I, I, I, P, P, P, P, I, LL, P]
    lib.proto_launch.restype = ctypes.c_int
    return lib


def event_ms(fn, iters=ITERS):
    """Per-call CUDA-event ms of ``iters`` back-to-back calls."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns):
    """{name: median per-call ms over ROUNDS rounds}, the order reversed
    every other round."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(ROUNDS):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(event_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def load_voxelize(root: str, name: str):
    """``ops.voxelize`` of the port in checkout ``root``, imported as
    package ``name`` (its kernels build under that checkout's ``build/``)."""
    pkg = os.path.join(root, 'mmdet3d_gaussian_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + '.ops.voxelize')


def kitti_trunk():
    """The grid fields of the KITTI 3-class trunk that
    ``chip_smoke.falloff_cells`` reads."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import KITTI_3CLASS_MODEL
    vs, pcr = (KITTI_3CLASS_MODEL['voxel_size'],
               KITTI_3CLASS_MODEL['point_cloud_range'])
    nx = int(round((pcr[3] - pcr[0]) / vs[0]))
    ny = int(round((pcr[4] - pcr[1]) / vs[1]))
    return types.SimpleNamespace(nx=nx, ny=ny, voxel_size=vs,
                                 point_cloud_range=pcr)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('splat_stream: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    trunk = kitti_trunk()
    ncell, c, v, n = cs.BATCH * trunk.nx * trunk.ny, 64, 64000, 63102
    print(f'canvas {ncell} x {c}, {v} rows ({n} live), {sms} SMs [{card}]')

    lib = build_stream()
    canvas = torch.empty(ncell, c, device='cuda')
    tiles = canvas.numel() * 4 // (16 * 4096)
    stream = torch.cuda.current_stream().cuda_stream

    def stream_fn(which, per_sm, smem):
        def fn():
            if lib.stream_launch(which, per_sm * sms, smem,
                                 canvas.data_ptr(), tiles, stream):
                raise RuntimeError('stream kernel refused')
        return fn
    fns = {k: stream_fn(*a) for k, a in STREAMS.items()}
    fns['zero_'] = canvas.zero_
    lib.set_fill.argtypes = [ctypes.c_uint]
    for fill, what in ((0x3f800000, 'the word of 1.0f'),
                       (1, 'a hash of the address')):
        lib.set_fill(fill)
        sub = {k: fns[k] for k in (
            'runs, stream stores, 2 barriers a tile, 2/SM (the splat)',
            'tickets, stream stores, 2/SM')}
        sub['fill_(1.0)'] = lambda: canvas.fill_(1.0)
        for k, ms in in_turns(sub).items():
            print(f'write stream of {what}, {k}: {ms:.4f} ms [{card}]')
    lib.set_fill(0)
    names = cs.device_ms_by_name(canvas.zero_, 5)
    print(f'zero_ runs on the card: {sorted(names)}')
    for k, ms in in_turns(fns).items():
        print(f'write stream, {k}: {ms:.4f} ms '
              f'({canvas.numel() * 4 / ms / 1e9:.3f} TB/s) [{card}]')

    versions = {'this': voxelize}
    if args.other:
        versions['other'] = load_voxelize(os.path.abspath(args.other),
                                          'port_other')
    gen = torch.Generator(device='cuda').manual_seed(0)
    feats32 = torch.randn(v, c, device='cuda', generator=gen)
    k2_ids, lin2, par = cs.falloff_ids(n, v, ncell, trunk)
    step = torch.arange(n, dtype=torch.int32, device='cuda')
    trash = torch.full((v - n,), ncell, dtype=torch.int32, device='cuda')
    ncell2 = ncell // 2
    sets = {
        'no live row': (torch.full((v,), ncell, dtype=torch.int32,
                                   device='cuda'),
                        torch.full((v,), ncell2, dtype=torch.int32,
                                   device='cuda'),
                        torch.zeros(v, dtype=torch.int32, device='cuda')),
        'every 8th cell': (torch.cat([step * 8, trash]),
                           torch.cat([step * 4, trash // 2]),
                           torch.zeros(v, dtype=torch.int32,
                                       device='cuda')),
        'density 1/r^2': (k2_ids, lin2, par),
    }
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype)
        for name, (ids, l2, p) in sets.items():
            live = ids < ncell
            rows_live = feats[live]
            plain = voxelize.bev_splat_plain(feats, ids, ncell)
            plain2 = voxelize.bev_splat_pairs_plain(feats, l2, p, ncell2)
            out, out2 = torch.empty_like(plain), torch.empty_like(plain2)
            half_rows = out2.view(2 * ncell2, c)
            hid = voxelize.pair_rows(l2, p, ncell2)[l2 < ncell2]
            fns = {}
            for kind, per_sm in ((0, 0), (1, 2)):
                for halves, (idv, pv, ref, rows) in (
                        (1, (ids, ids, plain, ncell)),
                        (2, (l2, p, plain2, ncell2))):
                    res = torch.empty_like(ref)

                    def fn(kind=kind, per_sm=per_sm, halves=halves, idv=idv,
                           pv=pv, res=res, rows=rows):
                        if lib.proto_launch(kind, halves, per_sm,
                                            c * feats.element_size(),
                                            feats.data_ptr(), idv.data_ptr(),
                                            pv.data_ptr(), res.data_ptr(), v,
                                            rows, stream):
                            raise RuntimeError('proto refused')
                    fn()
                    cs.check(torch.equal(res, ref),
                             f'proto {kind} {per_sm} {halves} disagrees')
                    fns[f'K{2 if halves == 1 else 7} '
                        f'{"tickets " + str(per_sm) + "/SM" if kind else "tile a block"}'] = fn
            for tag, mod in versions.items():
                cs.check(torch.equal(mod.bev_splat(feats, ids, ncell), plain),
                         f'{tag} K2 disagrees with its plain version')
                cs.check(torch.equal(mod.bev_splat_pairs(feats, l2, p,
                                                         ncell2), plain2),
                         f'{tag} K7 disagrees with its plain version')
                fns[f'K2 {tag}'] = (lambda m=mod: m.bev_splat(feats, ids,
                                                              ncell))
                fns[f'K7 {tag}'] = (lambda m=mod: m.bev_splat_pairs(
                    feats, l2, p, ncell2))
            lin_live = ids[live].long()
            fns['K2 yardstick'] = lambda: out.zero_().index_copy_(
                0, lin_live, rows_live)
            fns['K7 yardstick'] = lambda: half_rows.zero_().index_copy_(
                0, hid, rows_live)
            got = in_turns(fns)
            line = ', '.join(f'{k} {ms:.4f}' for k, ms in got.items())
            print(f'{str(dtype)[6:]}, {name} ({int(live.sum())} live): '
                  f'{line} ms [{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
