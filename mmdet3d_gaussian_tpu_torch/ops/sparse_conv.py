"""Sparse 3D convolution as a gather and one matmul.

Port of ``mmdet3d_gaussian_tpu/ops/sparse_conv.py``: a
:class:`SparseTensor` keeps features compact ``(V, C)`` with int32 coords
``(V, 4)`` (batch, z, y, x) and a sorted int32 key per site; invalid rows
carry key ``INT_MAX``, sort last and hold zero features.

* Sub-manifold conv: the K neighbour keys of every site are looked up in
  the sorted keys (``torch.searchsorted``, the sentinel V on a miss), the
  neighbours' features gathered to ``(V, K * Cin)`` and multiplied by the
  ``(K * Cin, Cout)`` weight, one matmul.
* Strided conv: the output sites are the deduplicated candidates
  ``(in + pad - k) / stride`` with a zero remainder, sort-based through
  ``ops/scatter.py::build_scatter`` (its capacity truncates in key order,
  so the last samples of a batch lose their sites first; the count of
  sites dropped accumulates in ``overflow``); each output gathers its K
  inputs and runs the same matmul.  Under a data-parallel ``group`` the
  capacity is the global batch's and the truncation runs over the ranks
  in key order (one offset all-reduce a level, ``build_scatter``'s
  ``group``), so the sites kept over the ranks are the ones one process
  keeps on the whole batch and ``overflow`` counts the global drops; a
  rank whose samples keep no site runs the level on an all-invalid
  table.

Weights are ``(K, Cin, Cout)`` with K in (z, y, x) raster order.  Plain
PyTorch: the JAX package computes all of it outside Pallas.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .scatter import build_scatter

INT_MAX = 2 ** 31 - 1


class SparseTensor(NamedTuple):
    feats: torch.Tensor        # (V, C); rows of invalid sites are zero
    coords: torch.Tensor       # (V, 4) int32 (b, z, y, x); -1 rows invalid
    keys: torch.Tensor         # (V,) int32 ascending; INT_MAX invalid
    spatial_shape: Tuple[int, int, int, int]   # (B, Z, Y, X)
    num_voxels: torch.Tensor   # () int32
    overflow: torch.Tensor     # () int32, sites dropped by out_capacity

    @property
    def valid(self) -> torch.Tensor:
        return self.keys < INT_MAX


def _linearize(coords: torch.Tensor, spatial_shape) -> torch.Tensor:
    """(N, 4) (b, z, y, x) -> (N,) int32 keys; a row with a negative
    entry -> INT_MAX."""
    _, nz, ny, nx = (int(s) for s in spatial_shape)
    c = coords.long()
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    invalid = (coords < 0).any(dim=-1)
    return torch.where(invalid, INT_MAX, key).to(torch.int32)


def make_sparse_tensor(feats: torch.Tensor, coords: torch.Tensor,
                       spatial_shape: Sequence[int],
                       overflow: Optional[torch.Tensor] = None
                       ) -> SparseTensor:
    """Sort the sites by key (stable) -> a SparseTensor of capacity V."""
    shape = tuple(int(s) for s in spatial_shape)
    if int(np.prod(shape)) >= INT_MAX:
        raise ValueError(f'spatial shape {shape} overflows int32 keys')
    coords = coords.to(torch.int32)
    keys = _linearize(coords, shape)
    keys, order = torch.sort(keys, stable=True)
    valid = keys < INT_MAX
    feats = torch.where(valid[:, None], feats[order], 0.0)
    if overflow is None:
        overflow = torch.zeros((), dtype=torch.int32, device=keys.device)
    return SparseTensor(feats=feats, coords=coords[order], keys=keys,
                        spatial_shape=shape,
                        num_voxels=valid.sum().to(torch.int32),
                        overflow=overflow)


def _lookup(st: SparseTensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Query keys -> row index in ``st``, or V on a miss (an ``INT_MAX``
    query always misses)."""
    v = st.keys.shape[0]
    pos = torch.searchsorted(st.keys, query_keys).clamp(max=v - 1)
    hit = (st.keys[pos] == query_keys) & (query_keys < INT_MAX)
    return torch.where(hit, pos, v)


def _kernel_offsets(kernel_size: Sequence[int]) -> np.ndarray:
    kz, ky, kx = kernel_size
    oz, oy, ox = np.meshgrid(np.arange(kz) - kz // 2, np.arange(ky) - ky // 2,
                             np.arange(kx) - kx // 2, indexing='ij')
    return np.stack([oz.ravel(), oy.ravel(), ox.ravel()], -1)   # (K, 3)


def _kernel_size(weight: torch.Tensor, kernel_size) -> Tuple[int, int, int]:
    k = weight.shape[0]
    if kernel_size is None:
        ks = round(k ** (1 / 3))
        kernel_size = (ks, ks, ks)
    if int(np.prod(kernel_size)) != k:
        raise ValueError(f'weight has {k} taps but kernel_size='
                         f'{tuple(kernel_size)}')
    return tuple(int(s) for s in kernel_size)


def _in_grid(c: torch.Tensor, dims) -> torch.Tensor:
    """(..., 3) (z, y, x) -> (...) bool: inside [0, dims)."""
    ok = (c >= 0).all(dim=-1)
    for i, d in enumerate(dims):
        ok = ok & (c[..., i] < d)
    return ok


class _GatherRows(torch.autograd.Function):
    """``feats[rows]`` where a row index of V (a miss) reads zeros.  The
    backward adds each gathered row's gradient into its source row over
    the hits only (``index_add_``): most lookups miss, and the indexing
    backward's sort-based accumulation serializes on the one trash row
    they share (seconds a step at PV-RCNN's full width)."""

    @staticmethod
    def forward(ctx, feats, rows):
        ctx.save_for_backward(rows)
        ctx.v = feats.shape[0]
        padded = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
        return padded[rows]

    @staticmethod
    def backward(ctx, g):
        rows, = ctx.saved_tensors
        hit = (rows < ctx.v).nonzero().squeeze(1)
        grad = g.new_zeros((ctx.v, g.shape[1]))
        return grad.index_add_(0, rows[hit], g[hit]), None


def _gather_matmul(st: SparseTensor, rows: torch.Tensor, weight,
                   bias, out_valid: torch.Tensor) -> torch.Tensor:
    """Features of ``rows`` (V_out * K,) -> (V_out, K * Cin) @ weight, plus
    the bias, zero on invalid output rows."""
    k, cin, cout = weight.shape
    gathered = _GatherRows.apply(st.feats, rows).reshape(-1, k * cin)
    out = torch.matmul(gathered, weight.reshape(k * cin, cout))
    if bias is not None:
        out = out + bias
    return torch.where(out_valid[:, None], out, 0.0).to(st.feats.dtype)


def submanifold_conv3d(st: SparseTensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       kernel_size: Optional[Sequence[int]] = None
                       ) -> SparseTensor:
    """SubMConv3d: output sites are the input sites.  weight (K, Cin,
    Cout); ``kernel_size`` defaults to the cube root of K."""
    ks = _kernel_size(weight, kernel_size)
    offsets = torch.as_tensor(_kernel_offsets(ks), dtype=torch.int32,
                              device=st.coords.device)
    _, nz, ny, nx = st.spatial_shape
    nb = st.coords[:, None, 1:4] + offsets[None]                 # (V, K, 3)
    ok = _in_grid(nb, (nz, ny, nx)) & st.valid[:, None]
    b = st.coords[:, None, 0:1].expand(-1, nb.shape[1], 1)
    full = torch.where(ok[..., None], torch.cat([b, nb], -1), -1)
    rows = _lookup(st, _linearize(full.reshape(-1, 4), st.spatial_shape))
    return st._replace(feats=_gather_matmul(st, rows, weight, bias,
                                            st.valid))


def sparse_conv3d(st: SparseTensor, weight: torch.Tensor, stride,
                  out_capacity: int, bias: Optional[torch.Tensor] = None,
                  kernel_size: Optional[Sequence[int]] = None,
                  padding: Optional[Sequence[int]] = None,
                  group=None) -> SparseTensor:
    """Strided sparse conv: output sites ``(in + pad - k) / stride`` where
    the remainder is zero, deduplicated into ``out_capacity`` rows.
    weight (K, Cin, Cout) in (z, y, x) raster order of ``kernel_size``
    (the cube root of K when not given); ``padding`` defaults to half the
    kernel.  ``group``: ``out_capacity`` is the global batch's (module
    docstring)."""
    ks = _kernel_size(weight, kernel_size)
    kz, ky, kx = ks
    if padding is None:
        padding = (kz // 2, ky // 2, kx // 2)
    strides = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    bsz, nz, ny, nx = st.spatial_shape
    out_dims = tuple((n + 2 * p - k) // s + 1 for n, p, k, s in zip(
        (nz, ny, nx), padding, ks, strides))
    out_shape = (bsz,) + out_dims
    dev = st.coords.device

    kid = torch.as_tensor(np.stack(np.meshgrid(
        np.arange(kz), np.arange(ky), np.arange(kx), indexing='ij'),
        -1).reshape(-1, 3), dtype=torch.int32, device=dev)      # (K, 3)
    pad = torch.as_tensor(padding, dtype=torch.int32, device=dev)
    srd = torch.as_tensor(strides, dtype=torch.int32, device=dev)
    num = st.coords[:, None, 1:4] + pad - kid[None]             # (V, K, 3)
    div = torch.div(num, srd, rounding_mode='floor')
    ok = ((torch.remainder(num, srd) == 0).all(-1)
          & _in_grid(div, out_dims) & st.valid[:, None])
    b = st.coords[:, None, 0:1].expand(-1, kid.shape[0], 1)
    cand = torch.where(ok[..., None], torch.cat([b, div], -1), -1)

    sc = build_scatter(cand.reshape(-1, 4), out_shape, out_capacity,
                       group=group)
    out_st = make_sparse_tensor(
        st.feats.new_zeros((out_capacity, weight.shape[2])),
        sc.voxel_coords, out_shape, overflow=st.overflow + sc.num_overflow)

    # each output site's K contributing input sites
    out_in = out_st.coords[:, None, 1:4] * srd + kid[None] - pad
    in_ok = _in_grid(out_in, (nz, ny, nx)) & out_st.valid[:, None]
    ob = out_st.coords[:, None, 0:1].expand(-1, kid.shape[0], 1)
    full = torch.where(in_ok[..., None], torch.cat([ob, out_in], -1), -1)
    rows = _lookup(st, _linearize(full.reshape(-1, 4), st.spatial_shape))
    return out_st._replace(feats=_gather_matmul(st, rows, weight, bias,
                                                out_st.valid))


def sparse_to_dense(st: SparseTensor) -> torch.Tensor:
    """-> (B, Z, Y, X, C) dense tensor (a scatter-add of the valid rows)."""
    bsz, nz, ny, nx = st.spatial_shape
    total = bsz * nz * ny * nx
    c = st.feats.shape[-1]
    idx = torch.where(st.valid, st.keys, total).long()
    flat = st.feats.new_zeros((total + 1, c)).index_add(0, idx, st.feats)
    return flat[:-1].reshape(bsz, nz, ny, nx, c)


def dense_index_map(st: SparseTensor) -> torch.Tensor:
    """-> (B, Z, Y, X) int32 map of compact row ids (-1 = empty), the dense
    voxel hash that ``ops/vsa.py::voxel_query`` walks."""
    bsz, nz, ny, nx = st.spatial_shape
    total = bsz * nz * ny * nx
    flat = torch.full((total + 1,), -1, dtype=torch.int32,
                      device=st.keys.device)
    idx = torch.where(st.valid, st.keys, total).long()
    flat[idx] = torch.arange(st.keys.shape[0], dtype=torch.int32,
                             device=st.keys.device)
    return flat[:-1].reshape(bsz, nz, ny, nx)
