"""Point set abstraction ops: furthest point sampling, ball query,
grouping, voxel query.

Port of ``mmdet3d_gaussian_tpu/ops/vsa.py``, batched over a leading
sample dim (the JAX package vmaps one sample at a time), plain PyTorch as
the JAX package computes them outside Pallas:

* :func:`furthest_point_sample` — from the first valid point, each step
  takes the first point of largest distance to the chosen set (invalid
  points sit at -1 and are never chosen while a valid one is left).
* :func:`ball_query` — the first ``nsample`` support indices (ascending)
  with ``d^2 < r^2`` strictly; a ball with fewer hits repeats its first
  hit; an empty ball is all -1.  Squared distances are summed over x, y,
  z in that order, as the JAX package sums them (no ``|a|^2 + |b|^2 -
  2ab``, which rounds differently at the boundary).  Queries run in
  chunks so that no temporary exceeds ``CHUNK_ELEMENTS`` (query, support)
  pairs.
* :func:`group_points`, :func:`query_and_group` — gathers by neighbour
  index, -1 reading zeros; coordinates relative to the query.
* :func:`voxel_query` — neighbours in a dense voxel id map within a
  window, in the reference kernel's z-outer / x-inner order.

Indices are int64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# (query, support) pairs of one ball-query chunk: about 20 bytes a pair in
# temporaries, so ~0.7 GB
CHUNK_ELEMENTS = 1 << 25


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over x, y, z of (a - b)^2, left to right (broadcasting)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def furthest_point_sample(points_xyz: torch.Tensor, num_samples: int,
                          valid_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(B, N, 3) -> (B, num_samples) indices: a Python loop of
    ``num_samples - 1`` dependent steps over the batch, eight kernels a
    step."""
    b, n, _ = points_xyz.shape
    dev = points_xyz.device
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    min_d = torch.where(valid_mask, 1e10, -1.0).to(points_xyz.dtype)
    last = torch.argmax(valid_mask.to(torch.uint8), dim=1)   # first valid
    picked = [last]
    for _ in range(1, num_samples):
        diff = points_xyz - points_xyz.gather(
            1, last[:, None, None].expand(b, 1, 3))
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        min_d = torch.minimum(min_d, torch.where(valid_mask, d, -1.0))
        last = torch.argmax(min_d, dim=1)
        picked.append(last)
    return torch.stack(picked, dim=1)


def ball_query(radius: float, nsample: int, support_xyz: torch.Tensor,
               query_xyz: torch.Tensor,
               support_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) support x (B, M, 3) queries -> (B, M, nsample) support
    indices (rules in the module docstring); ``support_mask`` (B, N)."""
    b, n, _ = support_xyz.shape
    m = query_xyz.shape[1]
    dev = support_xyz.device
    if support_mask is None:
        support_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    if m == 0 or n == 0:
        return torch.full((b, m, nsample), -1, dtype=torch.long, device=dev)
    r2 = torch.tensor(radius * radius, dtype=support_xyz.dtype, device=dev)
    col = torch.arange(n, dtype=torch.int32, device=dev)
    k = min(nsample, n)
    step = max(1, CHUNK_ELEMENTS // max(b * n, 1))
    out = []
    for lo in range(0, m, step):
        q = query_xyz[:, lo:lo + step]
        d2 = _sq_dist(q[:, :, None, :], support_xyz[:, None, :, :])
        hit = (d2 < r2) & support_mask[:, None, :]
        rank = torch.where(hit, col, n)                       # (B, m, N)
        first, _ = torch.topk(rank, k, dim=-1, largest=False, sorted=True)
        out.append(first.long())
    first = torch.cat(out, 1)
    if k < nsample:
        first = torch.cat([first, first.new_full((b, m, nsample - k), n)],
                          -1)
    has = first < n
    idx = torch.where(has, first, first[..., :1])
    return torch.where(has[..., :1], idx, -1)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, K) -> (B, M, K, C); -1 reads
    zeros."""
    b, m, k = idx.shape
    safe = idx.clamp(min=0).reshape(b, m * k, 1)
    out = features.gather(1, safe.expand(-1, -1, features.shape[-1]))
    out = out.reshape(b, m, k, -1)
    return torch.where((idx >= 0)[..., None], out, 0.0)


def query_and_group(radius: float, nsample: int, support_xyz: torch.Tensor,
                    query_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None,
                    support_mask: Optional[torch.Tensor] = None,
                    use_xyz: bool = True, normalize_xyz: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (grouped (B, M, K, C'), idx (B, M, K)), C' = 3 [+ C] with
    ``use_xyz``: coordinates relative to the query (zero for an empty
    ball), then the grouped features."""
    if not use_xyz and features is None:
        raise ValueError('query_and_group needs use_xyz=True or features')
    idx = ball_query(radius, nsample, support_xyz, query_xyz, support_mask)
    rel = group_points(support_xyz, idx) - query_xyz[:, :, None, :]
    rel = torch.where((idx >= 0)[..., None], rel, 0.0)
    if normalize_xyz:
        rel = rel / radius
    parts = [rel] if use_xyz else []
    if features is not None:
        parts.append(group_points(features, idx))
    return torch.cat(parts, dim=-1), idx


def voxel_query(query_xyz: torch.Tensor, voxel_ids_dense: torch.Tensor,
                point_cloud_range, voxel_size,
                max_range: Tuple[int, int, int], nsample: int,
                radius: Optional[float] = None) -> torch.Tensor:
    """(M, 3) queries x a dense (Z, Y, X) voxel id map (-1 empty) -> (M,
    nsample) ids: the cells of the +-``max_range`` window (z outer, x
    inner) whose centre lies within ``radius`` (None: no metric test),
    the first ``nsample`` live ids in that order; short rows end in -1."""
    dt, dev = query_xyz.dtype, query_xyz.device
    pcr = torch.tensor(point_cloud_range, dtype=dt, device=dev)
    vs = torch.tensor(voxel_size, dtype=dt, device=dev)
    cell = torch.floor((query_xyz - pcr[:3]) / vs).to(torch.int32)
    rz, ry, rx = max_range
    oz, oy, ox = torch.meshgrid(
        torch.arange(-rz, rz + 1, device=dev),
        torch.arange(-ry, ry + 1, device=dev),
        torch.arange(-rx, rx + 1, device=dev), indexing='ij')
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)],
                          -1).to(torch.int32)                  # (W, 3)
    nz, ny, nx = voxel_ids_dense.shape
    cand = cell[:, None, :] + offsets[None]                    # (M, W, 3)
    ok = ((cand[..., 0] >= 0) & (cand[..., 0] < nx)
          & (cand[..., 1] >= 0) & (cand[..., 1] < ny)
          & (cand[..., 2] >= 0) & (cand[..., 2] < nz))
    if radius is not None:
        centers = (cand.to(dt) + 0.5) * vs + pcr[:3]
        ok = ok & (_sq_dist(centers, query_xyz[:, None, :])
                   <= radius * radius)
    safe = torch.where(ok[..., None], cand, 0).long()
    vid = voxel_ids_dense[safe[..., 2], safe[..., 1], safe[..., 0]]
    vid = torch.where(ok, vid, -1)
    w = vid.shape[1]
    rank = torch.where(vid >= 0, torch.arange(w, device=dev), w)
    order = torch.argsort(rank, dim=1, stable=True)[:, :nsample]
    return vid.gather(1, order).long()
