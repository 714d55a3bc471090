"""PV-RCNN's middle stage: the multi-level sparse 3D encoder and voxel set
abstraction.

Port of ``mmdet3d_gaussian_tpu/models/middle_encoders.py``:

* :class:`SparseConvBlock` — one sparse conv (sub-manifold, or strided)
  -> :class:`MaskedBatchNorm` over the live sites -> ReLU, zero on the
  invalid rows.
* :class:`MlvlSparseEncoder` — a sub-manifold input conv, four stages
  (stages 1-3 led by a stride-2 conv whose output is capped at
  ``max_voxels`` x B sites), then a (3, 1, 1) / (2, 1, 1) conv on z with
  no padding; returns every stage's :class:`SparseTensor` and the dense
  BEV ``(B, Y, X, Z * C)`` with channel ``z * C + c`` (the JAX package's
  transpose of the dense grid).
* :class:`GuidedSAModuleMSG` — per radius a ball query and grouping, a
  pointwise MLP (linear, masked BatchNorm over the live neighbours, ReLU)
  and a max (or mean) pool; the radii's outputs concatenated.  A support
  table shared by the batch (one flat voxel table, per-sample mask) is
  queried one sample at a time on that sample's rows, which gives the
  JAX package's indices into the whole table; under ``torch.export`` every
  sample queries the whole table under its mask (static shapes).
* :func:`bilinear_sample_bev` and :class:`VoxelSetAbstraction` — FPS
  keypoints, the BEV sampled at them, set abstraction over the raw points
  and the sparse levels, a fusion linear layer with BatchNorm.

Module names follow the JAX package's (``conv_input``, ``stage{i}_down``,
``stage{i}_subm{j}``, ``conv_out``, ``rawpoints_sa``, ``voxel_sa_{k}``),
so ``weights.py`` maps its tree one to one.  Plain PyTorch, as the JAX
package computes all of it outside Pallas.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.sparse_conv import (SparseTensor, make_sparse_tensor,
                               sparse_conv3d, sparse_to_dense,
                               submanifold_conv3d)
from ..ops.vsa import furthest_point_sample, query_and_group
from ..parallel.mesh import world_of
from ..registry import MODELS
from .voxel_encoders import MaskedBatchNorm


class SparseConvBlock(nn.Module):
    """Sparse conv (weight ``(K, Cin, Cout)``, no bias) -> masked BN ->
    ReLU.  Sub-manifold for a 3 x 3 x 3 kernel at stride 1, else strided
    into ``out_capacity`` sites (the input's capacity when None)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), stride=1,
                 padding: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            int(np.prod(kernel)), in_channels, out_channels))
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, st: SparseTensor, out_capacity: Optional[int] = None,
                group=None) -> SparseTensor:
        """``group``: a strided conv's ``out_capacity`` is the global
        batch's (``ops/sparse_conv.py::sparse_conv3d``)."""
        if self.stride == 1 and self.kernel == (3, 3, 3):
            out = submanifold_conv3d(st, self.weight)
        else:
            out = sparse_conv3d(st, self.weight, self.stride,
                                out_capacity or st.feats.shape[0],
                                kernel_size=self.kernel,
                                padding=self.padding, group=group)
        valid = out.valid
        feats = torch.relu(self.bn(out.feats, valid)) * valid[:, None]
        return out._replace(feats=feats)


def _conv_out_dim(n: int, k: int = 3, s: int = 2, p: int = 1) -> int:
    return (n + 2 * p - k) // s + 1


@MODELS.register_module()
class MlvlSparseEncoder(nn.Module):
    """``max_voxels``: sites a sample; each strided level holds
    ``max_voxels`` x B (the JAX package's ``capacity`` for its batch).

    ``group`` (set with the BatchNorms' by ``mesh.sync_batchnorms``; None
    by default): in training, B is the global batch and each strided
    level truncates over the ranks in key order, batch first (one offset
    all-reduce a level), as the JAX package's sharded step; each level's
    ``overflow`` is then global.  Eval mode works on each rank's rows."""

    global_capacity = True

    def __init__(self, in_channels: int = 4,
                 sparse_shape: Sequence[int] = (41, 1600, 1408),
                 base_channels: int = 16,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
                 out_channels: int = 128, max_voxels: int = 16000):
        super().__init__()
        self.group = None
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.max_voxels = max_voxels
        self.names: List[List[str]] = []
        self.conv_input = SparseConvBlock(in_channels, base_channels)
        cin = base_channels
        z = self.sparse_shape[0]
        for i, stage in enumerate(encoder_channels):
            names = []
            for j, ch in enumerate(stage):
                if i > 0 and j == 0:
                    name = f'stage{i}_down'
                    block = SparseConvBlock(cin, ch, stride=2)
                    z = _conv_out_dim(z)
                else:
                    name = f'stage{i}_subm{j}'
                    block = SparseConvBlock(cin, ch)
                self.add_module(name, block)
                names.append(name)
                cin = ch
            self.names.append(names)
        self.level_channels = [stage[-1] for stage in encoder_channels]
        # z only, no padding (mmdet3d's SparseEncoder conv_out)
        self.conv_out = SparseConvBlock(cin, out_channels, kernel=(3, 1, 1),
                                        stride=(2, 1, 1), padding=(0, 0, 0))
        self.z_out = _conv_out_dim(z, 3, 2, 0)
        if self.z_out < 1:
            raise ValueError(
                f'sparse_shape z={self.sparse_shape[0]} collapses to '
                f'{self.z_out} slices after 3 stride-2 stages + pad-0 '
                f'(3,1,1)/(2,1,1) out conv; need z such that z//8 >= 3 '
                f'(e.g. 24 or 41)')
        self.bev_channels = self.z_out * out_channels

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                batch_size: int):
        """voxel_feats (V, C); voxel_coords (V, 4) (b, z, y, x), -1 rows.
        -> (levels: a SparseTensor per stage, bev (B, Y/8, X/8, Z' C))."""
        nz, ny, nx = self.sparse_shape
        group = self.group if self.training else None
        cap = self.max_voxels * batch_size * world_of(group)
        st = self.conv_input(make_sparse_tensor(
            voxel_feats, voxel_coords, (batch_size, nz, ny, nx)))
        levels = []
        for names in self.names:
            for name in names:
                st = getattr(self, name)(st, cap, group)
            levels.append(st)
        dense = sparse_to_dense(self.conv_out(st, cap, group))
        b, zo, yo, xo, c = dense.shape
        bev = dense.permute(0, 2, 3, 1, 4).reshape(b, yo, xo, zo * c)
        return levels, bev


class LinearBN(nn.Module):
    """Linear (no bias) -> :class:`MaskedBatchNorm` -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return torch.relu(self.norm(self.linear(x), mask))


def _sample_rows(mask: torch.Tensor) -> List[torch.Tensor]:
    """(B, N) bool -> each sample's row indices (ascending)."""
    counts = mask.sum(1).tolist()
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    return [order[b, :n] for b, n in enumerate(counts)]


class GuidedSAModuleMSG(nn.Module):
    """Multi-scale-group set abstraction.  ``in_channels``: the support
    features' channels (3 more go in with ``use_xyz``)."""

    def __init__(self, in_channels: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 use_xyz: bool = True, pool_method: str = 'max'):
        super().__init__()
        if pool_method not in ('max', 'avg'):
            raise ValueError(f'unknown pool_method {pool_method!r}')
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.use_xyz, self.pool_method = use_xyz, pool_method
        cin = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList()
        for mlp in mlps:
            layers, c = nn.ModuleList(), cin
            for ch in mlp:
                layers.append(LinearBN(c, ch))
                c = ch
            self.mlps.append(layers)
        self.out_channels = sum(mlp[-1] for mlp in mlps)

    def group(self, radius: float, nsample: int, support_xyz, support_feats,
              query_xyz, support_mask):
        """-> (grouped (B, M, K, C'), idx (B, M, K)).  A shared support
        (N, 3) with a per-sample mask (B, N) is queried a sample at a time
        on the sample's own rows (:meth:`_group_rows`); idx indexes the
        whole table.  Under ``torch.export``, whose shapes cannot follow a
        sample's row count, :meth:`_group_static` instead."""
        if support_xyz.dim() == 3:
            return query_and_group(radius, nsample, support_xyz, query_xyz,
                                   support_feats, support_mask,
                                   use_xyz=self.use_xyz)
        if torch.compiler.is_exporting():
            return self._group_static(radius, nsample, support_xyz,
                                      support_feats, query_xyz, support_mask)
        return self._group_rows(radius, nsample, support_xyz, support_feats,
                                query_xyz, support_mask)

    def _group_static(self, radius, nsample, support_xyz, support_feats,
                      query_xyz, support_mask):
        """Every sample queries the whole shared table under its mask, as
        the JAX module's vmap does: the same indices and rows as
        :meth:`_group_rows`, at B times the ball query's work
        (``pv_group_time.py`` times both forms)."""
        b = query_xyz.shape[0]
        return query_and_group(
            radius, nsample, support_xyz.expand(b, -1, -1), query_xyz,
            support_feats.expand(b, -1, -1), support_mask,
            use_xyz=self.use_xyz)

    def _group_rows(self, radius, nsample, support_xyz, support_feats,
                    query_xyz, support_mask):
        """Each sample queries its own rows of the shared table."""
        grouped, idx = [], []
        for b, rows in enumerate(_sample_rows(support_mask)):
            if rows.numel() == 0:       # an empty sample: every ball empty
                m = query_xyz.shape[1]
                c = support_feats.shape[-1] + (3 if self.use_xyz else 0)
                grouped.append(query_xyz.new_zeros((1, m, nsample, c)))
                idx.append(rows.new_full((1, m, nsample), -1))
                continue
            sx = support_xyz[rows][None]
            sf = support_feats[rows][None]
            g, i = query_and_group(radius, nsample, sx, query_xyz[b:b + 1],
                                   sf, use_xyz=self.use_xyz)
            grouped.append(g)
            idx.append(torch.where(i >= 0, rows[i.clamp(min=0)], -1))
        return torch.cat(grouped), torch.cat(idx)

    def forward(self, support_xyz, support_feats, query_xyz, support_mask):
        """support (B, N, 3) + (B, N, C), or a shared (N, 3) + (N, C);
        query (B, M, 3); mask (B, N) -> (B, M, sum of the last widths)."""
        outs = []
        for radius, nsample, layers in zip(self.radii, self.nsamples,
                                           self.mlps):
            y, idx = self.group(radius, nsample, support_xyz, support_feats,
                                query_xyz, support_mask)
            ok = idx >= 0
            for layer in layers:
                y = layer(y, ok)
            if self.pool_method == 'max':
                y = torch.amax(torch.where(ok[..., None], y, -1e4), dim=2)
                y = torch.where(ok.any(2)[..., None], y, 0.0)
            else:
                cnt = ok.sum(2).clamp(min=1)[..., None]
                y = (y * ok[..., None]).sum(2) / cnt
            outs.append(y)
        return torch.cat(outs, dim=-1)


def bilinear_sample_bev(bev: torch.Tensor, xy: torch.Tensor, pc_range,
                        cell_size, align: str = 'half',
                        base_cell_size=None) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) maps at metric xy (B, M, 2) ->
    (B, M, C).  The sample point is clamped into [0, W-1] and the left
    cell into [0, W-2] (the same in y).  ``'half'``: the corner cells'
    centres at +-0.5 of a scaled cell; ``'halfmin'``: top-left at 0.5 of
    the base cell, bottom-right at the scaled cell less 0.5 of it."""
    b, h, w, c = bev.shape
    dt, dev = xy.dtype, xy.device
    tl = torch.tensor(pc_range[:2], dtype=dt, device=dev)
    br = torch.tensor(pc_range[3:5], dtype=dt, device=dev)
    cs = torch.tensor(cell_size, dtype=dt, device=dev)
    if align == 'half':
        tl = tl + 0.5 * cs
        br = br - 0.5 * cs
    elif align == 'halfmin':
        base = torch.tensor(base_cell_size if base_cell_size is not None
                            else cell_size, dtype=dt, device=dev)
        tl = tl + 0.5 * base
        br = br - (cs - 0.5 * base)
    else:
        raise ValueError(f'unknown align mode {align!r}')
    u = (xy[..., 0] - tl[0]) / (br[0] - tl[0]) * (w - 1)
    v = (xy[..., 1] - tl[1]) / (br[1] - tl[1]) * (h - 1)
    u = torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_tensor(w - 1))
    v = torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_tensor(h - 1))
    u0 = torch.floor(u).to(torch.int32).clamp(0, w - 2)
    v0 = torch.floor(v).to(torch.int32).clamp(0, h - 2)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    flat = bev.reshape(b, h * w, c)

    def at(vv, uu):
        i = (vv * w + uu).long()[..., None].expand(-1, -1, c)
        return flat.gather(1, i)
    f00, f01 = at(v0, u0), at(v0, u0 + 1)
    f10, f11 = at(v0 + 1, u0), at(v0 + 1, u0 + 1)
    return ((1 - dv) * ((1 - du) * f00 + du * f01)
            + dv * ((1 - du) * f10 + du * f11))


@MODELS.register_module()
class VoxelSetAbstraction(nn.Module):
    """``point_channels``: channels of the raw points (xyz + the rest);
    ``bev_channels``: the BEV's, with ``bev_sa_config``."""

    def __init__(self, num_keypoints: int = 2048, out_channels: int = 128,
                 voxel_size: Sequence[float] = (0.05, 0.05, 0.1),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 voxel_sa_configs: Sequence[Dict[str, Any]] = (),
                 rawpoint_sa_config: Optional[Dict[str, Any]] = None,
                 bev_sa_config: Optional[Dict[str, Any]] = None,
                 point_channels: int = 4, bev_channels: int = 256,
                 voxel_center_align: str = 'half'):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_sa_configs = list(voxel_sa_configs)
        self.bev_sa_config = bev_sa_config
        self.voxel_center_align = voxel_center_align
        gathered = bev_channels if bev_sa_config is not None else 0
        self.rawpoints_sa = None
        if rawpoint_sa_config is not None:
            cfg = rawpoint_sa_config
            self.rawpoints_sa = GuidedSAModuleMSG(
                point_channels - 3, cfg['pool_radius'], cfg['samples'],
                cfg['mlps'])
            gathered += self.rawpoints_sa.out_channels
        for k, cfg in enumerate(self.voxel_sa_configs):
            sa = GuidedSAModuleMSG(cfg['in_channels'], cfg['pool_radius'],
                                   cfg['samples'], cfg['mlps'])
            self.add_module(f'voxel_sa_{k}', sa)
            gathered += sa.out_channels
        self.gathered_channels = gathered
        self.fusion = LinearBN(gathered, out_channels)

    def voxel_centers(self, coords_zyx: torch.Tensor,
                      scale_factor: float) -> torch.Tensor:
        """(V, 3) int (z, y, x) -> metric centres (V, 3)."""
        xyz = coords_zyx.flip(-1).float()
        dev = xyz.device
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
        ctr = xyz * vs * scale_factor + pcr
        if self.voxel_center_align == 'half':
            return ctr + 0.5 * vs * scale_factor
        return ctr + 0.5 * vs   # 'halfmin'

    def keypoints(self, points, points_mask):
        """-> (FPS indices (B, K), keypoints (B, K, 3))."""
        xyz = points[..., :3]
        idx = furthest_point_sample(xyz, self.num_keypoints, points_mask)
        return idx, xyz.gather(1, idx[..., None].expand(-1, -1, 3))

    def forward(self, levels: List[SparseTensor], points: torch.Tensor,
                points_mask: torch.Tensor, bev: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """points (B, N, 3 + C), levels (one per voxel SA config), bev
        (B, H, W, C) -> keypoints (B, K, 3), keypoint_features (B, K,
        gathered), fusion_keypoint_features (B, K, out)."""
        bsz = points.shape[0]
        kp_idx, keypoints = self.keypoints(points, points_mask)
        feats = []
        if self.bev_sa_config is not None and bev is not None:
            sf = self.bev_sa_config['scale_factor']
            cell = (self.voxel_size[0] * sf, self.voxel_size[1] * sf)
            base = (self.voxel_size[0], self.voxel_size[1])
            feats.append(bilinear_sample_bev(
                bev, keypoints[..., :2], self.point_cloud_range, cell,
                self.voxel_center_align, base))
        if self.rawpoints_sa is not None:
            feats.append(self.rawpoints_sa(points[..., :3], points[..., 3:],
                                           keypoints, points_mask))
        for k, cfg in enumerate(self.voxel_sa_configs):
            st = levels[k]
            centers = self.voxel_centers(st.coords[:, 1:4],
                                         cfg['scale_factor'])
            mask = st.valid[None, :] & (st.coords[None, :, 0] == torch.arange(
                bsz, device=st.coords.device)[:, None])
            feats.append(getattr(self, f'voxel_sa_{k}')(
                centers, st.feats, keypoints, mask))
        gathered = torch.cat(feats, dim=-1)
        return dict(keypoints=keypoints, keypoint_indices=kp_idx,
                    keypoint_features=gathered,
                    fusion_keypoint_features=self.fusion(gathered))
