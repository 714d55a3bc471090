"""PointPillars trunk: points -> pillar features -> BEV canvas -> SECOND
-> SECONDFPN -> head maps.

Port of ``mmdet3d_gaussian_tpu/models/detectors/voxelnet.py::
PointPillarsNet``, its hard, dynamic and MVF branches.  The batch is
flattened to one point axis with a batch-id coord column, so voxelization
of the whole batch is one sort (one a view for MVF).

* ``voxelize_mode='hard'`` (the default, the KITTI configs' mode): each
  pillar keeps its first ``max_points_per_voxel`` points, encoded by
  :class:`PillarFeatureNet` on the packed ``(V, P, C)`` table
  (``hard_encoder='packed'``) or by :class:`SortedPillarFeatureNet` on the
  rank-masked sorted rows through K1 (``'sorted'``), the same function.
  Pillars are compacted in canvas raster order and always splat onto the
  plain canvas (K2), as in the JAX package.
* ``voxelize_mode='dynamic'``: every point counts, one K1 pass per
  reduction.  The canvas is the space-to-depth canvas (``s2d_canvas``, on
  under ``'auto'`` for a stride-2 first stage on an even grid, as in the JAX
  package: voxels compacted on the s2d key, splat by K7, read by the folded
  stage-0 conv) or the plain canvas (voxels compacted in canvas raster
  order, ``CANVAS_KEY_ORDER``, splat by K2).
* ``voxelize_mode='mvf'``: the multi-view encoder
  (:class:`~..mvf_encoder.PillarMVFFeatureNet`, its ``encoder_cfg``) on
  view 0's pillars, always on the plain canvas (K2); ``hard_encoder`` and
  ``s2d_canvas`` have no effect.  The JAX package builds this branch's
  backbone, neck and head without a dtype, so an MVF trunk computes in f32
  whatever ``compute_dtype`` says, and so does the port.

``compute_dtype='bfloat16'`` is the JAX package's mixed precision: the
backbone, neck and head compute in bf16 on f32 parameters; the hard
encoders' linear layers compute in bf16 too (their rows come out bf16),
the dynamic encoder stays f32 and its rows are cast to bf16 before the
splat.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...engine.profiling import count, span
from ...ops.scatter import batch_coords, build_scatter, compute_voxel_coords
from ...ops.voxelize import (CANVAS_KEY_ORDER, bev_scatter, bev_scatter_s2d,
                             hard_kept_rows, hard_voxelize)
from ...parallel.mesh import world_of
from ...registry import MODELS
from ..backbones import SECOND, SECONDFPN, compute_dtype as _compute_dtype
from ..dense_heads.anchor3d_head import Anchor3DHeadConvs
from ..dense_heads.centerpoint_head import CenterHeadConvs
from ..mvf_encoder import PillarMVFFeatureNet
from ..voxel_encoders import (DynamicPillarFeatureNet, PillarFeatureNet,
                              SortedPillarFeatureNet)


@MODELS.register_module()
class PointPillarsNet(nn.Module):
    """Learned trunk; ``forward(points, points_mask)`` returns the head's
    NHWC maps: (cls_score, bbox_pred, dir_pred, packed) for
    ``head_type='anchor'``, a list of per-task dicts for ``'center'``
    (:class:`CenterHeadConvs` on the concatenated neck output).

    ``voxelize_mode``: ``'hard'`` (the default, as in the JAX package),
    ``'dynamic'`` or ``'mvf'`` (f32 whatever ``compute_dtype`` says).
    ``hard_encoder``
    (``'packed'``, the default, or ``'sorted'``) picks the hard branch's
    encoder.  ``s2d_canvas``: ``'auto'`` (on when the first stage has
    stride 2 and the grid is even), ``'on'`` or ``'off'``; it applies to
    the dynamic branch only, the hard branch always takes the plain canvas.
    ``fold_w2`` (the JAX package's W-folded stage 0 after the s2d canvas, a
    layout of the same function) is accepted so that a JAX config builds,
    and has no effect.  ``axis_name`` (the JAX trunk's cross-replica
    BatchNorm) is accepted and means what a data-parallel step does anyway:
    the detector's group (``parallel/mesh.py``) syncs every BatchNorm of
    the trunk, as GSPMD makes the JAX step's statistics global with or
    without it.

    ``group`` (set with the BatchNorms' by ``mesh.sync_batchnorms``; None
    by default): in training the ranks' points are rows of one global
    batch, and the voxel capacity is the global batch's,
    ``max_voxels_per_sample`` x the global B (or the MVF config's own
    ``max_voxels``), truncated in key order with the batch index first
    over all ranks (``build_scatter``'s ``group``), as the JAX package's
    sharded step, one program over the whole batch.  Eval mode (predict)
    works on each rank's own rows with its own capacity."""

    global_capacity = True

    def __init__(self, voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 max_points_per_voxel: int = 32,
                 max_voxels_per_sample: int = 16000,
                 voxelize_mode: str = 'hard',
                 head_type: str = 'anchor',
                 encoder_cfg: Optional[Dict[str, Any]] = None,
                 backbone_cfg: Optional[Dict[str, Any]] = None,
                 neck_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 compute_dtype: Optional[str] = None,
                 s2d_canvas: str = 'auto',
                 fold_w2: bool = True,
                 hard_encoder: str = 'packed',
                 axis_name: Optional[str] = None):
        super().__init__()
        self.group = None
        if voxelize_mode not in ('hard', 'dynamic', 'mvf'):
            raise ValueError(f'voxelize_mode must be hard, dynamic or mvf, '
                             f'got {voxelize_mode!r}')
        if hard_encoder not in ('packed', 'sorted'):
            raise ValueError(f'hard_encoder must be packed or sorted, got '
                             f'{hard_encoder!r}')
        if head_type not in ('anchor', 'center'):
            raise ValueError(f'head_type must be anchor or center, got '
                             f'{head_type!r}')
        if s2d_canvas not in ('auto', 'on', 'off'):
            raise ValueError(f's2d_canvas must be auto, on or off, got '
                             f'{s2d_canvas!r}')
        dt = _compute_dtype(compute_dtype)
        if voxelize_mode == 'mvf':
            dt = None       # the JAX branch passes no dtype on
        self.compute_dtype = dt
        self.voxelize_mode = voxelize_mode
        self.hard_encoder = hard_encoder
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_points_per_voxel = max_points_per_voxel
        self.max_voxels_per_sample = max_voxels_per_sample
        self.nx, self.ny = self._grid()
        nz = max(1, int(round((self.point_cloud_range[5]
                               - self.point_cloud_range[2])
                              / self.voxel_size[2])))
        if nz != 1:
            raise ValueError('PointPillars needs one voxel in z (pillars); '
                             f'got {nz}')
        bb_cfg = dict(backbone_cfg or {})
        first_stride = tuple(bb_cfg.get('layer_strides', (2, 2, 2)))[0]
        self.s2d = voxelize_mode == 'dynamic' and (
            s2d_canvas == 'on'
            or (s2d_canvas == 'auto' and first_stride == 2
                and self.nx % 2 == 0 and self.ny % 2 == 0))
        enc_cfg = dict(encoder_cfg or {})
        enc_cfg.setdefault('voxel_size', self.voxel_size)
        enc_cfg.setdefault('point_cloud_range', self.point_cloud_range)
        if voxelize_mode == 'mvf':
            self.voxel_encoder = PillarMVFFeatureNet(**(encoder_cfg or {}))
            # a max_voxels in the config wins, as in the JAX package
            self.mvf_max_voxels = (encoder_cfg or {}).get('max_voxels')
            # the canvas is view 0's
            self.nx, self.ny = self.voxel_encoder.canvas_size()
        elif voxelize_mode == 'hard':
            encoder = (SortedPillarFeatureNet if hard_encoder == 'sorted'
                       else PillarFeatureNet)
            self.voxel_encoder = encoder(dtype=dt, **enc_cfg)
        else:
            self.voxel_encoder = DynamicPillarFeatureNet(**enc_cfg)
        self.backbone = SECOND(input_s2d=self.s2d, dtype=dt, **bb_cfg)
        self.head_type = head_type
        neck_kw = dict(neck_cfg or {})
        if head_type == 'anchor':
            # the anchor head's 1x1 convs read the branches unconcatenated
            neck_kw.setdefault('concat_out', False)
            head = Anchor3DHeadConvs
        else:
            head = CenterHeadConvs
        self.neck = SECONDFPN(dtype=dt, **neck_kw)
        self.bbox_head = head(dtype=dt, **(head_cfg or {}))

    def grid(self) -> Tuple[int, int]:
        """(nx, ny) of the BEV canvas."""
        return self.nx, self.ny

    def _grid(self) -> Tuple[int, int]:
        pcr, vs = self.point_cloud_range, self.voxel_size
        nx = int(round((pcr[3] - pcr[0]) / vs[0]))
        ny = int(round((pcr[4] - pcr[1]) / vs[1]))
        return nx, ny

    def pillars(self, points: torch.Tensor, points_mask: torch.Tensor):
        """points (B, N, C), points_mask (B, N) -> (pillar features
        (max_voxels, C_out), voxel coords (max_voxels, 4), the Scatter).
        Coords are (b, ix, iy, iz) on the plain canvas and (b, iy // 2,
        ix // 2, (iy & 1) * 2 + (ix & 1)) on the s2d canvas, voxels
        compacted in that canvas's raster order.  The features are f32, or
        bf16 from a hard encoder computing in bf16.  For MVF the Scatter is
        view 0's and the points stay in their order.  In training under
        a group the capacity is the global batch's (class docstring).
        Spans ``voxelize`` and ``encoder`` (MVF's encoder voxelizes too),
        and counts the Scatter's live and dropped pillars
        (``pillars.live``, ``pillars.dropped``; ``engine/profiling.py``)."""
        b, n, cdim = points.shape
        group = self.group if self.training else None
        max_voxels = self.max_voxels_per_sample * b * world_of(group)
        if self.voxelize_mode == 'mvf':
            with span('encoder'):
                out = self.voxel_encoder(points, points_mask,
                                         self.mvf_max_voxels or max_voxels,
                                         group)
        elif self.voxelize_mode == 'hard':
            out = self._hard_pillars(points, points_mask, max_voxels, group)
        else:
            out = self._dynamic_pillars(points, points_mask, max_voxels,
                                        group)
        count('pillars.live', out[2].num_live)
        count('pillars.dropped', out[2].num_overflow)
        return out

    def _coords(self, points, points_mask):
        """-> (the batch's points flattened (B N, C), their (b, ix, iy, iz)
        coords, -1 rows out of range or masked)."""
        b, n, cdim = points.shape
        flat = points.reshape(b * n, cdim)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=points.device).repeat_interleave(n)
        coords3, _ = compute_voxel_coords(flat[:, :3], self.point_cloud_range,
                                          self.voxel_size)
        coords3 = torch.where(points_mask.reshape(-1, 1), coords3, -1)
        return flat, batch_coords(coords3, batch_idx)

    def _dynamic_pillars(self, points, points_mask, max_voxels, group):
        """The dynamic branch of :meth:`pillars`."""
        b = points.shape[0]
        with span('voxelize'):
            flat, coords4 = self._coords(points, points_mask)
            if self.s2d:
                # s2d cell raster order, parity minor: the pair splat's ids
                # are then non-decreasing; the key is bijective with the
                # pillars
                iy, ix = coords4[:, 2], coords4[:, 1]
                s2d_cols = torch.stack([coords4[:, 0], iy // 2, ix // 2,
                                        (iy & 1) * 2 + (ix & 1)], dim=1)
                coords4 = torch.where((coords4 < 0).any(-1, keepdim=True),
                                      -1, s2d_cols)
                scatter = build_scatter(coords4, (b, self.ny // 2,
                                                  self.nx // 2, 4),
                                        max_voxels, group=group)
            else:
                scatter = build_scatter(coords4, (b, self.nx, self.ny, 1),
                                        max_voxels,
                                        key_order=CANVAS_KEY_ORDER,
                                        group=group)
            # permute points into voxel-sorted order once; every reduction
            # in the encoder then runs over contiguous segments
            flat_sorted = flat[scatter.sort_order]
        with span('encoder'):
            feats = self.voxel_encoder(flat_sorted, scatter.sorted_view())
        return feats, scatter.voxel_coords, scatter

    def _hard_pillars(self, points, points_mask, max_voxels, group):
        """The hard branch of :meth:`pillars`, pillars compacted in canvas
        raster order."""
        b = points.shape[0]
        spatial = (b, self.nx, self.ny, 1)
        max_points = self.max_points_per_voxel
        if self.hard_encoder == 'sorted':
            with span('voxelize'):
                flat, coords4 = self._coords(points, points_mask)
                scatter = build_scatter(coords4, spatial, max_voxels,
                                        key_order=CANVAS_KEY_ORDER,
                                        group=group)
                sv = scatter.sorted_view()
                kept = hard_kept_rows(sv.point_voxel_ids, max_voxels,
                                      max_points)
                kept_cnt = scatter.voxel_counts.clamp(max=max_points)
                flat_sorted = flat[scatter.sort_order]
            with span('encoder'):
                feats = self.voxel_encoder(flat_sorted, sv, kept, kept_cnt,
                                           max_points)
            return feats, scatter.voxel_coords, scatter
        with span('voxelize'):
            flat, coords4 = self._coords(points, points_mask)
            # mask_slots=False: the encoder multiplies its input by the
            # slot mask, so what the table holds past num_points never
            # counts
            hv = hard_voxelize(flat, coords4, spatial, max_points,
                               max_voxels, key_order=CANVAS_KEY_ORDER,
                               mask_slots=False, group=group)
        with span('encoder'):
            feats = self.voxel_encoder(hv.voxels, hv.coords, hv.num_points)
        return feats, hv.coords, hv.scatter

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor):
        pillar_feats, coords_v, _ = self.pillars(points, points_mask)
        b = points.shape[0]
        with span('canvas'):
            if self.compute_dtype is not None:
                # every live cell receives one row, so casting the rows is
                # casting the canvas (a no-op for a hard encoder's bf16
                # rows)
                pillar_feats = pillar_feats.to(self.compute_dtype)
            if self.s2d:
                canvas = bev_scatter_s2d(pillar_feats, coords_v, b,
                                         self.nx // 2, self.ny // 2)
            else:
                canvas = bev_scatter(pillar_feats, coords_v, b, self.nx,
                                     self.ny)
        with span('backbone'):
            feats = self.backbone(canvas)
        with span('neck'):
            feats = self.neck(feats)
        with span('head'):
            return self.bbox_head(feats)
