"""CenterPoint heads: multi-task heatmap detection.

Port of ``mmdet3d_gaussian_tpu/models/dense_heads/centerpoint_head.py``:

* :class:`ConvDS`, :class:`SeparateHead`, :class:`CenterHeadConvs` — the
  conv towers as ``nn.Module``s, NHWC in and NHWC out (NCHW views of
  channels-last memory inside).  Every BatchNorm is the port's
  :class:`~mmdet3d_gaussian_tpu_torch.models.backbones.BatchNorm2d` (K4 in
  training, momentum 0.99 in the flax convention, eps 1e-3).  Names follow
  mmdet3d's state_dict: ``shared_conv.{conv,bn}``,
  ``task_heads.{t}.{name}.{j}.{conv,bn}`` and the output conv
  ``task_heads.{t}.{name}.{n}``.
* :class:`CenterHead` — the task math, for a whole batch at once (the JAX
  package vmaps one sample at a time): targets (heatmap splat and
  ``max_objs`` padded slots a task), the losses (GaussianFocal heatmap and
  L1 on the code, or in ``yaw_mode`` the GD loss on decoded boxes beside
  L1 on the other channels) and decode with NMS.  Decode runs each step
  once over every (sample, task) problem of a batch, K5 and K6 included,
  and copies nothing from the host, so it never makes the host wait.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import losses as _losses  # noqa: F401  (registers the losses)
from ..backbones import (BatchNorm2d, Conv2d, compute_dtype, nchw_to_nhwc,
                         nhwc_to_nchw)
from ...core.bbox.coders import CenterPointBBoxCoder, CenterPointBBoxYawCoder
from ...engine.profiling import span
from ...ops.heatmap import gaussian_radius, splat_heatmap
from ...ops.nms import circle_nms, nms_bev, top_k
from ...registry import LOSSES, MODELS

HEATMAP_BIAS = -2.19    # the heatmap output's initial bias (focal prior)


class ConvDS(nn.Module):
    """Depthwise-separable conv: a depthwise k x k conv without bias, then
    a 1x1 conv with bias, both in f32 (the JAX module gives them no
    dtype, so a bf16 input is promoted)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.chn_conv = nn.Conv2d(in_channels, in_channels, kernel,
                                  padding=kernel // 2, groups=in_channels,
                                  bias=False)
        self.dep_conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dep_conv(self.chn_conv(x.float()))


class ConvBN(nn.Module):
    """A 3x3 conv without bias (or :class:`ConvDS`), BatchNorm and ReLU;
    the output in the compute dtype."""

    def __init__(self, cin: int, cout: int, use_ds_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = (ConvDS(cin, cout) if use_ds_conv else
                     Conv2d(cin, cout, 3, padding=1, bias=False,
                            compute_dtype=dtype))
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x)))
        # a ConvDS tower is f32 up to here; the JAX BatchNorm rounds its
        # output to the compute dtype (ReLU commutes with the rounding)
        return y if self.dtype is None else y.to(self.dtype)


class SeparateHead(nn.Module):
    """Per branch ``name -> (out_ch, num_convs)``: ``num_convs - 1``
    :class:`ConvBN` of ``head_conv`` channels, then a 3x3 output conv with
    bias (``init_bias`` for the heatmap, 0 otherwise at init)."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, init_bias: float = HEATMAP_BIAS,
                 use_ds_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = dict(heads)
        self.init_bias = init_bias
        for name, (out_ch, num_convs) in self.heads.items():
            layers, cin = [], in_channels
            for _ in range(num_convs - 1):
                layers.append(ConvBN(cin, head_conv, use_ds_conv, dtype))
                cin = head_conv
            layers.append(Conv2d(cin, out_ch, 3, padding=1,
                                 compute_dtype=dtype))
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x NCHW -> {name: NHWC map}."""
        return {name: nchw_to_nhwc(getattr(self, name)(x))
                for name in self.heads}


@MODELS.register_module()
class CenterHeadConvs(nn.Module):
    """Shared 3x3 conv + BN + ReLU, then one :class:`SeparateHead` a task
    (its heads: ``common_heads`` and ``heatmap`` of the task's classes).
    ``forward`` takes the NHWC neck output and returns a list of per-task
    dicts of NHWC maps."""

    def __init__(self, tasks: Sequence[Dict[str, Any]],
                 in_channels: int = 384, share_conv_channel: int = 64,
                 common_heads: Optional[Dict[str, Tuple[int, int]]] = None,
                 head_conv: int = 64, use_ds_conv: bool = False,
                 dtype: Optional[str] = None):
        super().__init__()
        dt = compute_dtype(dtype)
        self.shared_conv = ConvBN(in_channels, share_conv_channel, dtype=dt)
        heads = []
        for task in tasks:
            h = dict(common_heads or {})
            h['heatmap'] = (task['num_classes'], 2)
            heads.append(SeparateHead(share_conv_channel, h, head_conv,
                                      use_ds_conv=use_ds_conv, dtype=dt))
        self.task_heads = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        y = self.shared_conv(nhwc_to_nchw(x))
        return [head(y) for head in self.task_heads]


class CenterHead:
    """Task math of the CenterPoint head family (the conv parameters live
    in :class:`CenterHeadConvs`).  ``yaw_mode=False``: sin/cos ``rot``
    branch, L1 on the whole code; ``yaw_mode=True`` (CenterGDHead): a raw
    ``yaw`` and a sin/cos ``dir`` branch, the GD loss on decoded boxes and
    L1 on the channels after the box."""

    def __init__(self, tasks: Sequence[Dict[str, Any]],
                 pc_range, voxel_size, out_size_factor: int = 2,
                 code_weights: Optional[Sequence[float]] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_gd: Optional[dict] = None,
                 yaw_mode: bool = False, with_vel: bool = False,
                 max_objs: int = 100,
                 gaussian_overlap: float = 0.1, min_radius: float = 2.0,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.tasks = list(tasks)
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.out_size_factor = out_size_factor
        self.yaw_mode = yaw_mode
        self.with_vel = with_vel
        self.max_objs = max_objs
        self.gaussian_overlap = gaussian_overlap
        self.min_radius = min_radius
        self.code_size = (9 if yaw_mode else 8) + (2 if with_vel else 0)
        coder_cls = (CenterPointBBoxYawCoder if yaw_mode
                     else CenterPointBBoxCoder)
        self.coder = coder_cls(pc_range=pc_range, voxel_size=voxel_size,
                               out_size_factor=out_size_factor,
                               code_size=self.code_size)
        self.loss_cls = LOSSES.build(
            loss_cls or dict(type='GaussianFocalLoss', loss_weight=1.0))
        self.loss_bbox = LOSSES.build(
            loss_bbox or dict(type='L1Loss', loss_weight=0.25))
        self.loss_gd = LOSSES.build(loss_gd) if loss_gd else None
        self.code_weights = code_weights
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        # class -> (task, class in the task)
        self._task_of = [(t, c) for t, task in enumerate(self.tasks)
                         for c in range(task['num_classes'])]

    @property
    def common_heads(self) -> Dict[str, Tuple[int, int]]:
        heads = dict(reg=(2, 2), height=(1, 2), dim=(3, 2))
        if self.yaw_mode:
            heads.update(yaw=(1, 2), dir=(2, 2))
        else:
            heads.update(rot=(2, 2))
        if self.with_vel:
            heads.update(vel=(2, 2))
        return heads

    # ------------------------------------------------------------------
    def get_targets(self, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_valid: torch.Tensor, featmap_size: Tuple[int, int]
                    ) -> List[Dict[str, torch.Tensor]]:
        """gt_bboxes (B, G, 7+), gt_labels (B, G) int, gt_valid (B, G) bool
        -> per task: heatmap (B, C_t, H, W) f32, anno (B, K, code) f32,
        inds (B, K, 2) int32 (x, y) cells, mask (B, K) bool, with K =
        min(max_objs, G) slots holding the task's objects in index order."""
        h, w = featmap_size
        dev = gt_bboxes.device
        task_of = torch.tensor([t for t, _ in self._task_of], device=dev)
        cls_of = torch.tensor([c for _, c in self._task_of], device=dev)
        lab = gt_labels.long().clamp(0, len(self._task_of) - 1)
        gt_task, gt_cls = task_of[lab], cls_of[lab]

        ix, iy, codes = self.coder.encode(gt_bboxes)
        width = gt_bboxes[..., 3] / (self.voxel_size[0]
                                     * self.out_size_factor)
        length = gt_bboxes[..., 4] / (self.voxel_size[1]
                                      * self.out_size_factor)
        in_map = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ok = gt_valid & in_map & (width > 0) & (length > 0)
        radius = gaussian_radius((length, width),
                                 min_overlap=self.gaussian_overlap)
        radius = torch.clamp(torch.floor(radius), min=self.min_radius)

        g = gt_bboxes.shape[1]
        k = min(self.max_objs, g)
        centers = torch.stack([ix, iy], -1)
        rank = torch.arange(g, device=dev).expand_as(ok)
        out = []
        for t, task in enumerate(self.tasks):
            sel = ok & (gt_task == t)
            heat = splat_heatmap(centers, radius, gt_cls, sel,
                                 task['num_classes'], h, w)
            # this task's objects into the first slots, in index order
            order = torch.argsort(torch.where(sel, rank, g + 1), dim=1,
                                  stable=True)[:, :k]
            slot_valid = torch.gather(sel, 1, order)
            rows = order[..., None]
            out.append(dict(
                heatmap=heat,
                anno=torch.where(slot_valid[..., None], torch.gather(
                    codes, 1, rows.expand(-1, -1, codes.shape[-1])), 0.0),
                inds=torch.where(slot_valid[..., None], torch.gather(
                    centers, 1, rows.expand(-1, -1, 2)), 0),
                mask=slot_valid))
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _gather_cells(featmap: torch.Tensor, inds: torch.Tensor
                      ) -> torch.Tensor:
        """featmap (B, H, W, C), inds (B, K, 2) as (x, y) -> (B, K, C)."""
        b = torch.arange(featmap.shape[0], device=featmap.device)[:, None]
        return featmap[b, inds[..., 1].long(), inds[..., 0].long()]

    def _code_branches(self) -> List[str]:
        """The branches whose channels make the coder's code, in order."""
        names = ['reg', 'height', 'dim']
        names += ['yaw', 'dir'] if self.yaw_mode else ['rot']
        if self.with_vel:
            names.append('vel')
        return names

    def _reconstruct(self, pred: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Branch maps -> the coder's code layout, NHWC f32."""
        return torch.cat([pred[n].float() for n in self._code_branches()],
                         dim=-1)

    def _weights(self, mask: torch.Tensor, first: int) -> torch.Tensor:
        """(B, K) slot mask -> per-channel L1 weights of code channels
        ``first:``.  ``code_weights`` must have one entry a code channel,
        as the JAX package's broadcast requires (it raises otherwise)."""
        w = mask.float()[..., None]
        if self.code_weights is None:
            return w
        if len(self.code_weights) != self.code_size:
            raise ValueError(
                f'code_weights has {len(self.code_weights)} entries but the '
                f'box code has {self.code_size} channels (yaw_mode='
                f'{self.yaw_mode}, with_vel={self.with_vel})')
        return w * torch.tensor(self.code_weights[first:],
                                dtype=torch.float32, device=mask.device)

    def loss(self, preds: List[Dict[str, torch.Tensor]],
             targets: List[Dict[str, torch.Tensor]], group=None
             ) -> Dict[str, torch.Tensor]:
        """preds: per-task dicts of (B, H, W, C) maps; targets from
        :meth:`get_targets`.  -> {task{t}.loss_heatmap, task{t}.loss_bbox}
        or in ``yaw_mode`` with ``loss_gd`` {..loss_heatmap, ..loss_gd,
        ..loss_l1}.  Each task's heatmap normalizer ``num_pos`` and box
        normalizer ``npos`` are clamped at 1; under ``group`` (a
        ``parallel.mesh.Group``) they are summed over the ranks first (no
        gradient), so each rank's terms are its share of the whole
        batch's."""
        losses = {}
        for t, pred in enumerate(preds):
            tgt = targets[t]
            heat_pred = torch.sigmoid(pred['heatmap'].float()).clamp(
                1e-4, 1 - 1e-4)
            heat_tgt = tgt['heatmap'].permute(0, 2, 3, 1)
            num_pos = (heat_tgt == 1.0).sum().float()
            mask = tgt['mask']
            npos = mask.float().sum()
            if group is not None:
                from ...parallel.mesh import all_reduce_sum
                num_pos, npos = all_reduce_sum([num_pos, npos], group)
            num_pos, npos = num_pos.clamp(min=1.0), npos.clamp(min=1.0)
            losses[f'task{t}.loss_heatmap'] = self.loss_cls(
                heat_pred, heat_tgt, avg_factor=num_pos)

            gathered = self._gather_cells(self._reconstruct(pred),
                                          tgt['inds'])
            ix, iy = tgt['inds'][..., 0], tgt['inds'][..., 1]
            if self.yaw_mode and self.loss_gd is not None:
                # the reference's z quirk, kept: it hands GDLoss the raw
                # gravity-centre z and GDLoss's centre offset (0, 0, 0.5)
                # adds h/2 again; decode_cells gives the bottom z, so h/2
                # is added back here
                def raw_z(boxes):
                    return torch.cat([
                        boxes[..., :2],
                        (boxes[..., 2] + boxes[..., 5] * 0.5)[..., None],
                        boxes[..., 3:]], -1)

                dec = raw_z(self.coder.decode_cells(
                    gathered, ix, iy, correct_yaw=False)[..., :7])
                tgt_dec = raw_z(self.coder.decode_cells(
                    tgt['anno'], ix, iy, correct_yaw=False)[..., :7])
                losses[f'task{t}.loss_gd'] = self.loss_gd(
                    dec.reshape(-1, 7), tgt_dec.reshape(-1, 7),
                    weight=mask.float().reshape(-1), avg_factor=npos)
                losses[f'task{t}.loss_l1'] = self.loss_bbox(
                    gathered[..., 7:], tgt['anno'][..., 7:],
                    weight=self._weights(mask, 7), avg_factor=npos)
            else:
                losses[f'task{t}.loss_bbox'] = self.loss_bbox(
                    gathered, tgt['anno'], weight=self._weights(mask, 0),
                    avg_factor=npos)
        return losses

    # ------------------------------------------------------------------
    def _class_slots(self, device: torch.device):
        """The tasks' classes in a (T, C_max) grid, a task with fewer
        classes padded at the end.  -> (labels (T, C_max) int32: each
        slot's class in the whole head, -1 on padding; the widths C_t).
        Made on the device from ``arange`` and ``full`` alone: no data
        crosses from the host."""
        widths = [task['num_classes'] for task in self.tasks]
        c_max = max(widths)
        ids = torch.arange(sum(widths), dtype=torch.int32, device=device)
        pad = torch.full((c_max,), -1, dtype=torch.int32, device=device)
        rows, first = [], 0
        for n in widths:
            rows += [ids[first:first + n], pad[:c_max - n]]
            first += n
        return torch.cat(rows).view(len(widths), c_max), widths

    def select_best(self, preds: List[Dict[str, torch.Tensor]], k: int):
        """Top k cells of each class, then the top k of those (``lax.top_k``
        order), of every (sample, task) problem in one pass.  The tasks'
        sigmoid heatmaps lie side by side in (B, T, C_max, HW), a padded
        class scoring -1, under any sigmoid output, so it is never among a
        task's top k; the code channels are gathered at the chosen cells
        only, one branch of every task at a time.  -> scores (B, T, k),
        labels (B, T, k) int32 (classes of the whole head), cells
        (B, T, k) as y * W + x, codes (B, T, k, code) f32."""
        b, h, w, _ = preds[0]['heatmap'].shape
        slots, widths = self._class_slots(preds[0]['heatmap'].device)
        n_task, c_max = slots.shape
        filler = preds[0]['heatmap'].new_zeros((b, h, w, 1))
        maps = []
        for pred, n in zip(preds, widths):
            maps += [pred['heatmap']] + [filler] * (c_max - n)
        heat = torch.where(slots.view(-1) >= 0,
                           torch.sigmoid(torch.cat(maps, -1).float()), -1.0)
        flat = heat.reshape(b, h * w, n_task, c_max).permute(0, 2, 3, 1)
        top_s, top_i = top_k(flat, k)                  # (B, T, C_max, k)
        scores, i2 = top_k(top_s.reshape(b, n_task, -1), k)
        cls = i2 // k
        labels = torch.gather(slots.expand(b, -1, -1), 2, cls)
        cells = torch.gather(top_i.reshape(b, n_task, -1), 2, i2)
        codes = []
        for name in self._code_branches():
            branch = torch.cat([pred[name] for pred in preds], -1)
            c = branch.shape[-1] // n_task
            codes.append(torch.gather(
                branch.reshape(b, h * w, n_task, c), 1,
                cells.transpose(1, 2)[..., None].expand(-1, -1, -1, c)
            ).float())
        codes = torch.cat(codes, -1).transpose(1, 2)
        return scores, labels, cells, codes

    def get_bboxes(self, preds: List[Dict[str, torch.Tensor]]):
        """Batched decode + NMS -> fixed-size merged detections: boxes
        (B, M, 7+), scores (B, M), labels (B, M) int32, valid (B, M) bool,
        M = min(post_max_size, tasks x max_per_img).  Every step runs once
        over all B x tasks problems, and nothing crosses from the host to
        the device, so the host never waits for the card here.  Rotated
        NMS is one launch of K5 and one of K6; circle NMS one K6 launch
        for each distinct per-task radius."""
        cfg = self.test_cfg
        k = int(cfg.get('max_per_img', 128))
        score_thr = float(cfg.get('score_threshold', 0.1))
        nms_type = cfg.get('nms_type', 'rotate')
        post_range = cfg.get('post_center_limit_range')

        scores, labels, cells, codes = self.select_best(preds, k)
        w = preds[0]['heatmap'].shape[2]
        boxes = self.coder.decode_cells(codes, cells % w, cells // w)
        valid = scores >= score_thr
        if post_range is not None:
            # lo <= x <= hi in f32, as a clamp that leaves x as it is (a
            # NaN centre fails both)
            for c in range(3):
                centre = boxes[..., c]
                valid &= centre.clamp(float(post_range[c]),
                                      float(post_range[c + 3])) == centre
        order = torch.argsort(-torch.where(valid, scores, -torch.inf),
                              dim=-1, stable=True)
        boxes = torch.gather(
            boxes, 2, order[..., None].expand(-1, -1, -1, boxes.shape[-1]))
        scores = torch.gather(scores, 2, order)
        labels = torch.gather(labels, 2, order)
        valid = torch.gather(valid, 2, order)
        b, n_task = scores.shape[:2]
        if nms_type == 'circle':
            # mmdet3d's test_cfg gives min_radius a task (a list); a
            # scalar applies to every task.  Each distinct radius runs
            # over every problem; each task keeps its own radius's mask.
            mr = cfg.get('min_radius_task', cfg.get('min_radius', 4.0))
            radii = [float(v) for v in (mr if isinstance(mr, (list, tuple))
                                        else [mr] * n_task)]
            distinct = sorted(set(radii))
            keeps = []
            for r in distinct:
                with span('nms'):
                    keeps.append(circle_nms(
                        boxes[..., :2].reshape(-1, k, 2), r,
                        valid.reshape(-1, k)).view(b, n_task, k))
            keep = keeps[0]
            if len(distinct) > 1:
                ids = torch.arange(len(distinct), device=keep.device)
                which = torch.cat([ids[i:i + 1] for i in
                                   map(distinct.index, radii)])
                keep = torch.gather(torch.stack(keeps), 0, which.view(
                    1, 1, n_task, 1).expand(1, b, -1, k))[0]
        else:
            bev = torch.cat([boxes[..., 0:2], boxes[..., 3:5],
                             boxes[..., 6:7]], -1).reshape(b * n_task, k, 5)
            with span('nms'):
                keep = nms_bev(bev, float(cfg.get('nms_thr', 0.2)),
                               valid.reshape(b * n_task, k)).reshape(
                                   b, n_task, k)
        kept = torch.where(keep, scores, -1.0).reshape(b, n_task * k)
        max_num = min(int(cfg.get('post_max_size', 83)), n_task * k)
        final, idx = top_k(kept, max_num)
        boxes = torch.gather(boxes.reshape(b, n_task * k, -1), 1,
                             idx[..., None].expand(-1, -1, boxes.shape[-1]))
        labels = torch.gather(labels.reshape(b, -1), 1, idx)
        return boxes, final, labels, final > score_thr


@MODELS.register_module('CenterHead')
def build_center_head(**kwargs):
    return CenterHead(**kwargs)


@MODELS.register_module('CenterGDHead')
def build_center_gd_head(**kwargs):
    kwargs.setdefault('yaw_mode', True)
    return CenterHead(**kwargs)
