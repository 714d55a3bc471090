"""Reference PointPillars with the GD anchor head (KITTI 3-class): hard
voxelize, the pillar feature net, the BEV canvas, SECOND, SECONDFPN, the
1x1 head convs, anchors, MaxIoU targets, the focal, KLD and direction
losses and AdamW with the config's clipping and one-cycle schedules.

Parameter names follow the mmdet3d state_dict, so the benchmark's weights
load by name."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from . import boxes as bx
from .layers import SECOND, SECONDFPN, Linear, RowBatchNorm
from .losses import cross_entropy, focal_sum, gd_distance

PRIOR = 0.01
# the frames whose anchor targets are assigned at once
TARGET_FRAMES = 12


class PFNLayer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear = Linear(cin, cout, bias=False)
        self.norm = RowBatchNorm(cout)


class Encoder(nn.Module):
    def __init__(self, cin, feat_channels):
        super().__init__()
        self.pfn_layers = nn.ModuleList([PFNLayer(cin, feat_channels[0])])


class HeadConvs(nn.Module):
    def __init__(self, num_classes, num_anchors, feat_channels):
        super().__init__()
        self.conv_cls = nn.Conv2d(feat_channels, num_anchors * num_classes, 1)
        self.conv_reg = nn.Conv2d(feat_channels, num_anchors * 7, 1)
        self.conv_dir_cls = nn.Conv2d(feat_channels, num_anchors * 2, 1)


class PointPillars(nn.Module):
    """The trunk and the head math of one configuration (its ``model`` and
    ``head`` dicts)."""

    def __init__(self, model: Dict, head: Dict):
        super().__init__()
        self.cfg, self.head_cfg = model, head
        enc = model['encoder_cfg']
        self.voxel_encoder = Encoder(enc['in_channels'] + 6,
                                     enc['feat_channels'])
        self.backbone = SECOND(**model['backbone_cfg'])
        nk = dict(model['neck_cfg'])
        self.neck = SECONDFPN(nk['in_channels'], nk['out_channels'],
                              nk['upsample_strides'])
        hc = model['head_cfg']
        self.bbox_head = HeadConvs(hc['num_classes'], hc['num_anchors'],
                                   hc['feat_channels'])
        pcr, vs = model['point_cloud_range'], model['voxel_size']
        self.nx = int(round((pcr[3] - pcr[0]) / vs[0]))
        self.ny = int(round((pcr[4] - pcr[1]) / vs[1]))

    # ---------------------------------------------------------------- voxels
    def voxelize(self, points, mask):
        """-> table (V, P, C), slot mask (V, P), cell (V, 3) (b, iy, ix) of
        the kept pillars: in (b, iy, ix) order, the first
        ``max_voxels_per_sample x B`` of the batch, each with its first
        ``max_points_per_voxel`` points by index."""
        b, n, c = points.shape
        pcr = torch.tensor(self.cfg['point_cloud_range'], device=points.device)
        vs = torch.tensor(self.cfg['voxel_size'], device=points.device)
        flat = points.reshape(-1, c)
        grid = torch.floor((pcr[3:] - pcr[:3]) / vs + 0.5).long()
        ijk = torch.floor((flat[:, :3] - pcr[:3]) / vs).long()
        ok = mask.reshape(-1) & ((ijk >= 0) & (ijk < grid)).all(-1)
        bidx = torch.arange(b, device=points.device).repeat_interleave(n)
        key = (bidx * self.ny + ijk[:, 1]) * self.nx + ijk[:, 0]
        key = torch.where(ok, key, torch.full_like(key, 2 ** 62))
        skey, order = torch.sort(key, stable=True)
        live = skey < 2 ** 62
        new = torch.ones_like(live)
        new[1:] = skey[1:] != skey[:-1]
        vid = torch.cumsum(new.long(), 0) - 1
        first_row = torch.cummax(torch.where(new, torch.arange(
            len(skey), device=skey.device), 0), 0).values
        rank = torch.arange(len(skey), device=skey.device) - first_row
        cap = self.cfg['max_voxels_per_sample'] * b
        pmax = self.cfg['max_points_per_voxel']
        kept = live & (vid < cap) & (rank < pmax)
        nv = int(vid[live].max().item()) + 1 if bool(live.any()) else 0
        nv = min(nv, cap)
        table = points.new_zeros((nv, pmax, c))
        slot = torch.zeros((nv, pmax), dtype=torch.bool, device=points.device)
        rows = order[kept]
        table[vid[kept], rank[kept]] = flat[rows]
        slot[vid[kept], rank[kept]] = True
        keys = skey[new & live][:nv]
        cell = torch.stack([keys // (self.ny * self.nx),
                            (keys // self.nx) % self.ny, keys % self.nx], -1)
        return table, slot, cell

    def encode(self, table, slot, cell, training):
        """Decorate (offsets from the pillar's point mean and its centre),
        linear, masked BN, ReLU, max over every slot (padded ones too)."""
        vs, pcr = self.cfg['voxel_size'], self.cfg['point_cloud_range']
        m = slot[..., None].to(table.dtype)
        xyz = table[..., :3]
        cnt = slot.sum(1).clamp(min=1).to(table.dtype)[:, None]
        mean = (xyz * m).sum(1) / cnt
        ix, iy = cell[:, 2].to(table.dtype), cell[:, 1].to(table.dtype)
        centre = torch.stack([(ix + 0.5) * vs[0] + pcr[0],
                              (iy + 0.5) * vs[1] + pcr[1],
                              torch.full_like(ix, 0.5 * vs[2] + pcr[2])], -1)
        x = torch.cat([table, xyz - mean[:, None], xyz - centre[:, None]],
                      -1) * m
        layer = self.voxel_encoder.pfn_layers[0]
        y = torch.relu(layer.norm(layer.linear(x), slot, training))
        return y.amax(1)

    def canvas(self, feats, cell, b):
        out = feats.new_zeros((b, self.ny, self.nx, feats.shape[1]))
        out = out.index_put((cell[:, 0], cell[:, 1], cell[:, 2]), feats)
        return out.permute(0, 3, 1, 2)

    def forward(self, points, mask, training: bool):
        """-> NCHW (cls, reg, dir) head maps."""
        self.train(training)
        table, slot, cell = self.voxelize(points, mask)
        feats = self.encode(table, slot, cell, training)
        x = self.neck(self.backbone(self.canvas(feats, cell,
                                                points.shape[0])))
        h = self.bbox_head
        return h.conv_cls(x), h.conv_reg(x), h.conv_dir_cls(x)

    # --------------------------------------------------------------- anchors
    def anchors(self, device):
        """(H, W, S, R, 7): class ranges on an inclusive linspace of the
        feature map, crossed with the rotations."""
        stride = self.cfg['backbone_cfg']['layer_strides'][0]
        h, w = self.ny // stride, self.nx // stride
        g = self.head_cfg['anchor_generator']
        per = []
        for rng, size in zip(g['ranges'], g['sizes']):
            xs = np.linspace(rng[0], rng[3], w, dtype=np.float32)
            ys = np.linspace(rng[1], rng[4], h, dtype=np.float32)
            xg, yg = np.meshgrid(xs, ys)
            rows = []
            for rot in g['rotations']:
                rows.append(np.stack([xg, yg, np.full_like(xg, rng[2]),
                                      np.full_like(xg, size[0]),
                                      np.full_like(xg, size[1]),
                                      np.full_like(xg, size[2]),
                                      np.full_like(xg, rot)], -1))
            per.append(np.stack(rows, 2))                  # (H, W, R, 7)
        return torch.from_numpy(np.stack(per, 2)).to(device)

    def targets(self, anchors, gt, labels, valid):
        """MaxIoU per anchor class -> (labels (B, A), label weights,
        positive mask, matched gt (B, A, 7)); each frame's alone, so in
        blocks of at most :data:`TARGET_FRAMES` frames, the (B, G, A)
        overlaps of one block at a time."""
        if gt.shape[0] <= TARGET_FRAMES:
            return self._targets(anchors, gt, labels, valid)
        parts = [self._targets(anchors, gt[i:i + TARGET_FRAMES],
                               labels[i:i + TARGET_FRAMES],
                               valid[i:i + TARGET_FRAMES])
                 for i in range(0, gt.shape[0], TARGET_FRAMES)]
        return tuple(torch.cat(t) for t in zip(*parts))

    def _targets(self, anchors, gt, labels, valid):
        h, w, s, r, _ = anchors.shape
        flat = anchors.reshape(-1, 7)
        a_cls = torch.arange(s, device=flat.device)[None, :, None].expand(
            h * w, s, r).reshape(-1)
        asg = self.head_cfg['assigners']
        thr = lambda key: torch.tensor([x[key] for x in asg],  # noqa: E731
                                       device=flat.device)[a_cls]
        pos_thr, neg_thr, min_thr = (thr('pos_iou_thr'), thr('neg_iou_thr'),
                                     thr('min_pos_iou'))
        ov = bx.aligned_iou(bx.nearest_bev(gt), bx.nearest_bev(flat))
        ok = valid[:, :, None] & (labels[:, :, None].long() == a_cls)
        ov = torch.where(ok, ov, torch.full_like(ov, -1.0))   # (B, G, A)
        max_ov, arg = ov.max(1)
        assigned = torch.full_like(arg, -1)
        assigned = torch.where(max_ov < neg_thr, 0, assigned)
        assigned = torch.where(max_ov >= pos_thr, arg + 1, assigned)
        gt_max = ov.max(2, keepdim=True).values
        elig = (ov == gt_max) & (gt_max >= min_thr) & ok
        gid = torch.arange(1, ov.shape[1] + 1, device=ov.device)[:, None]
        lq = torch.where(elig, gid, 0).max(1).values
        assigned = torch.where(lq > 0, lq, assigned)
        pos, neg = assigned > 0, assigned == 0
        gidx = (assigned - 1).clamp(min=0)
        matched = torch.gather(gt, 1, gidx[..., None].expand(-1, -1, 7))
        lab = torch.gather(labels.long(), 1, gidx)
        nc = self.head_cfg['num_classes']
        lab = torch.where(pos, lab, torch.full_like(lab, nc))
        return lab, (pos | neg).float(), pos, matched

    def loss(self, outs, batch, anchors):
        """-> (total, {loss_cls, loss_bbox, loss_dir}), the head's terms
        each divided by the batch's positives (at least one)."""
        cls, reg, dirp = outs
        b = cls.shape[0]
        nc = self.head_cfg['num_classes']
        cls = cls.permute(0, 2, 3, 1).reshape(b, -1, nc)
        reg = reg.permute(0, 2, 3, 1).reshape(b, -1, 7)
        dirp = dirp.permute(0, 2, 3, 1).reshape(b, -1, 2)
        lab, lw, pos, matched = self.targets(anchors, batch['gt_bboxes'],
                                             batch['gt_labels'],
                                             batch['gt_valid'])
        avg = pos.sum().float().clamp(min=1.0)
        hc = self.head_cfg
        fc = hc['loss_cls']
        onehot = lab[..., None] == torch.arange(nc, device=lab.device)
        loss_cls = fc['loss_weight'] * (focal_sum(
            cls, onehot, fc['gamma'], fc['alpha']) * lw).sum() / avg
        flat = anchors.reshape(-1, 7).expand(b, -1, -1)
        gd = hc['loss_decoded_bbox']
        dec = bx.decode(flat[pos], reg[pos])
        dist = gd_distance(gd['loss_type'], dec, matched[pos],
                           gd['center_offset'], gd['fun'], gd['tau'],
                           gd['alpha'])
        loss_bbox = gd['loss_weight'] * hc['decode_weight'] * dist.sum() / avg
        if any(hc.get('code_weight') or []):
            raise NotImplementedError('the reference has no SmoothL1 term')
        dir_offset = -math.pi / 2
        tgt = bx.encode(flat[pos], matched[pos])
        dtarget = bx.direction_target(flat[pos][:, 6], tgt[:, 6], dir_offset)
        ld = hc['loss_dir']
        loss_dir = ld['loss_weight'] * cross_entropy(dirp[pos],
                                                     dtarget).sum() / avg
        terms = dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                     loss_dir=loss_dir)
        return sum(terms.values()), terms
