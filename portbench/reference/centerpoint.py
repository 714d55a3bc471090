"""Reference CenterPoint (pillars, nuScenes): dynamic pillars (every point
counts) with the offset decoration, one PFN layer and a per-pillar max,
the BEV canvas, SECOND, SECONDFPN, the shared conv and the per-task
towers, then decode: each task's top cells, the yaw snapped to the
direction branch's quadrant, score and range filters, rotated NMS a
(frame, task), and the best ``post_max_size`` of all tasks.

Parameter names follow the mmdet3d state_dict."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from . import boxes as bx
from .layers import SECOND, SECONDFPN, BatchNorm2d, Conv2d, Linear, \
    RowBatchNorm


class PFNLayer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear = Linear(cin, cout, bias=False)
        self.norm = RowBatchNorm(cout)


class Encoder(nn.Module):
    def __init__(self, cin, feat_channels):
        super().__init__()
        self.pfn_layers = nn.ModuleList([PFNLayer(cin, feat_channels[0])])


class ConvBN(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def heads_of(head_cfg) -> Dict[str, int]:
    heads = dict(reg=2, height=1, dim=3)
    heads.update(dict(yaw=1, dir=2) if head_cfg.get('yaw_mode')
                 else dict(rot=2))
    if head_cfg.get('with_vel'):
        heads['vel'] = 2
    return heads


class TaskHead(nn.Module):
    def __init__(self, heads: Dict[str, int], cin=64, head_conv=64):
        super().__init__()
        self.names = list(heads)
        for name, out in heads.items():
            self.add_module(name, nn.Sequential(
                ConvBN(cin, head_conv),
                Conv2d(head_conv, out, 3, padding=1, bias=True)))


class HeadConvs(nn.Module):
    def __init__(self, head_cfg, in_channels):
        super().__init__()
        self.shared_conv = ConvBN(in_channels, 64)
        heads = heads_of(head_cfg)
        self.task_heads = nn.ModuleList(
            [TaskHead(dict(heads, heatmap=t['num_classes']))
             for t in head_cfg['tasks']])


class CenterPoint(nn.Module):
    def __init__(self, model: Dict, head: Dict):
        super().__init__()
        self.cfg, self.head_cfg = model, head
        enc = model['encoder_cfg']
        self.voxel_encoder = Encoder(enc['in_channels'] + 6,
                                     enc['feat_channels'])
        self.backbone = SECOND(**model['backbone_cfg'])
        nk = model['neck_cfg']
        self.neck = SECONDFPN(nk['in_channels'], nk['out_channels'],
                              nk['upsample_strides'])
        self.bbox_head = HeadConvs(head, sum(nk['out_channels']))
        pcr, vs = model['point_cloud_range'], model['voxel_size']
        self.nx = int(round((pcr[3] - pcr[0]) / vs[0]))
        self.ny = int(round((pcr[4] - pcr[1]) / vs[1]))

    def pillars(self, points, mask):
        """-> pillar features (V, C) and cells (V, 3) (b, iy, ix): the
        first ``max_voxels_per_sample x B`` pillars of the batch in the
        space-to-depth key order (b, iy // 2, ix // 2, parity), each the
        max over its points of the PFN's rows."""
        b, n, c = points.shape
        dev = points.device
        pcr = torch.tensor(self.cfg['point_cloud_range'], device=dev)
        vs = torch.tensor(self.cfg['voxel_size'], device=dev)
        flat = points.reshape(-1, c)
        xyz = flat[:, :3]
        grid = torch.floor((pcr[3:] - pcr[:3]) / vs + 0.5).long()
        cellf = torch.floor((xyz - pcr[:3]) / vs)
        ijk = cellf.long()
        ok = mask.reshape(-1) & ((ijk >= 0) & (ijk < grid)).all(-1)
        ix, iy = ijk[:, 0], ijk[:, 1]
        bidx = torch.arange(b, device=dev).repeat_interleave(n)
        key = (((bidx * (self.ny // 2) + iy // 2) * (self.nx // 2) + ix // 2)
               * 4 + (iy & 1) * 2 + (ix & 1))
        big = 2 ** 62
        key = torch.where(ok, key, torch.full_like(key, big))
        uniq, inv = torch.unique(key, return_inverse=True)
        live = uniq < big
        cap = self.cfg['max_voxels_per_sample'] * b
        nv = min(int(live.sum()), cap)
        vid = torch.where(ok & (inv < nv), inv, torch.full_like(inv, -1))
        keep = vid >= 0
        v = vid[keep]
        ones = torch.ones_like(v, dtype=flat.dtype)
        cnt = torch.zeros(nv, device=dev).index_add_(0, v, ones)
        mean = torch.zeros((nv, 3), device=dev).index_add_(0, v, xyz[keep])
        mean = mean / cnt[:, None]
        pts = xyz[keep]
        ctr = (cellf[keep] + 0.5) * vs + pcr[:3]
        x = torch.cat([pts, pts - mean[v], pts - ctr, flat[keep, 3:]], -1)
        layer = self.voxel_encoder.pfn_layers[0]
        y = torch.relu(layer.norm(layer.linear(x), None, False))
        feats = torch.full((nv, y.shape[1]), -math.inf, device=dev)
        feats = feats.scatter_reduce(0, v[:, None].expand_as(y), y, 'amax')
        keys = uniq[:nv]
        kb = keys // (4 * (self.ny // 2) * (self.nx // 2))
        rest = keys % (4 * (self.ny // 2) * (self.nx // 2))
        par = rest % 4
        cxy = rest // 4
        cy, cx = cxy // (self.nx // 2), cxy % (self.nx // 2)
        cells = torch.stack([kb, cy * 2 + par // 2, cx * 2 + par % 2], -1)
        return feats, cells

    def forward(self, points, mask):
        """-> a list of per-task dicts of NCHW maps (eval mode)."""
        self.eval()
        feats, cells = self.pillars(points, mask)
        canvas = feats.new_zeros((points.shape[0], self.ny, self.nx,
                                  feats.shape[1]))
        canvas = canvas.index_put((cells[:, 0], cells[:, 1], cells[:, 2]),
                                  feats).permute(0, 3, 1, 2)
        x = self.neck(self.backbone(canvas))
        y = self.bbox_head.shared_conv(x)
        return [{name: getattr(th, name)(y) for name in th.names}
                for th in self.bbox_head.task_heads]

    def decode(self, preds):
        """Per-task maps -> (boxes (B, M, 9), scores (B, M), labels (B, M),
        valid (B, M)) and the candidates of every task (boxes (B, T, K, 9),
        scores, labels, valid) that NMS saw."""
        cfg = self.head_cfg['test_cfg']
        k = int(cfg['max_per_img'])
        thr = float(cfg['score_threshold'])
        pr = torch.tensor(cfg['post_center_limit_range'],
                          device=preds[0]['heatmap'].device)
        vs = self.cfg['voxel_size']
        pcr = self.cfg['point_cloud_range']
        f = self.head_cfg['out_size_factor']
        cell = (vs[0] * f, vs[1] * f)
        names = ['reg', 'height', 'dim', 'yaw', 'dir', 'vel']
        all_b, all_s, all_l, all_v, offset = [], [], [], [], 0
        for pred in preds:
            heat = torch.sigmoid(pred['heatmap'])          # (B, C, H, W)
            b, c, h, w = heat.shape
            code = torch.cat([pred[nm] for nm in names], 1)
            code = code.permute(0, 2, 3, 1).reshape(b, h * w, -1)
            s1, i1 = torch.sort(heat.reshape(b, c, h * w), dim=-1,
                                descending=True, stable=True)
            s1, i1 = s1[..., :k], i1[..., :k]
            s2, i2 = torch.sort(s1.reshape(b, -1), dim=-1,
                                descending=True, stable=True)
            s2, i2 = s2[:, :k], i2[:, :k]
            cls = i2 // k
            pos = torch.gather(i1.reshape(b, -1), 1, i2)
            cx, cy = pos % w, pos // w
            cd = torch.gather(code, 1, pos[..., None].expand(-1, -1,
                                                             code.shape[-1]))
            x = (cd[..., 0] + cx) * cell[0] + pcr[0]
            y = (cd[..., 1] + cy) * cell[1] + pcr[1]
            dims = torch.exp(cd[..., 3:6])
            z = cd[..., 2] - dims[..., 2] * 0.5
            yaw = cd[..., 6]
            direction = torch.atan2(cd[..., 7], cd[..., 8])
            rot = torch.floor((direction - yaw) / (math.pi / 2) + 0.5)
            yaw = yaw + rot * (math.pi / 2)
            odd = torch.remainder(rot.abs(), 2) == 1
            dw = torch.where(odd, dims[..., 1], dims[..., 0])
            dl = torch.where(odd, dims[..., 0], dims[..., 1])
            boxes = torch.stack([x, y, z, dw, dl, dims[..., 2], yaw,
                                 cd[..., 9], cd[..., 10]], -1)
            valid = (s2 >= thr) & (boxes[..., :3] >= pr[:3]).all(-1) \
                & (boxes[..., :3] <= pr[3:]).all(-1)
            order = torch.sort(torch.where(valid, s2, -math.inf), dim=-1,
                               descending=True, stable=True).indices
            all_b.append(torch.gather(boxes, 1, order[..., None].expand(
                -1, -1, 9)))
            all_s.append(torch.gather(s2, 1, order))
            all_l.append(torch.gather(cls, 1, order) + offset)
            all_v.append(torch.gather(valid, 1, order))
            offset += c
        boxes, scores = torch.stack(all_b, 1), torch.stack(all_s, 1)
        labels, valid = torch.stack(all_l, 1), torch.stack(all_v, 1)
        b, t = scores.shape[:2]
        keep, _ = bx.nms(boxes[..., [0, 1, 3, 4, 6]].reshape(b * t, k, 5),
                         valid.reshape(b * t, k), float(cfg['nms_thr']))
        kept = torch.where(keep.reshape(b, t, k), scores,
                           torch.full_like(scores, -1.0)).reshape(b, t * k)
        m = min(int(cfg['post_max_size']), t * k)
        final, idx = torch.sort(kept, dim=-1, descending=True,
                                stable=True)
        final, idx = final[:, :m], idx[:, :m]
        out = (torch.gather(boxes.reshape(b, t * k, 9), 1,
                            idx[..., None].expand(-1, -1, 9)), final,
               torch.gather(labels.reshape(b, t * k), 1, idx), final > thr)
        return out, (boxes, scores, labels, valid)

    @torch.no_grad()
    def predict(self, points, mask):
        return self.decode(self.forward(points, mask))
