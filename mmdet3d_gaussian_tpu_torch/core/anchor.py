"""Anchor generator (numpy, built once per detector).

Port of ``mmdet3d_gaussian_tpu/core/anchor.py``:
:class:`Anchor3DRangeGenerator` (mmdet3d's: anchor centres on an inclusive
linspace over each class range, crossed with the rotations) and the
anchor-free :class:`Point3DRangeGenerator`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..registry import ANCHOR_GENERATORS


@ANCHOR_GENERATORS.register_module()
class Anchor3DRangeGenerator:
    """Dense 3D anchors over a BEV grid, ``(H, W, num_sizes, num_rots, 7+)``.

    ``aligned=True`` puts anchor centres at BEV cell centres (upstream
    ``AlignedAnchor3DRangeGenerator``) instead of the inclusive linspace.
    """

    def __init__(self, ranges: Sequence[Sequence[float]],
                 sizes: Sequence[Sequence[float]] = ((3.9, 1.6, 1.56),),
                 rotations: Sequence[float] = (0.0, 1.5707963),
                 custom_values: Sequence[float] = (),
                 reshape_out: bool = False,
                 size_per_range: bool = True,
                 aligned: bool = False):
        self.aligned = aligned
        if size_per_range:
            if len(ranges) != len(sizes):
                if len(ranges) != 1:
                    raise ValueError('ranges must be one per size, or one')
                ranges = list(ranges) * len(sizes)
        elif len(ranges) != 1:
            raise ValueError('size_per_range=False takes a single range')
        self.ranges = [tuple(r) for r in ranges]
        self.sizes = [tuple(s) for s in sizes]
        self.rotations = tuple(rotations)
        self.custom_values = tuple(custom_values)
        self.reshape_out = reshape_out
        self.size_per_range = size_per_range

    @property
    def num_base_anchors(self) -> int:
        return len(self.sizes) * len(self.rotations)

    def single_level_grid_anchors(self, featmap_size: Tuple[int, int]
                                  ) -> np.ndarray:
        """Anchors for one level, ``featmap_size`` = (H, W) = (ny, nx)."""
        h, w = featmap_size
        per_size = []
        for rng, size in zip(self.ranges, self.sizes):
            x0, y0, z0, x1, y1, z1 = rng
            if self.aligned:
                xs = (x0 + (np.arange(w, dtype=np.float32) + 0.5)
                      * (x1 - x0) / w)
                ys = (y0 + (np.arange(h, dtype=np.float32) + 0.5)
                      * (y1 - y0) / h)
            else:
                xs = np.linspace(x0, x1, w, dtype=np.float32)
                ys = np.linspace(y0, y1, h, dtype=np.float32)
            zs = np.float32(z0)
            xg, yg = np.meshgrid(xs, ys)           # (H, W)
            ctr = np.stack([xg, yg, np.full_like(xg, zs)], axis=-1)
            ctr = np.broadcast_to(ctr[:, :, None, None, :],
                                  (h, w, 1, len(self.rotations), 3))
            dims = np.broadcast_to(
                np.asarray(size, np.float32)[None, None, None, None, :],
                (h, w, 1, len(self.rotations), 3))
            rot = np.broadcast_to(
                np.asarray(self.rotations, np.float32)[None, None, None, :,
                                                       None],
                (h, w, 1, len(self.rotations), 1))
            anc = np.concatenate([ctr, dims, rot], axis=-1)
            if self.custom_values:
                cv = np.broadcast_to(
                    np.asarray(self.custom_values, np.float32),
                    anc.shape[:-1] + (len(self.custom_values),))
                anc = np.concatenate([anc, cv], axis=-1)
            per_size.append(anc)
        out = np.concatenate(per_size, axis=2)  # (H, W, S, R, 7+)
        if self.reshape_out:
            out = out.reshape(-1, out.shape[-1])
        return np.ascontiguousarray(out)


@ANCHOR_GENERATORS.register_module()
class Point3DRangeGenerator:
    """Per-level BEV grids of (cx, cy, stride) priors for anchor-free heads
    (reference ``point_3d_generator.py:5-47``), f32 numpy ``(H, W, 3)`` a
    level."""

    def __init__(self, point_cloud_range: Sequence[float],
                 strides: Sequence[int]):
        self.point_cloud_range = tuple(point_cloud_range)
        self.strides = tuple(strides)

    def grid_priors(self, featmap_sizes, base_voxel_size: float):
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        out = []
        for (h, w), s in zip(featmap_sizes, self.strides):
            step = base_voxel_size * s
            xs = x0 + (np.arange(w, dtype=np.float32) + 0.5) * step
            ys = y0 + (np.arange(h, dtype=np.float32) + 0.5) * step
            xg, yg = np.meshgrid(xs, ys)
            stride = np.full_like(xg, step)
            out.append(np.stack([xg, yg, stride], axis=-1))
        return out
