"""CenterNet heatmap targets: ``gaussian_radius`` and ``splat_heatmap``.

Port of ``mmdet3d_gaussian_tpu/ops/heatmap.py``.  Every object of a whole
batch is drawn at once: a ``(B, K, C, H, W)`` stack of Gaussians, one class
plane lit per object, max-reduced over the objects (the JAX package draws
one sample at a time under ``vmap``).  Plain elementwise PyTorch; no TPU
kernel is involved.
"""
from __future__ import annotations

import torch


def gaussian_radius(det_size, min_overlap: float = 0.5) -> torch.Tensor:
    """CenterNet radius heuristic, the least of three quadratic roots.
    ``det_size``: (height, width) tensors in feature-map cells."""
    height, width = det_size

    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * 4.0 * c2).clamp(min=0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat_heatmap(centers_int: torch.Tensor, radius: torch.Tensor,
                  class_ids: torch.Tensor, valid: torch.Tensor,
                  num_classes: int, height: int, width: int) -> torch.Tensor:
    """Draw every object's Gaussian onto per-sample class heatmaps.

    centers_int (B, K, 2) integer (x, y) cells; radius (B, K) f32 (already
    floored at the minimum radius); class_ids (B, K) int (a class outside
    [0, C) lights no plane); valid (B, K) bool.  -> (B, C, H, W) f32: at
    each cell the largest value of that class's objects, as repeated
    ``draw_heatmap_gaussian`` calls leave it.  A Gaussian reaches
    ``ceil(radius)`` cells from its centre and values under
    ``1e3 * eps(f32)`` are zeroed."""
    dev = centers_int.device
    ys = torch.arange(height, device=dev, dtype=torch.int32)[:, None]
    xs = torch.arange(width, device=dev, dtype=torch.int32)[None, :]
    cx = centers_int[..., 0].to(torch.int32)[..., None, None]
    cy = centers_int[..., 1].to(torch.int32)[..., None, None]
    dx, dy = xs - cx, ys - cy                                # (B, K, H, W)
    sigma = ((2 * radius + 1) / 6.0)[..., None, None]
    g = torch.exp(-(dx * dx + dy * dy).to(torch.float32)
                  / (2 * sigma ** 2 + 1e-12))
    r = torch.ceil(radius)[..., None, None]
    inside = (dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None]
    g = torch.where(inside, g, 0.0)
    g = torch.where(g < torch.finfo(torch.float32).eps * 1e3, 0.0, g)
    # a class outside [0, C) lights no plane (jax.nn.one_hot's rule)
    onehot = (class_ids[..., None] == torch.arange(
        num_classes, device=dev)).to(g.dtype)
    return (g[:, :, None] * onehot[..., None, None]).amax(dim=1)
