"""JAX variable tree -> the port's ``state_dict``.

``jax_variables_to_torch`` takes the JAX package's ``{'params',
'batch_stats'}`` tree of a ``PointPillarsNet`` (dynamic encoder) as nested
dicts of numpy arrays and returns a ``state_dict`` for
:class:`~mmdet3d_gaussian_tpu_torch.models.detectors.voxelnet.PointPillarsNet`
with mmdet3d-style names; ``jax_grads_to_torch`` maps a gradient tree (the
shape of ``params``) the same way, to one tensor per parameter name:

* ``voxel_encoder/linear_{i}``, ``norm_{i}`` ->
  ``voxel_encoder.pfn_layers.{i}.linear`` / ``.norm``;
* ``backbone/stage{s}_down``, ``stage{s}_block{j}`` ->
  ``backbone.blocks.{s}.{0 | 3 (j + 1)}`` (conv) and ``+1`` (BN);
* ``neck/deblock{i}_conv``, ``deblock{i}_bn`` -> ``neck.deblocks.{i}.0`` /
  ``.1``;
* ``bbox_head/conv_{cls,reg,dir_cls}`` -> ``bbox_head.conv_*``.

Layouts: conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``), dense
kernels transposed, and a flax ``ConvTranspose`` kernel ``(s, s, cin,
cout)`` is spatially flipped to become a torch ``ConvTranspose2d`` weight
``(cin, cout, s, s)``: flax places ``K[r, q]`` at output offset
``(s-1-r, s-1-q)`` of each ``s x s`` block, torch at ``(r, q)``.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a,
                                                            np.float32)))


def _bn(sd, prefix, p, s, tracked: bool):
    sd[prefix + '.weight'] = _t(p['scale'])
    sd[prefix + '.bias'] = _t(p['bias'])
    if s is None:   # a gradient tree: parameters only
        return
    sd[prefix + '.running_mean'] = _t(s['mean'])
    sd[prefix + '.running_var'] = _t(s['var'])
    if tracked:     # nn.BatchNorm2d's counter (unused by the port)
        sd[prefix + '.num_batches_tracked'] = torch.tensor(0)


def jax_variables_to_torch(variables: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    return _convert(variables['params'], variables['batch_stats'])


def jax_grads_to_torch(grads: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Gradient tree of ``params`` -> {parameter name: gradient}, laid out
    as the port's parameters (every map above is linear)."""
    return _convert(grads, None)


def _convert(params, stats) -> Dict[str, torch.Tensor]:
    def sub_stats(*keys):           # stats of one BN, None without stats
        if stats is None:
            return None
        tree = stats
        for k in keys:
            tree = tree[k]
        return tree

    sd: Dict[str, torch.Tensor] = {}

    enc = params.get('voxel_encoder', {})
    for name, sub in enc.items():
        m = re.fullmatch(r'linear_(\d+)', name)
        if not m:
            continue
        i = int(m.group(1))
        sd[f'voxel_encoder.pfn_layers.{i}.linear.weight'] = \
            _t(np.asarray(sub['kernel']).T)
        _bn(sd, f'voxel_encoder.pfn_layers.{i}.norm', enc[f'norm_{i}'],
            sub_stats('voxel_encoder', f'norm_{i}'), tracked=False)

    for name, sub in params.get('backbone', {}).items():
        m = re.fullmatch(r'stage(\d+)_(down|block(\d+))', name)
        if not m:
            continue
        s = int(m.group(1))
        j = 0 if m.group(2) == 'down' else 3 * (int(m.group(3)) + 1)
        sd[f'backbone.blocks.{s}.{j}.weight'] = \
            _t(np.transpose(np.asarray(sub['conv']['kernel']), (3, 2, 0, 1)))
        _bn(sd, f'backbone.blocks.{s}.{j + 1}', sub['bn'],
            sub_stats('backbone', name, 'bn'), tracked=True)

    neck = params.get('neck', {})
    for name, sub in neck.items():
        m = re.fullmatch(r'deblock(\d+)_conv', name)
        if not m:
            continue
        i = int(m.group(1))
        k = np.asarray(sub['kernel'])
        if k.shape[0] > 1:   # ConvTranspose (s, s, cin, cout), flipped
            w = np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
        else:                # stride-1 level: 1x1 conv
            w = np.transpose(k, (3, 2, 0, 1))
        sd[f'neck.deblocks.{i}.0.weight'] = _t(w)
        _bn(sd, f'neck.deblocks.{i}.1', neck[f'deblock{i}_bn'],
            sub_stats('neck', f'deblock{i}_bn'), tracked=True)

    for conv, sub in params.get('bbox_head', {}).items():
        sd[f'bbox_head.{conv}.weight'] = \
            _t(np.transpose(np.asarray(sub['kernel']), (3, 2, 0, 1)))
        sd[f'bbox_head.{conv}.bias'] = _t(sub['bias'])
    return sd
