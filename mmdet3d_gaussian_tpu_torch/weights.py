"""JAX variable tree -> the port's ``state_dict``.

``jax_variables_to_torch`` takes the JAX package's ``{'params',
'batch_stats'}`` tree of a ``PointPillarsNet`` (hard or dynamic encoder) as
nested dicts of numpy arrays and returns a ``state_dict`` for
:class:`~mmdet3d_gaussian_tpu_torch.models.detectors.voxelnet.PointPillarsNet`
with mmdet3d-style names; ``jax_grads_to_torch`` maps a gradient tree (the
shape of ``params``) the same way, to one tensor per parameter name:

* ``voxel_encoder/linear_{i}``, ``norm_{i}`` (dynamic) and
  ``voxel_encoder/pfn_{i}/linear``, ``pfn_{i}/norm`` (hard, both forms) ->
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

Every leaf of the JAX tree is mapped or named in :data:`IGNORED_LEAVES`;
any other leaf raises ``KeyError``, so a tree of a module the port lacks
never loads into nothing.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


# JAX leaves with no counterpart in the port, as '/'-joined paths under
# ``params`` or ``batch_stats``: none in the trees of the ported modules
IGNORED_LEAVES: Tuple[str, ...] = ()


class _Tree:
    """A nested dict whose leaves record that they were read."""

    def __init__(self, tree, used, path=()):
        self._tree, self._used, self._path = tree, used, path

    def __getitem__(self, key):
        v = self._tree[key]
        path = self._path + (key,)
        if hasattr(v, 'items'):
            return _Tree(v, self._used, path)
        self._used.add('/'.join(path))
        return v

    def get(self, key, default):
        return self[key] if key in self._tree else default

    def items(self):
        return [(k, self[k]) for k in self._tree]


def _leaf_paths(tree, path=()) -> Iterator[str]:
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield '/'.join(path + (k,))


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
    used = set()
    trees = [('params', params)] + ([] if stats is None
                                    else [('batch_stats', stats)])
    params = _Tree(params, used, ('params',))
    if stats is not None:
        stats = _Tree(stats, used, ('batch_stats',))

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
        m = re.fullmatch(r'(linear|pfn)_(\d+)', name)
        if not m:           # norm_{i}: read with linear_{i}
            continue
        i = int(m.group(2))
        if m.group(1) == 'pfn':     # hard encoder: pfn_{i}/{linear,norm}
            lin, norm = sub['linear'], sub['norm']
            norm_stats = sub_stats('voxel_encoder', name, 'norm')
        else:                       # dynamic encoder: linear_{i}, norm_{i}
            lin, norm = sub, enc[f'norm_{i}']
            norm_stats = sub_stats('voxel_encoder', f'norm_{i}')
        sd[f'voxel_encoder.pfn_layers.{i}.linear.weight'] = \
            _t(np.asarray(lin['kernel']).T)
        _bn(sd, f'voxel_encoder.pfn_layers.{i}.norm', norm, norm_stats,
            tracked=False)

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

    left = sorted(p for top, tree in trees
                  for p in _leaf_paths(tree, (top,))
                  if p not in used and p.split('/', 1)[1] not in
                  IGNORED_LEAVES)
    if left:
        raise KeyError(f'JAX leaves with no counterpart in the port: {left}')
    return sd
