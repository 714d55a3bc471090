"""JAX variable tree -> the port's ``state_dict``.

``jax_variables_to_torch`` takes the JAX package's ``{'params',
'batch_stats'}`` tree of a ``PointPillarsNet`` (hard or dynamic encoder,
anchor or center head) or an ``MVXPillarsNet`` as nested dicts of numpy arrays and returns a
``state_dict`` for
:class:`~mmdet3d_gaussian_tpu_torch.models.detectors.voxelnet.PointPillarsNet`
with mmdet3d-style names; ``jax_grads_to_torch`` maps a gradient tree (the
shape of ``params``) the same way, to one tensor per parameter name:

* ``voxel_encoder/linear_{i}``, ``norm_{i}`` (dynamic, and the
  point-sharded ``DensePillarEncoder``) and
  ``voxel_encoder/pfn_{i}/linear``, ``pfn_{i}/norm`` (hard, both forms) ->
  ``voxel_encoder.pfn_layers.{i}.linear`` / ``.norm``;
* the MVF encoder: ``voxel_encoder/pointnet{k}_fc``, ``pointnet{k}_bn``
  -> ``voxel_encoder.pointnet{k}.linear`` / ``.norm``, and each view's
  ``voxel_encoder/view_{name}/`` tower -> ``voxel_encoder.views.{name}.``:
  ``pointnet``, ``pointnet_bn`` -> ``pointnet.linear`` / ``.norm``,
  ``res{r}/{conv1,conv2,down_conv}``, ``res{r}/{bn1,bn2,down_bn}`` -> the
  same names, ``deconv2``, ``deconv3`` (transposed convs, flipped) and
  ``fuse_conv`` (with its bias);
* ``backbone/stage{s}_down``, ``stage{s}_block{j}`` ->
  ``backbone.blocks.{s}.{0 | 3 (j + 1)}`` (conv) and ``+1`` (BN);
* ``neck/deblock{i}_conv``, ``deblock{i}_bn`` -> ``neck.deblocks.{i}.0`` /
  ``.1``;
* ``bbox_head/conv_{cls,reg,dir_cls}`` -> ``bbox_head.conv_*`` (anchor
  head);
* MVX's image branch under the same names: ``img_backbone/stem``,
  ``stem_bn``, ``stage{i}_block{j}/{conv1, bn1, conv2, bn2, down,
  bn_down}``; ``img_neck/lateral_{i}``, ``fpn_out_{i}`` (with their
  biases); ``fusion/lateral_{i}``, ``fuse`` (Dense kernels transposed);
* ``bbox_head/shared_conv``, ``shared_bn`` -> ``bbox_head.shared_conv.conv``
  / ``.bn``, and ``bbox_head/task{t}/{name}_conv{j}``, ``{name}_bn{j}``,
  ``{name}_out`` -> ``bbox_head.task_heads.{t}.{name}.{j}.conv`` /
  ``.{j}.bn`` and ``.{n}`` for a tower of ``n`` conv layers (center head;
  a depthwise-separable ``{name}_conv{j}`` holds ``chn_conv`` and
  ``dep_conv``, mapped to ``.{j}.conv.chn_conv`` / ``.dep_conv``).

* a PV-RCNN tree, ``{'first': {'params', 'batch_stats'}, 'second':
  {...}}`` -> ``first.*`` and ``second.*``: ``middle_encoder/{block}``
  (its ``(K, Cin, Cout)`` kernel as it is, and ``bn``), the backbone and
  neck as above, ``rpn_head/conv_*``; ``keypoints_encoder/rawpoints_sa``,
  ``voxel_sa_{k}`` and ``roi_extractor/grid_pool``: ``scale{i}_mlp{j}``,
  ``scale{i}_bn{j}`` -> ``.mlps.{i}.{j}.linear`` / ``.norm``;
  ``keypoints_encoder/fusion``, ``fusion_bn`` -> ``.fusion``;
  ``semantic_head/mlp{i}``, ``bn{i}`` -> ``.mlps.{i}``, ``seg_out``;
  ``bbox_head/{shared,cls,reg}{i}``, ``{...}_bn{i}`` -> ``.{tower}.{i}``,
  ``cls_out``, ``reg_out``.

Layouts: conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``), dense
kernels transposed, and a flax ``ConvTranspose`` kernel ``(s, s, cin,
cout)`` is spatially flipped to become a torch ``ConvTranspose2d`` weight
``(cin, cout, s, s)``: flax places ``K[r, q]`` at output offset
``(s-1-r, s-1-q)`` of each ``s x s`` block, torch at ``(r, q)``.  A neck
level of stride 1/k is a plain ``k x k`` conv whose kernel has the shape of
a stride-k transposed conv's, so the neck's ``upsample_strides`` decide
which a level is; a center-head tree (the nuScenes configs' fractional
strides) must come with them.

Every leaf of the JAX tree is mapped or named in :data:`IGNORED_LEAVES`;
any other leaf raises ``KeyError``, so a tree of a module the port lacks
never loads into nothing.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

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

    def __contains__(self, key):
        return key in self._tree

    def get(self, key, default):
        return self[key] if key in self._tree else default

    def keys(self):
        return list(self._tree)

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


def jax_variables_to_torch(variables: Dict[str, Any],
                           upsample_strides: Optional[Sequence[float]] = None
                           ) -> Dict[str, torch.Tensor]:
    """``upsample_strides``: the neck's (``neck_cfg['upsample_strides']``);
    without them a neck kernel larger than 1 x 1 is a transposed conv,
    which a center-head tree refuses.  A PV-RCNN tree (``{'first':
    {'params', 'batch_stats'}, 'second': {...}}``) maps to
    :class:`~mmdet3d_gaussian_tpu_torch.engine.pvrcnn.PVRCNNNet`."""
    if 'first' in variables:
        return _convert_pvrcnn(
            {k: variables[k]['params'] for k in _STAGES},
            {k: variables[k]['batch_stats'] for k in _STAGES})
    return _convert(variables['params'], variables['batch_stats'],
                    upsample_strides)


def jax_grads_to_torch(grads: Dict[str, Any],
                       upsample_strides: Optional[Sequence[float]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Gradient tree of ``params`` (PV-RCNN: ``{'first': params,
    'second': params}``) -> {parameter name: gradient}, laid out as the
    port's parameters (every map above is linear)."""
    if 'first' in grads:
        return _convert_pvrcnn({k: grads[k] for k in _STAGES}, None)
    return _convert(grads, None, upsample_strides)


def _conv(k) -> torch.Tensor:
    """flax conv kernel HWIO -> torch OIHW."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _convert(params, stats, upsample_strides=None
             ) -> Dict[str, torch.Tensor]:
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
    _mvf_encoder(sd, enc, sub_stats)
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

    _backbone_neck(sd, params, sub_stats, '', upsample_strides)
    _img_branch(sd, params, sub_stats)
    head = params.get('bbox_head', {})
    if 'shared_conv' in head:
        _center_head(sd, head, sub_stats)
    else:
        _anchor_head(sd, 'bbox_head', head)
    _check_all_used(trees, used)
    return sd


def _check_all_used(trees, used) -> None:
    left = sorted(p for top, tree in trees
                  for p in _leaf_paths(tree, (top,))
                  if p not in used and p.split('/', 1)[1] not in
                  IGNORED_LEAVES)
    if left:
        raise KeyError(f'JAX leaves with no counterpart in the port: {left}')


def _anchor_head(sd, prefix, head) -> None:
    for conv, sub in head.items():
        sd[f'{prefix}.{conv}.weight'] = _conv(sub['kernel'])
        sd[f'{prefix}.{conv}.bias'] = _t(sub['bias'])


def _backbone_neck(sd, params, sub_stats, prefix,
                   upsample_strides=None) -> None:
    """SECOND's and SECONDFPN's leaves into ``sd`` under ``prefix``."""
    for name, sub in params.get('backbone', {}).items():
        m = re.fullmatch(r'stage(\d+)_(down|block(\d+))', name)
        if not m:
            continue
        s = int(m.group(1))
        j = 0 if m.group(2) == 'down' else 3 * (int(m.group(3)) + 1)
        sd[f'{prefix}backbone.blocks.{s}.{j}.weight'] = _conv(
            sub['conv']['kernel'])
        _bn(sd, f'{prefix}backbone.blocks.{s}.{j + 1}', sub['bn'],
            sub_stats('backbone', name, 'bn'), tracked=True)

    if ('shared_conv' in params.get('bbox_head', {})
            and upsample_strides is None):
        raise ValueError('a center-head tree needs the neck\'s '
                         'upsample_strides to place its levels')
    neck = params.get('neck', {})
    for name, sub in neck.items():
        m = re.fullmatch(r'deblock(\d+)_conv', name)
        if not m:
            continue
        i = int(m.group(1))
        k = np.asarray(sub['kernel'])
        transposed = (k.shape[0] > 1 if upsample_strides is None
                      else upsample_strides[i] > 1)
        if transposed:       # ConvTranspose (s, s, cin, cout), flipped
            w = np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
        else:                # a 1x1 or (stride 1/k) k x k conv
            w = np.transpose(k, (3, 2, 0, 1))
        sd[f'{prefix}neck.deblocks.{i}.0.weight'] = _t(w)
        _bn(sd, f'{prefix}neck.deblocks.{i}.1', neck[f'deblock{i}_bn'],
            sub_stats('neck', f'deblock{i}_bn'), tracked=True)


def _img_branch(sd, params, sub_stats) -> None:
    """MVX's image branch and fusion (``img_backbone``, ``img_neck``,
    ``fusion``) into ``sd``, under the same names."""
    bb = params.get('img_backbone', {})
    if 'stem' in bb:
        sd['img_backbone.stem.weight'] = _conv(bb['stem']['kernel'])
        _bn(sd, 'img_backbone.stem_bn', bb['stem_bn'],
            sub_stats('img_backbone', 'stem_bn'), tracked=True)
    for name, tree in bb.items():
        if not re.fullmatch(r'stage\d+_block\d+', name):
            continue
        for conv, bn in (('conv1', 'bn1'), ('conv2', 'bn2'),
                         ('down', 'bn_down')):
            if conv not in tree:
                continue
            pre = f'img_backbone.{name}'
            sd[f'{pre}.{conv}.weight'] = _conv(tree[conv]['kernel'])
            _bn(sd, f'{pre}.{bn}', tree[bn],
                sub_stats('img_backbone', name, bn), tracked=True)
    for name, conv in params.get('img_neck', {}).items():
        if re.fullmatch(r'(lateral|fpn_out)_\d+', name):
            sd[f'img_neck.{name}.weight'] = _conv(conv['kernel'])
            sd[f'img_neck.{name}.bias'] = _t(conv['bias'])
    for name, dense in params.get('fusion', {}).items():
        if re.fullmatch(r'lateral_\d+|fuse', name):
            sd[f'fusion.{name}.weight'] = _t(np.asarray(dense['kernel']).T)
            sd[f'fusion.{name}.bias'] = _t(dense['bias'])


def _linear_bn(sd, prefix, lin, norm, norm_stats) -> None:
    """A flax Dense kernel and its MaskedBatchNorm -> ``{prefix}.linear``
    and ``{prefix}.norm``."""
    sd[f'{prefix}.linear.weight'] = _t(np.asarray(lin['kernel']).T)
    _bn(sd, f'{prefix}.norm', norm, norm_stats, tracked=False)


def _mvf_encoder(sd, enc, sub_stats) -> None:
    """The MVF encoder's leaves (``PillarMVFFeatureNet``) into ``sd``."""
    pre = 'voxel_encoder'
    for name in enc.keys():
        m = re.fullmatch(r'(pointnet\d+)_fc', name)
        if m:
            k = m.group(1)
            _linear_bn(sd, f'{pre}.{k}', enc[name], enc[f'{k}_bn'],
                       sub_stats(pre, f'{k}_bn'))
            continue
        m = re.fullmatch(r'view_(\w+)', name)
        if not m:
            continue
        tree, vp = enc[name], f'{pre}.views.{m.group(1)}'
        _linear_bn(sd, f'{vp}.pointnet', tree['pointnet'],
                   tree['pointnet_bn'], sub_stats(pre, name, 'pointnet_bn'))
        for res in ('res1', 'res2', 'res3'):
            for conv, bn in (('conv1', 'bn1'), ('conv2', 'bn2'),
                             ('down_conv', 'down_bn')):
                if conv not in tree[res]:
                    continue
                sd[f'{vp}.{res}.{conv}.weight'] = _conv(
                    tree[res][conv]['kernel'])
                _bn(sd, f'{vp}.{res}.{bn}', tree[res][bn],
                    sub_stats(pre, name, res, bn), tracked=True)
        for deconv in ('deconv2', 'deconv3'):
            k = np.asarray(tree[deconv]['kernel'])   # (s, s, cin, cout)
            sd[f'{vp}.{deconv}.weight'] = _t(
                np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
        sd[f'{vp}.fuse_conv.weight'] = _conv(tree['fuse_conv']['kernel'])
        sd[f'{vp}.fuse_conv.bias'] = _t(tree['fuse_conv']['bias'])


def _center_head(sd, head, sub_stats) -> None:
    """The center head's leaves (``CenterHeadConvs``) into ``sd``."""
    pre = 'bbox_head'
    sd[f'{pre}.shared_conv.conv.weight'] = _conv(head['shared_conv']['kernel'])
    _bn(sd, f'{pre}.shared_conv.bn', head['shared_bn'],
        sub_stats('bbox_head', 'shared_bn'), tracked=True)
    for task, tree in head.items():
        m = re.fullmatch(r'task(\d+)', task)
        if not m:
            continue
        tp = f'{pre}.task_heads.{m.group(1)}'
        for leaf, sub in tree.items():
            m = re.fullmatch(r'(\w+?)_(conv(\d+)|out)', leaf)
            if not m:       # {name}_bn{j}: read with {name}_conv{j}
                continue
            name = m.group(1)
            if m.group(2) == 'out':
                n = sum(1 for k in tree.keys()
                        if re.fullmatch(rf'{name}_conv\d+', k))
                sd[f'{tp}.{name}.{n}.weight'] = _conv(sub['kernel'])
                sd[f'{tp}.{name}.{n}.bias'] = _t(sub['bias'])
                continue
            j = m.group(3)
            if 'chn_conv' in sub:     # ConvDS
                sd[f'{tp}.{name}.{j}.conv.chn_conv.weight'] = \
                    _conv(sub['chn_conv']['kernel'])
                sd[f'{tp}.{name}.{j}.conv.dep_conv.weight'] = \
                    _conv(sub['dep_conv']['kernel'])
                sd[f'{tp}.{name}.{j}.conv.dep_conv.bias'] = \
                    _t(sub['dep_conv']['bias'])
            else:
                sd[f'{tp}.{name}.{j}.conv.weight'] = _conv(sub['kernel'])
            _bn(sd, f'{tp}.{name}.{j}.bn', tree[f'{name}_bn{j}'],
                sub_stats('bbox_head', task, f'{name}_bn{j}'), tracked=True)


_STAGES = ('first', 'second')


def _convert_pvrcnn(params, stats) -> Dict[str, torch.Tensor]:
    """PV-RCNN's two stage trees ({stage: tree}) -> ``first.*`` and
    ``second.*`` names."""
    used = set()
    trees = [(f'{k}/params', params[k]) for k in _STAGES]
    if stats is not None:
        trees += [(f'{k}/batch_stats', stats[k]) for k in _STAGES]
    p = {k: _Tree(params[k], used, (k, 'params')) for k in _STAGES}
    s = (None if stats is None else
         {k: _Tree(stats[k], used, (k, 'batch_stats')) for k in _STAGES})

    def stats_of(stage):
        def sub(*keys):
            if s is None:
                return None
            tree = s[stage]
            for k in keys:
                tree = tree[k]
            return tree
        return sub

    sd: Dict[str, torch.Tensor] = {}
    first, st1 = p['first'], stats_of('first')
    for name, sub in first['middle_encoder'].items():
        pre = f'first.middle_encoder.{name}'
        sd[f'{pre}.weight'] = _t(sub['kernel'])      # (K, Cin, Cout)
        _bn(sd, f'{pre}.bn', sub['bn'], st1('middle_encoder', name, 'bn'),
            tracked=False)
    _backbone_neck(sd, first, st1, 'first.')
    _anchor_head(sd, 'first.rpn_head', first['rpn_head'])

    second, st2 = p['second'], stats_of('second')

    def linear_bns(pre, tree, path, lin, bn):
        """``{lin}{j}`` + ``{bn}{j}`` -> ``{pre}.{j}.linear`` / ``.norm``."""
        for leaf in tree.keys():
            m = re.fullmatch(rf'{lin}(\d+)', leaf)
            if m:
                j = m.group(1)
                _linear_bn(sd, f'{pre}.{j}', tree[leaf], tree[f'{bn}{j}'],
                           st2(*path, f'{bn}{j}'))

    def sa(pre, tree, path):
        """A GuidedSAModuleMSG: ``scale{i}_mlp{j}``, ``scale{i}_bn{j}`` ->
        ``{pre}.mlps.{i}.{j}``."""
        for leaf in tree.keys():
            m = re.fullmatch(r'scale(\d+)_mlp(\d+)', leaf)
            if m:
                i, j = m.groups()
                _linear_bn(sd, f'{pre}.mlps.{i}.{j}', tree[leaf],
                           tree[f'scale{i}_bn{j}'],
                           st2(*path, f'scale{i}_bn{j}'))

    def dense(name, tree):
        sd[f'{name}.weight'] = _t(np.asarray(tree['kernel']).T)
        sd[f'{name}.bias'] = _t(tree['bias'])

    ke = second['keypoints_encoder']
    for name in ke.keys():
        if name == 'rawpoints_sa' or name.startswith('voxel_sa_'):
            sa(f'second.keypoints_encoder.{name}', ke[name],
               ('keypoints_encoder', name))
    _linear_bn(sd, 'second.keypoints_encoder.fusion', ke['fusion'],
               ke['fusion_bn'], st2('keypoints_encoder', 'fusion_bn'))
    head = second['semantic_head']
    linear_bns('second.semantic_head.mlps', head, ('semantic_head',), 'mlp',
               'bn')
    dense('second.semantic_head.seg_out', head['seg_out'])
    sa('second.roi_extractor.grid_pool', second['roi_extractor']['grid_pool'],
       ('roi_extractor', 'grid_pool'))
    head = second['bbox_head']
    for tower in ('shared', 'cls', 'reg'):
        linear_bns(f'second.bbox_head.{tower}', head, ('bbox_head',), tower,
                   f'{tower}_bn')
    dense('second.bbox_head.cls_out', head['cls_out'])
    dense('second.bbox_head.reg_out', head['reg_out'])
    _check_all_used(trees, used)
    return sd
