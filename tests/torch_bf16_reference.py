"""JAX reference numbers for ``tests/test_torch_bf16.py``, computed in a
process of their own.

    python -m tests.torch_bf16_reference OUT.npz [hard | center | mvx]

XLA on the CPU keeps some bf16 values in f32 between operations
(``--xla_allow_excess_precision``, on by default), so its bf16 program
rounds at fewer points than the JAX package's casts say.  The test process
cannot change that flag once JAX has started, so this process starts JAX
with it off and saves, for the TINY model on one seeded weight set and
batch: the weights as the port's state_dict, the head maps of a bf16 and
an f32 predict, the bf16 detections, the loss terms, gradients and new
running statistics of one sparse-target train step in bf16 and in f32, and
the loss terms and gradients of one dense-target step (``pos_cap=0``, the
decoded-box loss through K3) in bf16 and in f32.  With ``hard``, the same
for the hard-voxelize model on ``tests/test_torch_hard.py``'s crowded
batch, with its bf16 pillar rows (eval), and for each hard encoder alone in
bf16 (one layer, training mode, on that file's batched encoder inputs):
its weights,
output, the gradient of a weighted sum of the output and the new running
statistics.  With ``center``, the TINY CenterPoint of
``tests/test_centerpoint.py`` (both heads): its weights, the maps of every
branch of a bf16 and an f32 predict, and the bf16 detections.  With
``mvx``, the TINY MVX of ``tests/test_torch_mvx.py``: its weights, the
dtype of every module output of the bf16 image branch, the head maps of a
bf16 and an f32 predict, the bf16 detections, and the loss terms,
gradients and new running statistics of one sparse-target step in bf16 and
in f32, with the batch mean and variance of each BatchNorm of the bf16
step (the image branch's, SECOND's and SECONDFPN's, in call order).
"""
import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_allow_excess_precision=false')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

from mmdet3d_gaussian_tpu.engine import detector as jdet  # noqa: E402
from mmdet3d_gaussian_tpu.models import voxel_encoders as jve  # noqa: E402

from mmdet3d_gaussian_tpu_torch.weights import (  # noqa: E402
    jax_grads_to_torch, jax_variables_to_torch)

from .test_torch_train import (TINY_HEAD, TINY_MODEL, _np_tree,  # noqa: E402
                               randomize)

def _f32(x):
    return np.asarray(x).astype(np.float32)


def _step(jd, variables, batch):
    """(loss terms, gradients, new batch statistics) of one train step."""
    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch)
        total, losses = jd.loss(outs, batch)
        return total, (losses, stats)

    (_, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    return losses, grads, stats


def _hard_encoders(arrays) -> None:
    """Each hard encoder alone in bf16, training mode."""
    from .test_torch_hard import (ENC_CASES, PCR, VOXEL, _enc_inputs,
                                  _encoder_sd, _jax_sorted)
    inp = _enc_inputs(4)
    kw = dict(ENC_CASES['one_layer'], voxel_size=VOXEL,
              point_cloud_range=PCR, dtype='bfloat16')
    for form, cls in (('packed', jve.PillarFeatureNet),
                      ('sorted', jve.SortedPillarFeatureNet)):
        if form == 'sorted':
            rows, extra = _jax_sorted(inp)
            args = (rows,) + extra
        else:
            args = (inp['voxels'], inp['vcoords'], inp['num_points'])
        mod = cls(**kw)
        variables = randomize(
            _np_tree(mod.init(jax.random.PRNGKey(0), *args)),
            np.random.RandomState(1))
        g = np.random.RandomState(2).randn(inp['max_voxels'], 16).astype(
            np.float32)

        def f(params):
            out, upd = mod.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                *args, train=True, mutable=['batch_stats'])
            return jnp.sum(out.astype(jnp.float32) * g), (out, upd)

        (_, (out, upd)), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(variables['params'])
        for name, tree in (('sd', variables),
                           ('state', {'params': variables['params'],
                                      'batch_stats': _np_tree(
                                          upd['batch_stats'])}),
                           ('grad', {'params': _np_tree(grads),
                                     'batch_stats': variables[
                                         'batch_stats']})):
            for k, v in _encoder_sd(tree).items():
                if name != 'grad' or 'running_' not in k:
                    arrays[f'enc_{form}_{name}/{k}'] = v.numpy()
        arrays[f'enc_{form}_out/rows'] = _f32(out)
        arrays[f'enc_{form}_out/dtype'] = np.asarray(str(out.dtype))


def _centerpoint(out: str) -> None:
    from .test_torch_centerpoint import (STRIDES, TINY_CP_MODEL, batch_np,
                                         head_cfg)
    batch = batch_np(False, seed=2)
    arrays = {}
    for yaw in (False, True):
        hc = head_cfg(yaw)
        bf16_model = dict(TINY_CP_MODEL, compute_dtype='bfloat16')
        j16 = jdet.CenterPointDetector(model_cfg=bf16_model, head_cfg=hc)
        variables = randomize(
            _np_tree(jax.jit(j16.init)(jax.random.PRNGKey(0), batch)),
            np.random.RandomState(0))
        pre = 'yaw' if yaw else 'rot'
        for k, v in jax_variables_to_torch(variables, STRIDES).items():
            arrays[f'{pre}_sd/{k}'] = v.numpy()
        for name, cfg in (('16', bf16_model), ('32', TINY_CP_MODEL)):
            jd = jdet.CenterPointDetector(model_cfg=cfg, head_cfg=hc)
            maps = jax.jit(jd.apply_eval)(variables, batch)
            for t, task in enumerate(maps):
                for branch, m in task.items():
                    arrays[f'{pre}_maps{name}/{t}.{branch}'] = _f32(m)
                    arrays[f'{pre}_maps{name}/{t}.{branch}.dtype'] = \
                        np.asarray(str(m.dtype))
            if name == '16':
                dets = jax.jit(jax.vmap(jd.head.get_bboxes_single))(maps)
                for i, d in enumerate(dets):
                    arrays[f'{pre}_dets16/{i}'] = np.asarray(d)
    np.savez(out, **arrays)


def _flat_dtypes(tree, path=()):
    """{'/'-joined module path: dtype name} of captured intermediates."""
    out = {}
    for k, v in tree.items():
        if k == '__call__':
            leaves = jax.tree_util.tree_leaves(v)
            if len(leaves) == 1:
                out['/'.join(path)] = str(leaves[0].dtype)
            else:
                for i, leaf in enumerate(leaves):
                    out['/'.join(path + (str(i),))] = str(leaf.dtype)
        elif hasattr(v, 'items'):
            out.update(_flat_dtypes(v, path + (k,)))
    return out


def _record_bn_stats(stats):
    """Make every training BatchNorm hand the batch mean and variance it
    computes to ``stats`` ({call index in trace order: (mean, var)}) until
    the returned function is called:
    flax's ``nn.BatchNorm`` (the image branch's) and ``FastBatchNorm``
    (SECOND's and SECONDFPN's; on the CPU its XLA formula, written out
    here as the module writes it)."""
    import flax.linen.normalization as fnorm
    from mmdet3d_gaussian_tpu.ops.pallas import bn_kernel
    compute_stats = fnorm._compute_stats

    def record(mu, var):
        index = len(stats)
        stats[index] = None
        jax.debug.callback(
            lambda m, v: stats.__setitem__(index, (np.asarray(m),
                                                   np.asarray(v))), mu, var)

    def flax_stats(*args, **kwargs):
        mu, var = compute_stats(*args, **kwargs)
        record(mu, var)
        return mu, var

    def fast_bn(x2, scale, bias, eps, axis_name):
        assert axis_name is None
        xf = x2.astype(jnp.float32)
        su = jnp.sum(xf, axis=0)
        sq = jnp.sum(xf * xf, axis=0)
        cnt = jnp.asarray(x2.shape[0], jnp.float32)
        mean = su / cnt
        var = jnp.maximum(sq / cnt - mean * mean, 0.0)
        record(mean, var)
        inv = jax.lax.rsqrt(var + eps) * scale
        return ((xf - mean) * inv + bias).astype(x2.dtype), mean, var
    originals = (compute_stats, bn_kernel.enabled, bn_kernel.bn_train,
                 bn_kernel.FastBatchNorm._folded)

    def folded(self, x, use_ra, fold):
        # FastBatchNorm._folded (the neck's stride-s levels) in training
        if use_ra:
            return originals[3](self, x, use_ra, fold)
        c = x.shape[-1] // fold
        ra_mean = self.variable('batch_stats', 'mean',
                                lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable('batch_stats', 'var',
                               lambda: jnp.ones((c,), jnp.float32))
        scale = self.param('scale', nn.initializers.ones, (c,), jnp.float32)
        bias = self.param('bias', nn.initializers.zeros, (c,), jnp.float32)
        xf = x.astype(jnp.float32)
        x2 = xf.reshape(-1, c * fold)
        su = jnp.sum(x2, axis=0).reshape(fold, c).sum(0)
        sq = jnp.sum(x2 * x2, axis=0).reshape(fold, c).sum(0)
        cnt = jnp.asarray(x2.shape[0] * fold, jnp.float32)
        mean = su / cnt
        var = jnp.maximum(sq / cnt - mean * mean, 0.0)
        record(mean, var)
        inv = jax.lax.rsqrt(var + self.epsilon) * scale
        y = ((xf - jnp.tile(mean, fold)) * jnp.tile(inv, fold)
             + jnp.tile(bias, fold)).astype(x.dtype)
        if not self.is_initializing():
            ra_mean.value = (self.momentum * ra_mean.value
                             + (1 - self.momentum) * mean)
            ra_var.value = (self.momentum * ra_var.value
                            + (1 - self.momentum) * var)
        return y
    fnorm._compute_stats = flax_stats
    bn_kernel.enabled = lambda: True
    bn_kernel.bn_train = fast_bn
    bn_kernel.FastBatchNorm._folded = folded

    def undo():
        (fnorm._compute_stats, bn_kernel.enabled, bn_kernel.bn_train,
         bn_kernel.FastBatchNorm._folded) = originals
    return undo


def _mvx(out: str) -> None:
    """The TINY MVX of ``tests/test_torch_mvx.py`` in bf16 and f32."""
    from mmdet3d_gaussian_tpu.engine import mvx as jmvx
    from .test_torch_mvx import IMG_HW, TINY_MVX, TINY_MVX_HEAD, jax_batch
    batch = jax_batch()
    bf16_model = dict(TINY_MVX, compute_dtype='bfloat16')
    j16 = jmvx.MVXDetector(model_cfg=bf16_model, head_cfg=TINY_MVX_HEAD)
    variables = randomize(
        _np_tree(jax.jit(j16.init)(jax.random.PRNGKey(0), batch)),
        np.random.RandomState(0))
    arrays = {f'sd/{k}': v.numpy()
              for k, v in jax_variables_to_torch(variables).items()}
    _, inter = jax.jit(lambda v, b: j16.trunk.apply(
        v, b['points'], b['points_mask'], b['img'], b['lidar2img'],
        train=False, capture_intermediates=lambda mdl, method: (
            method == '__call__' and mdl.scope.path[:1] in (
                ('img_backbone',), ('img_neck',)))))(variables, batch)
    for k, v in _flat_dtypes(inter['intermediates']).items():
        arrays[f'dtypes/{k}'] = np.asarray(v)
    assert IMG_HW == batch['img'].shape[1:3]
    for name, cfg in (('16', bf16_model), ('32', TINY_MVX)):
        jd = jmvx.MVXDetector(model_cfg=cfg, head_cfg=TINY_MVX_HEAD)
        maps = jax.jit(jd.apply_eval)(variables, batch)
        for i, m in enumerate(maps[:4]):
            arrays[f'maps{name}/{i}'] = _f32(m)
            arrays[f'maps{name}/{i}/dtype'] = np.asarray(str(m.dtype))
        if name == '16':
            dets = jax.jit(jd.predict)(variables, batch)
            for i, d in enumerate(dets):
                arrays[f'dets16/{i}'] = np.asarray(d)
        bn_stats = {}
        undo = _record_bn_stats(bn_stats) if name == '16' else None
        losses, grads, stats = _step(jd, variables, batch)
        if undo:
            undo()
        for k, v in losses.items():
            arrays[f'loss{name}/{k}'] = _f32(v)
        for k, v in jax_grads_to_torch(_np_tree(grads)).items():
            arrays[f'grad{name}/{k}'] = v.numpy()
        state = jax_variables_to_torch({'params': variables['params'],
                                        'batch_stats': _np_tree(stats)})
        for k, v in state.items():
            if 'running_' in k:
                arrays[f'state{name}/{k}'] = v.numpy()
        for i, (mu, var) in bn_stats.items():
            arrays[f'bnstats16/{i}/mean'] = mu
            arrays[f'bnstats16/{i}/var'] = var
    np.savez(out, **arrays)


def main(out: str, mode: str = 'dynamic') -> None:
    if mode == 'center':
        _centerpoint(out)
        return
    if mode == 'mvx':
        _mvx(out)
        return
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'])
    model = TINY_MODEL
    if mode == 'hard':
        from .test_torch_hard import HARD_MODEL as model, jax_batch
        batch = jax_batch()
    bf16_model = dict(model, compute_dtype='bfloat16')
    j16 = jdet.PointPillarsDetector(model_cfg=bf16_model, head_cfg=TINY_HEAD)
    variables = jax.jit(j16.init)(jax.random.PRNGKey(0), batch)
    variables = randomize(variables, np.random.RandomState(0))
    arrays = {f'sd/{k}': v.numpy()
              for k, v in jax_variables_to_torch(variables).items()}
    if mode == 'hard':
        _, inter = jax.jit(lambda v, p, m: j16.trunk.apply(
            v, p, m, train=False, capture_intermediates=lambda mdl, _:
            mdl.name == 'voxel_encoder'))(variables, batch['points'],
                                          batch['points_mask'])
        rows = inter['intermediates']['voxel_encoder']['__call__'][0]
        arrays['pillars16/rows'] = _f32(rows)
        arrays['pillars16/dtype'] = np.asarray(str(rows.dtype))
        _hard_encoders(arrays)

    for name, cfg in (('16', bf16_model), ('32', model)):
        jd = jdet.PointPillarsDetector(model_cfg=cfg, head_cfg=TINY_HEAD)
        maps = jax.jit(jd.apply_eval)(variables, batch)
        for i, m in enumerate(maps[:4]):
            arrays[f'maps{name}/{i}'] = _f32(m)
            arrays[f'maps{name}/{i}/dtype'] = np.asarray(str(m.dtype))
        if name == '16':
            dets = jax.jit(jax.vmap(jd.head.get_bboxes,
                                    in_axes=(0, 0, 0, None)))(
                maps[0], maps[1], maps[2], jd.anchors)
            for i, d in enumerate(dets):
                arrays[f'dets16/{i}'] = np.asarray(d)

        losses, grads, stats = _step(jd, variables, batch)
        for k, v in losses.items():
            arrays[f'loss{name}/{k}'] = _f32(v)
        for k, v in jax_grads_to_torch(_np_tree(grads)).items():
            arrays[f'grad{name}/{k}'] = v.numpy()
        state = jax_variables_to_torch({'params': variables['params'],
                                        'batch_stats': _np_tree(stats)})
        for k, v in state.items():
            if 'running_' in k:
                arrays[f'state{name}/{k}'] = v.numpy()
        jd = jdet.PointPillarsDetector(model_cfg=cfg,
                                       head_cfg=dict(TINY_HEAD, pos_cap=0))
        losses, grads, _ = _step(jd, variables, batch)
        for k, v in losses.items():
            arrays[f'loss{name}d/{k}'] = _f32(v)
        for k, v in jax_grads_to_torch(_np_tree(grads)).items():
            arrays[f'grad{name}d/{k}'] = v.numpy()
    np.savez(out, **arrays)


if __name__ == '__main__':
    main(*sys.argv[1:3])
