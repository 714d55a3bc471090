"""JAX reference numbers for ``tests/test_torch_bf16.py``, computed in a
process of their own.

    python -m tests.torch_bf16_reference OUT.npz [hard | center]

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
branch of a bf16 and an f32 predict, and the bf16 detections.
"""
import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_allow_excess_precision=false')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
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


def main(out: str, mode: str = 'dynamic') -> None:
    if mode == 'center':
        _centerpoint(out)
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
