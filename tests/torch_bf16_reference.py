"""JAX reference numbers for ``tests/test_torch_bf16.py``, computed in a
process of their own.

    python -m tests.torch_bf16_reference OUT.npz

XLA on the CPU keeps some bf16 values in f32 between operations
(``--xla_allow_excess_precision``, on by default), so its bf16 program
rounds at fewer points than the JAX package's casts say.  The test process
cannot change that flag once JAX has started, so this process starts JAX
with it off and saves, for the TINY model on one seeded weight set and
batch: the weights as the port's state_dict, the head maps of a bf16 and
an f32 predict, the bf16 detections, the loss terms, gradients and new
running statistics of one sparse-target train step in bf16 and in f32, and
the loss terms and gradients of one dense-target step (``pos_cap=0``, the
decoded-box loss through K3) in bf16 and in f32.
"""
import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_allow_excess_precision=false')

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

from mmdet3d_gaussian_tpu.engine import detector as jdet  # noqa: E402

from mmdet3d_gaussian_tpu_torch.weights import (  # noqa: E402
    jax_grads_to_torch, jax_variables_to_torch)

from .test_torch_train import (TINY_HEAD, TINY_MODEL, _np_tree,  # noqa: E402
                               randomize)

BF16_MODEL = dict(TINY_MODEL, compute_dtype='bfloat16')


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


def main(out: str) -> None:
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'])
    j16 = jdet.PointPillarsDetector(model_cfg=BF16_MODEL, head_cfg=TINY_HEAD)
    variables = jax.jit(j16.init)(jax.random.PRNGKey(0), batch)
    variables = randomize(variables, np.random.RandomState(0))
    arrays = {f'sd/{k}': v.numpy()
              for k, v in jax_variables_to_torch(variables).items()}

    for name, cfg in (('16', BF16_MODEL), ('32', TINY_MODEL)):
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
    main(sys.argv[1])
