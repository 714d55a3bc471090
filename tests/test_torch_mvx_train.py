"""The PyTorch port's MVX train step against the JAX package on the CPU.

One TINY MVX train step (``tests/test_mvx_fusion.py``'s widths, the odd
36 x 68 image of ``tests/test_torch_mvx.py``) on the same redrawn weights
and batch, with dense targets (``pos_cap=0``: the decoded-box loss through
K3's plain version) and sparse ones (the default ``pos_cap``): every loss
term within 1e-5 (relative), every parameter's gradient within 1e-4 of its
largest magnitude (the image branch's included: it learns only through
the painted points' gradient), the new running statistics within 1e-5;
then one AdamW update of the port's ``train_step`` against JAX's
``make_train_step`` with the same optimizer, and port steps that descend.
"""
import math

import numpy as np
import pytest
import torch

import jax

from mmdet3d_gaussian_tpu.engine import mvx as jmvx
from mmdet3d_gaussian_tpu.parallel import train_state as jts

from mmdet3d_gaussian_tpu_torch.engine import mvx as tmvx
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from .test_mvx_fusion import TINY_MVX, TINY_MVX_HEAD
from .test_torch_mvx import jax_batch, port_batch
from .test_torch_train import _np_tree, randomize

torch.set_num_threads(2)

MODES = {'dense': 0, 'sparse': 1024}
GRAD_TOL = 1e-4
LR = 1e-3


def _variables(jd, batch):
    return randomize(_np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                               batch)),
                     np.random.RandomState(0))


@pytest.fixture(scope='module', params=list(MODES))
def step_pair(request):
    """Loss terms, gradients and new running statistics of one step, from
    JAX and from the port."""
    head_cfg = dict(TINY_MVX_HEAD, pos_cap=MODES[request.param])
    jd = jmvx.MVXDetector(model_cfg=TINY_MVX, head_cfg=head_cfg)
    batch = jax_batch()
    variables = _variables(jd, batch)

    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch)
        total, losses = jd.loss(outs, batch)
        return total, (losses, stats)

    (total, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    want = dict(losses={k: float(v) for k, v in losses.items()},
                total=float(total),
                grads=jax_grads_to_torch(_np_tree(grads)),
                img_grads=jax.tree_util.tree_leaves(grads['img_backbone']),
                state=jax_variables_to_torch(
                    {'params': variables['params'],
                     'batch_stats': _np_tree(stats)}))
    td = tmvx.MVXDetector(TINY_MVX, head_cfg, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    b = port_batch()
    total_t, losses_t = td.loss(td.apply_train(b), b)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(losses={k: float(v.detach()) for k, v in losses_t.items()},
               total=float(total_t.detach()),
               grads=dict(zip(params, grads_t)),
               state=td.trunk.state_dict())
    return want, got


def test_mvx_step_losses(step_pair):
    want, got = step_pair
    assert set(got['losses']) == set(want['losses']) == {
        'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, v in want['losses'].items():
        np.testing.assert_allclose(got['losses'][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got['total'], want['total'], rtol=1e-5)
    assert want['losses']['loss_bbox'] > 0


def test_mvx_step_gradients(step_pair):
    want, got = step_pair
    assert set(got['grads']) == set(want['grads'])
    worst = []
    for k, w in want['grads'].items():
        w = w.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, k
        err = float(np.abs(got['grads'][k].numpy() - w).max()) / scale
        worst.append((err, k))
        assert err <= GRAD_TOL, (k, err)
    print('largest gradient errors / largest value:', sorted(worst)[-3:])


def test_mvx_step_image_branch_learns(step_pair):
    """JAX's own check (``tests/test_mvx_fusion.py``): the image
    backbone's gradient is not zero; the port's is not either, in every
    leaf JAX's is not."""
    want, got = step_pair
    assert sum(float(np.abs(np.asarray(g)).sum())
               for g in want['img_grads']) > 0
    img = {k: v for k, v in got['grads'].items()
           if k.startswith('img_backbone.')}
    assert len(img) == len(want['img_grads']) > 0
    for k, g in img.items():
        assert float(want['grads'][k].abs().max()) > 0, k
        assert float(g.abs().max()) > 0, k


def test_mvx_step_running_stats(step_pair):
    want, got = step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    # 1 encoder + 4 SECOND + 2 SECONDFPN + the image branch's 1 stem + 2
    # stages x 2 + 1 bn_down
    assert len(keys) == 2 * (1 + 4 + 2 + 1 + 4 + 1)
    for k in keys:
        np.testing.assert_allclose(got['state'][k].numpy(),
                                   want['state'][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_mvx_train_step_matches_make_train_step():
    """One AdamW update (weight decay, the default schedule) of the port's
    ``train_step`` against JAX's ``make_train_step`` from the same weights
    and optimizer: metrics, new running statistics, and the new weights.
    Adam's first update is lr * g / (|g| + eps), lr apart for a sign of g,
    so a weight is held to 1e-3 lr where |g| is at least 1e-3 of its
    parameter's largest (there the gradients agree on the sign), and every
    weight to one update (the port's gradients, within 1e-4 of JAX's
    largest, pick the weights)."""
    jd = jmvx.MVXDetector(model_cfg=TINY_MVX, head_cfg=TINY_MVX_HEAD)
    batch = jax_batch()
    variables = _variables(jd, batch)
    opt_j = jts.make_optimizer(LR, total_steps=100)
    step_j = jts.make_train_step(lambda v, b, train: jd.apply_train(v, b),
                                 jd.loss, opt_j)
    state_j = jts.init_state(variables['params'], variables['batch_stats'],
                             opt_j)

    new_j, metrics_j = jax.jit(step_j)(state_j, batch)
    want = jax_variables_to_torch({'params': _np_tree(new_j.params),
                                   'batch_stats': _np_tree(
                                       new_j.batch_stats)})
    td = tmvx.MVXDetector(TINY_MVX, TINY_MVX_HEAD, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    before = {k: v.clone() for k, v in td.trunk.state_dict().items()}
    b = port_batch()
    params = dict(td.trunk.named_parameters())
    g_t = dict(zip(params, torch.autograd.grad(
        td.loss(td.apply_train(b), b)[0], list(params.values()))))
    td.trunk.load_state_dict(before)
    state = td.init_train(LR, total_steps=100)
    state, metrics = td.train_step(b, state)
    assert state.step == 1
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    got = td.trunk.state_dict()
    n_held = 0
    for k, w in want.items():
        w = w.numpy()
        if 'running_' in k:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=k)
            continue
        if k not in g_t:
            continue
        g = np.abs(g_t[k].numpy())
        sel = (g >= 1e-3 * g.max()) & (g > 1e-12)
        diff = np.abs(got[k].numpy() - w)
        assert diff[sel].max() <= 1e-3 * LR, k
        assert diff.max() <= 2.5 * LR, k
        n_held += int(sel.sum())
        assert not np.array_equal(got[k].numpy(), before[k].numpy()), k
    assert n_held > 0.5 * sum(v.numel() for v in g_t.values())


def test_mvx_train_steps_descend():
    """Four port steps on one batch from the seeded init: finite terms, the
    total going down, the image backbone's weights moving."""
    det = tmvx.MVXDetector(TINY_MVX, TINY_MVX_HEAD, device='cpu', seed=3)
    batch = port_batch()
    stem = det.trunk.img_backbone.stem.weight.detach().clone()
    state = det.init_train(LR, total_steps=100)
    losses = []
    for _ in range(4):
        state, metrics = det.train_step(batch, state)
        assert all(math.isfinite(float(v)) for v in metrics.values())
        losses.append(float(metrics['loss']))
    assert losses[-1] < losses[0]
    assert not torch.equal(det.trunk.img_backbone.stem.weight, stem)
    boxes = det.predict(batch)[0]
    assert not det.trunk.training and boxes.shape == (2, 16, 7)
