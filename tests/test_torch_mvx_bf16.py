"""The PyTorch port's MVX in bf16 (``compute_dtype='bfloat16'``) against
the JAX package's on the CPU.

* flax's ``nn.BatchNorm`` (no dtype) on a bf16 input, the image branch's
  BatchNorm, against ``BatchNorm2d(promote=True)`` in training and eval:
  an f32 output within 1e-6 of its largest magnitude, a bf16 input
  gradient within one bf16 step, the running statistics as in f32.
* The TINY MVX of ``tests/test_torch_mvx.py``, against JAX numbers made in
  a process of its own with XLA's excess precision off
  (``tests/torch_bf16_reference.py ... mvx``): the dtype of every module
  output of the image branch equal to JAX's; the head maps of a predict,
  the loss terms and every parameter's gradient of one sparse-target step
  by the rule of ``tests/test_torch_bf16.py`` (within 2e-2 of JAX bf16
  and nearer to it than half of JAX bf16's own distance from JAX f32; the
  gradients within 5e-2 of their largest value); the running statistics
  within 1e-5; ``get_bboxes`` on JAX's bf16 maps equal to JAX's
  detections.

In a training step every BatchNorm's f32 statistics are sums whose order
differs between XLA and PyTorch (~1e-6 of the variance); where a
BatchNorm's f32 output meets a bf16 cast, a few values round the other
way, the next BatchNorm's statistics carry that on, and the TINY step's
gradients end about as far from JAX bf16 as JAX bf16 is from f32 (port
vs JAX bf16 up to 2.9x that gap, measured).  So the port's step replays
the batch mean and variance JAX bf16 computed in each BatchNorm (recorded
by the reference run), as ``chip_smoke.py`` replays the card's sums on
the CPU; the statistics' own sums are held in ``tests/test_torch_mvx.py``
and ``tests/test_torch_mvx_train.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu_torch.engine import mvx as tmvx
from mmdet3d_gaussian_tpu_torch.models import backbones as tbb
from mmdet3d_gaussian_tpu_torch.ops import bn

from .test_mvx_fusion import TINY_MVX, TINY_MVX_HEAD
from .test_torch_bf16 import (BF16_STEP, F32_SUMS, GRAD_TOL, MAP_TOL, _bf16,
                              _check_losses, _rel)
from .test_torch_mvx import port_batch
from .test_torch_train import _np_tree, _t, randomize

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

BF16_MVX = dict(TINY_MVX, compute_dtype='bfloat16')


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_promoting_batchnorm_matches_flax(mode):
    train = mode == 'train'
    rng = np.random.RandomState(1)
    c = 24
    x_t, x_j = _bf16((rng.randn(2, 9, 11, c) * 3 + 1).astype(np.float32))
    mod = fnn.BatchNorm(use_running_average=not train, momentum=0.99,
                        epsilon=1e-3)
    variables = randomize(_np_tree(mod.init(jax.random.PRNGKey(0), x_j)),
                          rng)
    port = tbb.BatchNorm2d(c, eps=1e-3, promote=True)
    port.load_state_dict({
        'weight': _t(variables['params']['scale']),
        'bias': _t(variables['params']['bias']),
        'running_mean': _t(variables['batch_stats']['mean']),
        'running_var': _t(variables['batch_stats']['var']),
        'num_batches_tracked': torch.tensor(0)})
    port.train(train)
    w = rng.randn(*x_t.shape).astype(np.float32)

    def jf(x):
        y, upd = mod.apply(variables, x, mutable=['batch_stats'])
        return jnp.sum(y * w), (y, upd)

    (_, (want, upd)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        x_j)
    xin = x_t.clone().requires_grad_(True)
    got = port(xin.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (tg,) = torch.autograd.grad((got * _t(w)).sum(), xin)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert jg.dtype == jnp.bfloat16 and tg.dtype == torch.bfloat16
    assert _rel(got, want) <= 1e-6
    # JAX rounds the gradient of each of x's two uses (the statistics, the
    # centring) to bf16 and adds them in bf16, the port rounds their f32
    # sum once: one bf16 step of the largest value apart
    assert _rel(tg, jg) <= BF16_STEP
    if train:
        for name, key in (('running_mean', 'mean'), ('running_var', 'var')):
            np.testing.assert_allclose(
                getattr(port, name).numpy(),
                np.asarray(upd['batch_stats'][key]), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """JAX's numbers, from ``tests/torch_bf16_reference.py ... mvx`` run in
    its own process with XLA's excess precision off."""
    out = tmp_path_factory.mktemp('bf16_mvx') / 'ref.npz'
    proc = subprocess.run(
        [sys.executable, '-m', 'tests.torch_bf16_reference', str(out),
         'mvx'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        arrays = dict(f)

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items()
                if k.startswith(prefix + '/')}
    return group


def _port(ref, head=TINY_MVX_HEAD):
    det = tmvx.MVXDetector(BF16_MVX, head, device='cpu')
    det.trunk.load_state_dict({k: torch.from_numpy(v)
                               for k, v in ref('sd').items()}, strict=True)
    return det


def test_mvx_bf16_image_branch_dtypes(ref):
    """Each module output of the image branch (convolutions bf16, the
    BatchNorms, blocks and backbone maps f32, the neck's maps bf16) has
    JAX's dtype."""
    want = {k: str(v) for k, v in ref('dtypes').items()}
    det = _port(ref)
    got, hooks = {}, []
    for name, mod in det.trunk.named_modules():
        if not name.startswith(('img_backbone', 'img_neck')):
            continue

        def hook(_m, _i, out, name=name):
            outs = out if isinstance(out, (list, tuple)) else [out]
            path = name.replace('.', '/')
            if len(outs) == 1:
                got[path] = str(outs[0].dtype).replace('torch.', '')
            for i, o in enumerate(outs if len(outs) > 1 else []):
                got[f'{path}/{i}'] = str(o.dtype).replace('torch.', '')
        hooks.append(mod.register_forward_hook(hook))
    det.apply_eval(port_batch())
    for h in hooks:
        h.remove()
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert {k: got[k] for k in want} == want
    assert want['img_backbone/stem'] == 'bfloat16'
    assert want['img_backbone/stem_bn'] == 'float32'
    assert want['img_backbone/stage1_block0/bn_down'] == 'float32'
    assert want['img_neck/fpn_out_0'] == 'bfloat16'
    assert len(want) >= 20


@pytest.fixture(scope='module')
def predict_runs(ref):
    m16, m32 = ref('maps16'), ref('maps32')
    port = _port(ref)
    return dict(det=port, j16=[m16[str(i)] for i in range(4)],
                j16_dtype=[str(m16[f'{i}/dtype']) for i in range(4)],
                j32=[m32[str(i)] for i in range(4)],
                port=port.apply_eval(port_batch()),
                dets16=[ref('dets16')[str(i)] for i in range(4)])


def test_mvx_bf16_predict_map_dtypes(predict_runs):
    assert predict_runs['j16_dtype'] == ['bfloat16'] * 4
    for g, w in zip(predict_runs['port'], predict_runs['j16']):
        assert g.dtype == torch.bfloat16
        assert g.shape == w.shape


@pytest.mark.parametrize('i,name', enumerate(('cls', 'bbox', 'dir',
                                              'packed')))
def test_mvx_bf16_predict_maps(predict_runs, i, name):
    g, w16, w32 = (predict_runs[k][i] for k in ('port', 'j16', 'j32'))
    err, gap = _rel(g, w16), _rel(w16, w32)
    print(f'{name}: port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {gap:.3g} '
          f'(of the largest magnitude)')
    assert err <= MAP_TOL
    assert err < 0.5 * gap


def test_mvx_bf16_predict(predict_runs):
    """``get_bboxes`` on JAX's bf16 maps gives JAX's detections; the
    port's own bf16 predict keeps finite boxes."""
    port, maps, want = (predict_runs[k] for k in ('det', 'j16', 'dets16'))
    t = [torch.from_numpy(m).to(torch.bfloat16) for m in maps[:3]]
    got = [x.numpy() for x in port.head.get_bboxes(*t, port.anchors)]
    assert want[3].sum() >= 5
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], atol=1e-6)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], rtol=1e-6,
                               atol=1e-5)
    boxes, scores, _, valid = port.predict(port_batch())
    assert bool(valid.any()) and bool(torch.isfinite(boxes).all())


@pytest.fixture(scope='module')
def step_runs(ref):
    """One sparse-target step of the port with JAX bf16's batch statistics
    replayed (each BatchNorm's mean and variance, in call order)."""
    port = _port(ref)
    b = port_batch()
    stats = ref('bnstats16')
    replay = [(torch.from_numpy(stats[f'{i}/mean']),
               torch.from_numpy(stats[f'{i}/var']))
              for i in range(len(stats) // 2)]
    calls = []

    def batch_stats(x):
        mean, var = replay[len(calls)]
        calls.append(x.shape[1])
        assert mean.shape == (x.shape[1],)
        return mean, var
    original, bn.batch_stats = bn.batch_stats, batch_stats
    try:
        total, losses = port.loss(port.apply_train(b), b)
    finally:
        bn.batch_stats = original
    # the image branch's 6, SECOND's 4 and SECONDFPN's 2
    assert len(calls) == len(replay) == 12
    params = dict(port.trunk.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return dict(
        port=dict(losses={k: float(v.detach()) for k, v in losses.items()},
                  grads=dict(zip(params, grads)),
                  state=port.trunk.state_dict()),
        j16=dict(losses={k: float(v) for k, v in ref('loss16').items()},
                 grads=ref('grad16'), state=ref('state16')),
        j32=dict(losses={k: float(v) for k, v in ref('loss32').items()},
                 grads=ref('grad32')))


def test_mvx_bf16_step_losses(step_runs):
    _check_losses(step_runs)


def test_mvx_bf16_step_gradients(step_runs):
    """The rule of ``tests/test_torch_bf16.py``, where a leaf's JAX bf16
    gradient is more than a bf16 step from its f32 one; a leaf nearer
    than that (the head's, sums of a few positive anchors' bf16
    cotangents, which XLA on the CPU accumulates in bf16) cannot show a
    misplaced cast apart from its last rounding, and is held to one bf16
    step of its largest value instead."""
    got, want, f32 = (step_runs[k]['grads'] for k in ('port', 'j16', 'j32'))
    assert set(got) == set(want)
    assert any(float(g.abs().max()) > 0 for k, g in got.items()
               if k.startswith('img_backbone.'))
    worst = []
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        ref = f32[k] if k in F32_SUMS else w
        err, gap = _rel(got[k], ref), _rel(w, f32[k])
        worst.append((err / gap, err, gap, k))
        assert err <= GRAD_TOL, (k, err)
        assert err < 0.5 * gap or err <= BF16_STEP, (k, err, gap)
    worst.sort(reverse=True)
    print('largest port error / JAX bf16-vs-f32 gap:', worst[:4])
    assert sum(r[0] >= 0.5 for r in worst) <= 3


def test_mvx_bf16_step_running_stats(step_runs):
    got, want = step_runs['port']['state'], step_runs['j16']['state']
    assert len(want) == 2 * 13
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
