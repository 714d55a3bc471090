"""The PyTorch port's bf16 mixed precision vs the JAX package's
(``compute_dtype='bfloat16'``) on the CPU.

* K4 on bf16 activations: the plain ``moments`` / ``grad_moments`` against
  the JAX kernels in interpret mode (f32 sums in another order, held to
  1e-5 of the per-channel sum of magnitudes).
* ``BatchNorm2d`` on bf16 input against ``FastBatchNorm(dtype='bfloat16')``
  in training and eval: outputs and input gradients within one bf16 step
  (f32 statistics in another order can move a value across a rounding
  boundary), running statistics as in f32.
* The TINY model (s2d canvas on through ``'auto'``): head maps of a predict
  and one train step, against JAX numbers computed in a process of its own
  (``tests/torch_bf16_reference.py``) with XLA's excess precision off, so
  that JAX rounds at every cast its program states (with it on, XLA on the
  CPU skips some, and the port, which rounds at each, is then as far from
  JAX bf16 as JAX bf16 is from f32).  Each map within 2e-2 of its largest
  magnitude of JAX bf16, and, to show that the casts sit where JAX's do,
  the port's error below half of what JAX's own bf16 run differs from its
  f32 run on the same weights (a cast missing or misplaced moves the port
  about as far as that gap).  The same rule for the loss terms (and within
  2e-2 relative) and for every parameter's gradient (and within 5e-2 of
  its largest value: gradients of bf16 activations carry more rounding
  than the maps; the TINY step measured below 1e-2 but for the head
  bias, see ``F32_SUMS``), and the running statistics within 1e-5; the
  same for one dense-target step (``pos_cap=0``: the decoded-box loss
  through K3's plain version, on the f32 cast of the bf16 box map).
* ``get_bboxes`` on JAX's bf16 maps equals JAX's detections (the decode
  casts to f32 as JAX does).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.ops.pallas import bn_kernel as jbn

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models import backbones as tbb
from mmdet3d_gaussian_tpu_torch.ops import bn

from .test_torch_train import TINY_HEAD, TINY_MODEL, _batch, _np_tree, _t, \
    randomize

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

BF16_MODEL = dict(TINY_MODEL, compute_dtype='bfloat16')
MAP_TOL = 2e-2        # of each map's largest magnitude (bf16, 8 bits)
GRAD_TOL = 5e-2       # of each parameter's largest gradient
BF16_STEP = 2.0 ** -7  # largest relative spacing of bf16 values


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a):
    """numpy f32 -> the same bf16 values in torch and JAX."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------- K4 in bf16
@pytest.fixture
def jax_bn_interpret(monkeypatch):
    monkeypatch.setattr(jbn, 'INTERPRET', True)


@pytest.mark.parametrize('layout', ['rows', 'channels_last', 'nchw'])
def test_bn_moments_bf16_match_jax_kernels(jax_bn_interpret, layout):
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 23, 30, 24
    x_t, x_j = _bf16((rng.randn(b, h, w, c) * 2 + 0.5).astype(np.float32))
    g_t, g_j = _bf16(rng.randn(b, h, w, c).astype(np.float32))
    views = {'rows': lambda t: t.reshape(-1, c),
             'channels_last': lambda t: t.permute(0, 3, 1, 2),
             'nchw': lambda t: t.permute(0, 3, 1, 2).contiguous()}
    xv, gv = views[layout](x_t), views[layout](g_t)
    mean = torch.full((c,), 0.4)
    inv = torch.full((c,), 0.7)
    su, sq = bn.moments(xv)
    sg, sgx = bn.grad_moments(gv, xv, mean, inv)
    jsu, jsq = jbn.moments(x_j.reshape(-1, c))
    jsg, jsgx = jbn.grad_moments(g_j.reshape(-1, c), x_j.reshape(-1, c),
                                 jnp.asarray(mean.numpy()),
                                 jnp.asarray(inv.numpy()))
    xf, gf = _np(x_t).reshape(-1, c), _np(g_t).reshape(-1, c)
    mags = (np.abs(xf).sum(0), (xf ** 2).sum(0), np.abs(gf).sum(0),
            np.abs(gf * (xf - 0.4) * 0.7).sum(0))
    for got, want, mag in zip((su, sq, sg, sgx), (jsu, jsq, jsg, jsgx), mags):
        assert got.dtype == torch.float32
        assert np.all(np.abs(_np(got) - _np(want)) <= 1e-5 * mag)


def _bn_pair(train, seed=1, c=24):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 9, 11, c) * 3 + 1).astype(np.float32)
    x_t, x_j = _bf16(x)
    mod = jbn.FastBatchNorm(use_running_average=not train, momentum=0.99,
                            epsilon=1e-3, dtype='bfloat16')
    variables = randomize(_np_tree(mod.init(jax.random.PRNGKey(0), x_j)), rng)
    port = tbb.BatchNorm2d(c, eps=1e-3)
    sd = {'weight': variables['params']['scale'],
          'bias': variables['params']['bias'],
          'running_mean': variables['batch_stats']['mean'],
          'running_var': variables['batch_stats']['var'],
          'num_batches_tracked': np.zeros((), np.int64)}
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()})
    port.train(train)
    return mod, variables, port, x_t, x_j


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_batchnorm_bf16_matches_jax(mode):
    train = mode == 'train'
    mod, variables, port, x_t, x_j = _bn_pair(train)
    w = np.random.RandomState(3).randn(*x_t.shape).astype(np.float32)

    def jf(x):
        y, upd = mod.apply(variables, x, mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd)

    (_, (want, upd)), jg = jax.value_and_grad(jf, has_aux=True)(x_j)
    xin = x_t.clone().requires_grad_(True)
    got = port(xin.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (tg,) = torch.autograd.grad((got.float() * _t(w)).sum(), xin)
    assert got.dtype == tg.dtype == torch.bfloat16
    assert want.dtype == jg.dtype == jnp.bfloat16
    for g, wv in ((got, want), (tg, jg)):
        g, wv = _np(g), _np(wv)
        np.testing.assert_allclose(g, wv, rtol=BF16_STEP, atol=1e-6)
        assert np.mean(g == wv) > 0.99
    if train:
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(upd['batch_stats']['mean']),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(upd['batch_stats']['var']),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------ the TINY bf16 model
@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """JAX's numbers, from ``tests/torch_bf16_reference.py`` run in its own
    process with XLA's excess precision off."""
    out = tmp_path_factory.mktemp('bf16') / 'ref.npz'
    proc = subprocess.run(
        [sys.executable, '-m', 'tests.torch_bf16_reference', str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        arrays = dict(f)

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items()
                if k.startswith(prefix + '/')}
    return group


def _port(ref, head=TINY_HEAD):
    det = tdet.PointPillarsDetector(BF16_MODEL, head, device='cpu')
    det.trunk.load_state_dict({k: torch.from_numpy(v)
                               for k, v in ref('sd').items()}, strict=True)
    assert det.trunk.s2d
    return det


@pytest.fixture(scope='module')
def predict_runs(ref):
    """Head maps of JAX bf16, JAX f32 and the port in bf16 on the same
    weights, and JAX's bf16 detections."""
    m16, m32 = ref('maps16'), ref('maps32')
    port = _port(ref)
    return dict(det=port, j16=[m16[str(i)] for i in range(4)],
                j16_dtype=[str(m16[f'{i}/dtype']) for i in range(4)],
                j32=[m32[str(i)] for i in range(4)],
                port=port.apply_eval(_batch()),
                dets16=[ref('dets16')[str(i)] for i in range(4)])


def test_bf16_predict_map_dtypes(predict_runs):
    assert predict_runs['j16_dtype'] == ['bfloat16'] * 4
    for g, w in zip(predict_runs['port'], predict_runs['j16']):
        assert g.dtype == torch.bfloat16
        assert g.shape == w.shape


@pytest.mark.parametrize('i,name', enumerate(('cls', 'bbox', 'dir',
                                              'packed')))
def test_bf16_predict_maps(predict_runs, i, name):
    g, w16, w32 = (predict_runs[k][i] for k in ('port', 'j16', 'j32'))
    err, gap = _rel(g, w16), _rel(w16, w32)
    print(f'{name}: port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {gap:.3g} '
          f'(of the largest magnitude)')
    assert err <= MAP_TOL
    assert err < 0.5 * gap


def test_bf16_get_bboxes_on_jax_maps(predict_runs):
    port, maps, want = (predict_runs[k] for k in ('det', 'j16', 'dets16'))
    t = [torch.from_numpy(m).to(torch.bfloat16) for m in maps[:3]]
    got = [x.numpy() for x in port.head.get_bboxes(*t, port.anchors)]
    assert want[3].sum() >= 5
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], atol=1e-6)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], rtol=1e-6,
                               atol=1e-5)


def _step_runs(ref, head, tag):
    """One train step: loss terms, gradients and running statistics of JAX
    bf16, JAX f32 (``tag`` names them in ``ref``) and the port in bf16."""
    port = _port(ref, head)
    tb = _batch()
    total, losses = port.loss(port.apply_train(tb), tb)
    params = dict(port.trunk.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return dict(
        port=dict(losses={k: float(v.detach()) for k, v in losses.items()},
                  grads=dict(zip(params, grads)),
                  state=port.trunk.state_dict()),
        **{name: dict(losses={k: float(v) for k, v in
                              ref(f'loss{n}{tag}').items()},
                      grads=ref(f'grad{n}{tag}'))
           for name, n in (('j16', '16'), ('j32', '32'))})


@pytest.fixture(scope='module')
def step_runs(ref):
    """One sparse-target train step, with JAX's running statistics."""
    runs = _step_runs(ref, TINY_HEAD, '')
    runs['j16']['state'] = ref('state16')
    return runs


@pytest.fixture(scope='module')
def dense_step_runs(ref):
    """One dense-target train step (``pos_cap=0``: K3 in the port)."""
    return _step_runs(ref, dict(TINY_HEAD, pos_cap=0), 'd')


def _check_losses(runs):
    got, want, f32 = (runs[k]['losses'] for k in ('port', 'j16', 'j32'))
    assert set(got) == set(want) == {'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, v in want.items():
        print(f'{k}: port {got[k]:.6g}, JAX bf16 {v:.6g}, JAX f32 '
              f'{f32[k]:.6g}')
        np.testing.assert_allclose(got[k], v, rtol=2e-2, err_msg=k)
        assert abs(got[k] - v) < 0.5 * abs(v - f32[k]), k


def test_bf16_train_step_losses(step_runs):
    _check_losses(step_runs)


def test_bf16_dense_step_losses(dense_step_runs):
    _check_losses(dense_step_runs)


# the cls bias's gradient is a sum of the bf16 cotangent over every cell
# (the focal loss reaches them all; the reg and dir terms only the
# positive anchors); XLA on the CPU accumulates such a sum in bf16 (0.62
# of the sum off for 2,048 positive values), PyTorch in f32, so there the
# port is held to the JAX f32 gradient
F32_SUMS = ('bbox_head.conv_cls.bias',)


def _check_gradients(runs):
    got, want, f32 = (runs[k]['grads'] for k in ('port', 'j16', 'j32'))
    assert set(got) == set(want)
    worst = []
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        ref = f32[k] if k in F32_SUMS else w
        err, gap = _rel(got[k], ref), _rel(w, f32[k])
        worst.append((err / gap, err, gap, k))
        assert err <= GRAD_TOL, (k, err)
        assert err < 0.5 * gap, (k, err, gap)
    worst.sort(reverse=True)
    print('largest port error / JAX bf16-vs-f32 gap:', worst[:3])
    for k in F32_SUMS:
        print(f'{k}: port vs JAX f32 {_rel(got[k], f32[k]):.3g}, JAX bf16 '
              f'vs JAX f32 {_rel(want[k], f32[k]):.3g}')


def test_bf16_train_step_gradients(step_runs):
    _check_gradients(step_runs)


def test_bf16_dense_step_gradients(dense_step_runs):
    _check_gradients(dense_step_runs)


def test_bf16_transposed_conv_gradient():
    """The neck's bf16 transposed conv (the TINY stride-4 level, 64 -> 16
    channels on an 8 x 8 map) against f32: output and both gradients
    within 1e-2 of their largest value.  PyTorch's CPU bf16
    ``conv_transpose2d`` misses its input gradient at this shape (printed,
    not checked), so the port computes it as a matmul and a
    depth-to-space reshape."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 8, 8, generator=gen)
    g = torch.randn(2, 16, 32, 32, generator=gen)
    conv = tbb.ConvTranspose2d(64, 16, 4, stride=4, bias=False,
                               compute_dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(64, 16, 4, 4, generator=gen) * 0.1)

    def run(fn, dt):
        xx = x.to(dt).requires_grad_(True)
        w = conv.weight.detach().clone().requires_grad_(True)
        y = fn(xx, w)
        return (y,) + torch.autograd.grad(y, [xx, w], g.to(y.dtype))

    ref = run(lambda xx, w: torch.nn.functional.conv_transpose2d(
        xx, w, None, 4), torch.float32)

    got = run(lambda xx, w: torch.func.functional_call(
        conv, {'weight': w}, (xx,)), torch.bfloat16)
    lib = run(lambda xx, w: torch.nn.functional.conv_transpose2d(
        xx, w.bfloat16(), None, 4), torch.bfloat16)
    names = ('output', 'input gradient', 'weight gradient')
    for name, a, b, c in zip(names, got, ref, lib):
        print(f'{name}: port {_rel(a, b):.3g}, PyTorch bf16 conv_transpose2d '
              f'{_rel(c, b):.3g} of the largest f32 value')
        assert _rel(a, b) <= 1e-2, name


def test_bf16_train_step_running_stats(step_runs):
    """Statistics are f32 sums over the same bf16 activations."""
    got, want = step_runs['port']['state'], step_runs['j16']['state']
    assert len(want) == 2 * (1 + 6 + 3)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
