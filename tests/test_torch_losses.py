"""The PyTorch port's losses vs the JAX package on the CPU, value and
gradient, on the same numpy inputs: the seven Gaussian-distance losses over
``CASES`` (``tests/test_reference_parity.py``), in box-row and
component-plane form; focal, SmoothL1, L1, cross-entropy and Gaussian focal;
and kernel K3's plain version (``ops/gd_loss.py``) against the Pallas
``anchor_gd_loss_pallas`` in interpret mode, for every loss type.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.models.losses import common as jcommon
from mmdet3d_gaussian_tpu.models.losses import gaussian as jgauss
from mmdet3d_gaussian_tpu.ops.pallas import gd_loss_kernel as gdk

from mmdet3d_gaussian_tpu_torch.models.losses import gaussian as tgauss
from mmdet3d_gaussian_tpu_torch.ops import gd_loss as tgd
from mmdet3d_gaussian_tpu_torch.registry import LOSSES

torch.set_num_threads(2)

CASES = [
    ('gwd3d', 'log1p', 1.0),
    ('kld3d', 'log1p', 1.0),
    ('kld3d', 'none', 0.0),
    ('bd3d', 'log1p', 1.0),
    ('jd3d', 'log1p', 1.0),
    ('kld3d_symmax', 'log1p', 1.0),
    ('kld3d_symmin', 'log1p', 1.0),
    ('kfiou3d', 'expm1', 0.0),
    ('kfiou3d', 'nlog', 0.0),
]
IDS = [f'{t}-{f}' for t, f, _ in CASES]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _boxes(rng, n):
    ctr = rng.uniform(-10, 10, (n, 3))
    dims = rng.uniform(0.8, 4.5, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([ctr, dims, yaw], -1).astype(np.float32)


def _value_and_grads(jfn, tfn, *arrays):
    """(value, grad of arg 0) of a scalar loss from JAX and from the port."""
    jv, jg = jax.value_and_grad(jfn)(*[jnp.asarray(a) for a in arrays])
    first = _t(arrays[0]).requires_grad_(True)
    tv = tfn(first, *[_t(a) for a in arrays[1:]])
    (tg,) = torch.autograd.grad(tv, first)
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


@pytest.mark.parametrize('loss_type,fun,tau', CASES, ids=IDS)
def test_gd_loss_rows(loss_type, fun, tau):
    """(N, 7) boxes; pred near the target; zero-weight rows included."""
    rng = np.random.RandomState(0)
    tgt = _boxes(rng, 256)
    pred = tgt + rng.normal(0, 0.3, tgt.shape).astype(np.float32)
    w = (rng.rand(256) > 0.2).astype(np.float32) * rng.uniform(0.5, 2, 256)
    w = w.astype(np.float32)
    cfg = dict(loss_type=loss_type, fun=fun, tau=tau, loss_weight=2.0,
               center_offset=(0, 0, 0.5))
    jl, tl = jgauss.GDLoss(**cfg), LOSSES.build(dict(type='GDLoss', **cfg))
    (jv, jg), (tv, tg) = _value_and_grads(
        lambda p, t, w: jl(p, t, weight=w, avg_factor=50.0),
        lambda p, t, w: tl(p, t, weight=w, avg_factor=50.0), pred, tgt, w)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)
    assert np.abs(jg[w == 0]).max() == 0 and np.abs(jg).max() > 0


@pytest.mark.parametrize('loss_type,fun,tau', CASES, ids=IDS)
def test_gd_loss_planes(loss_type, fun, tau):
    """Component-plane form with (B, M) weights, reduction 'none' and
    'sum', and the functional ``gd_loss``."""
    rng = np.random.RandomState(1)
    tgt = _boxes(rng, 2 * 128).reshape(2, 128, 7)
    pred = tgt + rng.normal(0, 0.5, tgt.shape).astype(np.float32)
    w = (rng.rand(2, 128) > 0.5).astype(np.float32)
    cfg = dict(fun=fun, tau=tau)

    def jf(p, t, w):
        parts = lambda x: tuple(x[..., i] for i in range(7))  # noqa: E731
        none = jgauss.GDLoss(loss_type, reduction='none', **cfg)(
            parts(p), parts(t), weight=w)
        return (jnp.sum(none * 0.5)
                + jgauss.gd_loss(loss_type, parts(p), parts(t), weight=w,
                                 reduction='sum', **cfg))

    def tf(p, t, w):
        none = tgauss.GDLoss(loss_type, reduction='none', **cfg)(
            p.unbind(-1), t.unbind(-1), weight=w)
        return ((none * 0.5).sum()
                + tgauss.gd_loss(loss_type, p.unbind(-1), t.unbind(-1),
                                 weight=w, reduction='sum', **cfg))

    (jv, jg), (tv, tg) = _value_and_grads(jf, tf, pred, tgt, w)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


def test_gd_loss_rejects_bad_config():
    with pytest.raises(ValueError):
        tgauss.GDLoss('kld3d', fun='expm1')
    with pytest.raises(ValueError):
        tgauss.GDLoss('kfiou3d', fun='log1p')
    with pytest.raises(ValueError):
        tgauss.GDLoss('iou3d')


def test_postprocess_matches_jax():
    d = np.linspace(0.0, 0.9, 50).astype(np.float32)
    for fun in ('log1p', 'expm1', 'nlog', 'none'):
        for tau in (0.0, 1.0, 2.0):
            np.testing.assert_allclose(
                tgauss.postprocess(_t(d), fun, tau).numpy(),
                np.asarray(jgauss.postprocess(jnp.asarray(d), fun, tau)),
                rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('with_weight', [True, False])
def test_focal_loss(with_weight):
    rng = np.random.RandomState(2)
    logits = rng.normal(0, 2, (4, 50, 3)).astype(np.float32)
    labels = rng.randint(0, 4, (4, 50)).astype(np.int32)   # 3 = background
    w = rng.rand(4, 50).astype(np.float32)
    cfg = dict(use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.5)
    jl = jcommon.FocalLoss(**cfg)
    tl = LOSSES.build(dict(type='FocalLoss', **cfg))
    kw = dict(avg_factor=17.0) if with_weight else {}
    (jv, jg), (tv, tg) = _value_and_grads(
        lambda p, y, w: jl(p, y, w if with_weight else None, **kw),
        lambda p, y, w: tl(p, y, w if with_weight else None, **kw),
        logits, labels, w)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-8)


def test_smooth_l1_and_l1_losses():
    rng = np.random.RandomState(3)
    pred = rng.normal(0, 0.3, (400,)).astype(np.float32)
    tgt = rng.normal(0, 0.3, (400,)).astype(np.float32)
    w = rng.rand(400).astype(np.float32)
    for name, cfg in (('SmoothL1Loss', dict(beta=1.0 / 9.0, loss_weight=2.0)),
                      ('L1Loss', dict(loss_weight=0.25))):
        jl = getattr(jcommon, name)(**cfg)
        tl = LOSSES.build(dict(type=name, **cfg))
        (jv, jg), (tv, tg) = _value_and_grads(
            lambda p, t, w: jl(p, t, weight=w, avg_factor=9.0),
            lambda p, t, w: tl(p, t, weight=w, avg_factor=9.0),
            pred, tgt, w)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize('use_sigmoid', [False, True])
def test_cross_entropy_loss(use_sigmoid):
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 2, (300, 2)).astype(np.float32)
    target = (rng.randint(0, 2, (300, 2)) if use_sigmoid
              else rng.randint(0, 2, 300)).astype(np.int32)
    w = rng.rand(300).astype(np.float32)
    cfg = dict(use_sigmoid=use_sigmoid, loss_weight=0.2)
    jl = jcommon.CrossEntropyLoss(**cfg)
    tl = LOSSES.build(dict(type='CrossEntropyLoss', **cfg))
    (jv, jg), (tv, tg) = _value_and_grads(
        lambda p, y, w: jl(p, y, w, avg_factor=11.0),
        lambda p, y, w: tl(p, y, w, avg_factor=11.0), logits, target, w)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-8)


def test_gaussian_focal_loss():
    rng = np.random.RandomState(5)
    pred = rng.uniform(0.01, 0.99, (2, 30, 30)).astype(np.float32)
    heat = rng.uniform(0, 1, (2, 30, 30)).astype(np.float32)
    heat[:, ::7, ::5] = 1.0
    jl = jcommon.GaussianFocalLoss()
    tl = LOSSES.build(dict(type='GaussianFocalLoss'))
    (jv, jg), (tv, tg) = _value_and_grads(
        lambda p, t: jl(p, t, avg_factor=12.0),
        lambda p, t: tl(p, t, avg_factor=12.0), pred, heat)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- K3
K3_CFGS = [('kld3d', 'log1p', 1.0), ('gwd3d', 'log1p', 1.0),
           ('bd3d', 'log1p', 1.0), ('jd3d', 'log1p', 1.0),
           ('kld3d_symmax', 'log1p', 1.0), ('kld3d_symmin', 'none', 0.0),
           ('kfiou3d', 'nlog', 0.0), ('kfiou3d', 'expm1', 0.0)]


@pytest.fixture
def gdk_interpret():
    old = gdk.INTERPRET
    gdk.INTERPRET = True
    yield
    gdk.INTERPRET = old


def _k3_data(seed, b=2, hw=1024, a=6):
    """As ``tests/test_gd_loss_kernel.py``: car-sized anchors, small random
    deltas, ~10 % positive weights."""
    rng = np.random.RandomState(seed)
    m = b * hw
    anc = np.zeros((hw, a, 7), np.float32)
    anc[..., 0] = rng.uniform(0, 60, (hw, a))
    anc[..., 1] = rng.uniform(-30, 30, (hw, a))
    anc[..., 2] = -1.78
    anc[..., 3:6] = np.array([1.6, 3.9, 1.56]) * rng.uniform(
        0.8, 1.2, (hw, a, 3))
    anc[..., 6] = rng.choice([0.0, np.pi / 2], (hw, a))
    pred = (rng.randn(m, a * 7) * 0.1).astype(np.float32)
    tgt = (rng.randn(m, a * 7) * 0.1).astype(np.float32)
    w = (rng.rand(m, a) < 0.1).astype(np.float32) * rng.uniform(
        0.5, 2.0, (m, a)).astype(np.float32)
    return anc.reshape(hw, a * 7), pred, tgt, w


@pytest.mark.parametrize('loss_type,fun,tau', K3_CFGS,
                         ids=[f'{t}-{f}' for t, f, _ in K3_CFGS])
def test_k3_plain_matches_pallas(gdk_interpret, loss_type, fun, tau):
    """anchor_gd_loss (K3's plain version on the CPU, through its
    autograd.Function) vs anchor_gd_loss_pallas in interpret mode: the
    weighted sum and d(pred) in the conv layout.  Tolerances as the JAX
    package's own kernel test: f32 sums of ~1,200 terms in another order."""
    hw = 1024
    anc2, pred, tgt, w = _k3_data(0, hw=hw)
    cfg = (loss_type, (0.0, 0.0, 0.5), fun, tau, 1.0)
    (jv, jg), (tv, tg) = _value_and_grads(
        lambda p, t, w, a: gdk.anchor_gd_loss_pallas(p, t, w, a, hw, cfg),
        lambda p, t, w, a: tgd.anchor_gd_loss(p, t, w, a, hw, cfg),
        pred, tgt, w, anc2)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=5e-6)
    assert np.abs(tg.reshape(-1, 6, 7)[w == 0]).max() == 0


def test_k3_wrappers_read_a_channel_slice():
    """The forward wrapper reads pred as a channel slice of a wider conv
    output (row stride > A*7); the backward returns d(pred) contiguous."""
    hw = 64
    anc2, pred, tgt, w = _k3_data(1, hw=hw)
    cfg = ('kld3d', (0.0, 0.0, 0.5), 'log1p', 1.0, 1.0)
    wide = torch.zeros(pred.shape[0], 128)
    wide[:, 18:60] = _t(pred)
    view = wide[:, 18:60]
    args = (_t(tgt), _t(w), _t(anc2), hw, cfg)
    val = tgd.gd_loss_fwd(view, *args)
    np.testing.assert_allclose(float(val), float(tgd.gd_loss_fwd(
        _t(pred), *args)), rtol=0)
    grad = tgd.gd_loss_bwd(torch.tensor(2.0), view, *args)
    assert grad.is_contiguous() and grad.shape == view.shape
    with pytest.raises(ValueError):
        tgd.gd_loss_fwd(_t(pred)[:, :41], *args)
    with pytest.raises(ValueError):
        tgd.gd_loss_fwd(_t(pred), _t(tgt), _t(w), _t(anc2), hw,
                        ('iou3d',) + cfg[1:])
