"""The PyTorch port's train step vs the JAX package on the CPU.

Targets (coder, assigners, ``compact_indices``, ``get_targets``), schedules
and the AdamW chain against their JAX counterparts on the same numpy
inputs; then one TINY PointPillars train step (dynamic voxelize; the port
on the plain canvas, JAX with its defaults, the space-to-depth canvas and
W-folded stage 0) with the JAX weights carried over by
``jax_variables_to_torch``: loss terms, every
parameter gradient (mapped with ``jax_grads_to_torch``) and the new BN
running statistics, for dense targets (``pos_cap=0``, the decoded-box loss
through K3's plain version) and sparse ones (``pos_cap=1024``); then five
port steps on one batch that must descend.

Tolerances: gradients agree to ~3e-6 of each parameter's largest gradient
(f32 sums over a few thousand products in another order, and the JAX
package's space-to-depth / W-folded convolutions against the port's plain
ones); each is held to 2e-5 of it.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdet3d_gaussian_tpu.core import schedules as jsched
from mmdet3d_gaussian_tpu.core.bbox import assigners as jasn
from mmdet3d_gaussian_tpu.core.bbox import coders as jcod
from mmdet3d_gaussian_tpu.core.bbox import structures as jstr
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.ops import scan as jscan
from mmdet3d_gaussian_tpu.parallel import train_state as jts

from mmdet3d_gaussian_tpu_torch.core import schedules as tsched
from mmdet3d_gaussian_tpu_torch.core.bbox import assigners as tasn
from mmdet3d_gaussian_tpu_torch.core.bbox import coders as tcod
from mmdet3d_gaussian_tpu_torch.core.bbox import structures as tstr
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.ops.scan import compact_indices
from mmdet3d_gaussian_tpu_torch.parallel import train_state as tts
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

torch.set_num_threads(2)

TINY_MODEL = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    max_points_per_voxel=16,
    max_voxels_per_sample=1024,
    voxelize_mode='dynamic',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))
MODES = {'dense': 0, 'sparse': 1024}
GRAD_RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize(tree, rng):
    """Redraw BN running statistics, scales and biases (so a swapped mean /
    var, scale / bias or a wrong momentum cannot pass)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out[k] = randomize(v, rng)
        elif k == 'var':
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ('mean', 'bias'):
            out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif k == 'scale':
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _batch(device='cpu'):
    return tdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                pc_range=TINY_MODEL['point_cloud_range'],
                                device=device)


# ---------------------------------------------------------------- targets
def _gt(seed, anchors, b=2, g=6):
    """Padded gt boxes near random anchors (so every class gets positives),
    labelled with the anchor's class; a few padded rows are invalid."""
    rng = np.random.RandomState(seed)
    s = anchors.shape[2]
    flat = anchors.reshape(-1, s, anchors.shape[3], 7)
    cell = rng.randint(0, flat.shape[0], (b, g))
    cls = rng.randint(0, s, (b, g))
    rot = rng.randint(0, anchors.shape[3], (b, g))
    boxes = flat[cell, cls, rot].copy()
    boxes[..., :2] += rng.uniform(-0.3, 0.3, (b, g, 2))
    boxes[..., 3:6] *= rng.uniform(0.85, 1.15, (b, g, 3))
    boxes[..., 6] += rng.uniform(-0.3, 0.3, (b, g))
    valid = rng.rand(b, g) > 0.2
    valid[:, 0] = True
    return boxes.astype(np.float32), cls.astype(np.int32), valid


@pytest.fixture(scope='module')
def heads():
    j = jdet.PointPillarsDetector(model_cfg=TINY_MODEL, head_cfg=TINY_HEAD)
    t = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD, device='cpu')
    return j, t


def test_encode_and_direction_target():
    rng = np.random.RandomState(0)
    anc = np.concatenate([rng.uniform(-20, 20, (500, 3)),
                          rng.uniform(0.5, 4, (500, 3)),
                          rng.choice([0, 1.57], (500, 1))], -1)
    gt = np.concatenate([anc[:, :3] + rng.normal(0, 1, (500, 3)),
                         rng.uniform(0.5, 4, (500, 3)),
                         rng.uniform(-4, 4, (500, 1))], -1)
    anc, gt = anc.astype(np.float32), gt.astype(np.float32)
    want = np.asarray(jcod.DeltaXYZWLHRBBoxCoder().encode(anc, gt))
    got = tcod.DeltaXYZWLHRBBoxCoder().encode(_t(anc), _t(gt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    dir_want = np.asarray(jcod.get_direction_target(anc, want))
    dir_got = tcod.get_direction_target(_t(anc), got).numpy()
    np.testing.assert_array_equal(dir_got, dir_want)
    assert set(np.unique(dir_want)) == {0, 1}
    pj, tj = jcod.add_sin_difference(jnp.asarray(gt), jnp.asarray(anc))
    pt, tt = tcod.add_sin_difference(_t(gt), _t(anc))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    parts = tcod.DeltaXYZWLHRBBoxCoder.decode_parts(_t(anc).unbind(-1),
                                                    got.unbind(-1))
    np.testing.assert_allclose(torch.stack(parts, -1).numpy(), gt,
                               rtol=1e-5, atol=1e-5)


def test_nearest_bev_and_aligned_iou(heads):
    # near the anchors of a 4 x 4 corner of the map, so many boxes overlap
    boxes, _, _ = _gt(1, heads[0].anchors[:4, :4], b=1, g=40)
    boxes = boxes[0]
    want = np.asarray(jstr.nearest_bev(jnp.asarray(boxes)))
    got = tstr.nearest_bev(_t(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for mode in ('iou', 'iof'):
        w = np.asarray(jstr.iou_aligned_2d(jnp.asarray(want[:25]),
                                           jnp.asarray(want[10:]), mode=mode))
        g = tstr.iou_aligned_2d(_t(got[:25]), _t(got[10:]), mode=mode)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
        assert (w > 0).sum() > 15      # beyond the 15 shared boxes


def test_max_iou_assigner_matches_jax(heads):
    """Batched port assigner vs the per-sample JAX one, with don't-care
    boxes; assignments and labels equal."""
    anchors = heads[0].anchors.reshape(-1, 7)
    boxes, labels, valid = _gt(2, heads[0].anchors)
    ign = boxes[:, :2].copy()       # gt 0 and 1 are also don't-care
    asn_cfg = dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.35,
                   ignore_iof_thr=0.5)
    jasg = jasn.MaxIoUAssigner(**asn_cfg)
    tasg = tasn.MaxIoUAssigner(**asn_cfg)
    got = tasg.assign(_t(anchors), _t(boxes), _t(labels), _t(valid),
                      gt_bboxes_ignore=_t(ign),
                      gt_ignore_valid=torch.ones(2, 2, dtype=torch.bool))
    for i in range(2):
        want = jasg.assign(jnp.asarray(anchors), boxes[i], labels[i],
                           valid[i], gt_bboxes_ignore=ign[i],
                           gt_ignore_valid=jnp.ones(2, bool))
        np.testing.assert_array_equal(got.assigned_gt[i].numpy(),
                                      np.asarray(want.assigned_gt))
        np.testing.assert_array_equal(got.labels[i].numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.max_overlaps[i].numpy(),
                                   np.asarray(want.max_overlaps), atol=1e-6)
    assert int((got.assigned_gt > 0).sum()) > 0
    assert int((got.assigned_gt == -1).sum()) > 0


def test_assign_per_class_matches_jax(heads):
    jh, th = heads[0].head, heads[1].head
    anchors = heads[0].anchors
    h, w, s, r, _ = anchors.shape
    boxes, labels, valid = _gt(3, anchors)
    got = tasn.assign_per_class_vectorized(
        _t(anchors).reshape(h * w, s, r, 7), _t(boxes), _t(labels),
        _t(valid), th.assigners)
    for i in range(2):
        want = jasn.assign_per_class_vectorized(
            jnp.asarray(anchors).reshape(h * w, s, r, 7), boxes[i], labels[i],
            valid[i], jh.assigners)
        np.testing.assert_array_equal(got.assigned_gt[i].numpy(),
                                      np.asarray(want.assigned_gt))
        np.testing.assert_array_equal(got.labels[i].numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.max_overlaps[i].numpy(),
                                   np.asarray(want.max_overlaps), atol=1e-6)
    # every valid gt takes at least its best anchor (low-quality match)
    assert int((got.assigned_gt > 0).sum()) >= int(valid.sum())


@pytest.mark.parametrize('n,k,p', [(5000, 64, 0.01), (5000, 64, 0.3),
                                   (300, 300, 0.5), (1000, 8, 0.0)])
def test_compact_indices_matches_jax(n, k, p):
    """First-k-ascending positions: equal to JAX for k below, above and at
    the count of True entries, batched over a leading dim."""
    mask = np.random.RandomState(n + k).rand(3, n) < p
    idx, valid = compact_indices(_t(mask), k)
    for i in range(3):
        wi, wv = jscan.compact_indices(jnp.asarray(mask[i]), k)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))


@pytest.mark.parametrize('mode', MODES)
def test_get_targets_matches_jax(heads, mode):
    jd, td = heads
    jh, th = jd.head, td.head
    jh.pos_cap = th.pos_cap = MODES[mode]
    boxes, labels, valid = _gt(4, jd.anchors)
    want = jax.vmap(jh.get_targets, in_axes=(None, 0, 0, 0))(
        jd.anchors, boxes, labels, valid)
    got = th.get_targets(td.anchors, _t(boxes), _t(labels), _t(valid))
    for f in ('labels', 'label_weights', 'bbox_weights', 'num_pos',
              'dir_targets', 'pos_idx', 'pos_mask', 'pos_dir'):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)
    for f in ('bbox_targets', 'matched_gt', 'pos_bbox_targets',
              'pos_matched_gt', 'pos_anchors'):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f)
    assert int(got.num_pos.min()) > 0


@pytest.mark.parametrize('pos_cap', [0, 1024])
def test_head_loss_plane_path_matches_jax(pos_cap):
    """A decoded-box GD config the fused kernel does not take (an extra
    loss kwarg) goes through the plane path on the raw matched gt, as in
    the JAX package, and a non-zero code_weight adds the sin-difference
    SmoothL1: loss terms and d(bbox_pred) from random head maps."""
    from mmdet3d_gaussian_tpu.models.dense_heads import anchor3d_head as jh
    from mmdet3d_gaussian_tpu_torch.models.dense_heads import \
        anchor3d_head as th
    cfg = dict(jdet.KITTI_3CLASS_HEAD, pos_cap=pos_cap,
               code_weight=[1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 1.0],
               loss_decoded_bbox=dict(type='GDLoss', loss_type='kld3d',
                                      fun='log1p', tau=1.0, loss_weight=5.0,
                                      sqrt=False))
    jhead, thead = jh.GDAnchor3DHead(**cfg), th.GDAnchor3DHead(**cfg)
    anchors = jhead.anchors_for((32, 32))
    boxes, labels, valid = _gt(5, anchors)
    rng = np.random.RandomState(6)
    maps = [rng.normal(0, 0.5, (2, 32, 32, 6 * n)).astype(np.float32)
            for n in (3, 7, 2)]

    def jf(bbox):
        tb = jax.vmap(jhead.get_targets, in_axes=(None, 0, 0, 0))(
            anchors, boxes, labels, valid)
        losses = jhead.loss(maps[0], bbox, maps[2], anchors, tb)
        return sum(losses.values()), losses

    (_, jl), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(maps[1]))
    bbox = _t(maps[1]).requires_grad_(True)
    tb = thead.get_targets(_t(anchors), _t(boxes), _t(labels), _t(valid))
    tl = thead.loss(_t(maps[0]), bbox, _t(maps[2]), _t(anchors), tb)
    (tg,) = torch.autograd.grad(sum(tl.values()), bbox)
    for k, v in jl.items():
        np.testing.assert_allclose(float(tl[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)
    assert float(jl['loss_bbox']) > 0 and np.abs(np.asarray(jg)).max() > 0


# ------------------------------------------------------ schedules, AdamW
def test_schedules_match_jax():
    cyc_j = jsched.cyclic_schedule(1e-3, 100, (10.0, 1e-4), cyclic_times=2,
                                   step_ratio_up=0.4)
    cyc_t = tsched.cyclic_schedule(1e-3, 100, (10.0, 1e-4), cyclic_times=2,
                                   step_ratio_up=0.4)
    st_j = jsched.step_schedule(0.01, [10, 30], 0.1)
    st_t = tsched.step_schedule(0.01, [10, 30], 0.1)
    for step in range(0, 120, 3):
        # the JAX schedules compute in f32, the port's in Python floats
        np.testing.assert_allclose(cyc_t(step), float(cyc_j(step)),
                                   rtol=1e-5)
        np.testing.assert_allclose(st_t(step), float(st_j(step)), rtol=1e-5)


def _opt_params(seed):
    rng = np.random.RandomState(seed)
    return {'a.weight': rng.randn(16, 8, 3, 3).astype(np.float32),
            'a.bias': rng.randn(16).astype(np.float32),
            'b.weight': rng.randn(5, 7).astype(np.float32)}


@pytest.mark.parametrize('kw', [dict(), dict(grad_clip=1.0),
                                dict(momentum_target_ratio=(0.85 / 0.95, 1),
                                     weight_decay=0.05)],
                         ids=['plain', 'clipped', 'cyclic_momentum'])
def test_optimizer_matches_optax(kw):
    """Four AdamW updates on identical gradients vs the JAX package's optax
    chain; with grad_clip=1 every update is clipped."""
    params = _opt_params(0)
    opt_j = jts.make_optimizer(2e-3, total_steps=10, **kw)
    opt_t = tts.make_optimizer(2e-3, total_steps=10, **kw)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: _t(v) for k, v in params.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for i in range(4):
        grads = {k: v * (0.5 + i) for k, v in _opt_params(10 + i).items()}
        uj, sj = opt_j.update({k: jnp.asarray(v) for k, v in grads.items()},
                              sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = opt_t.update({k: _t(v) for k, v in grads.items()}, st, pt)
        pt = {k: pt[k] + ut[k] for k in pt}
        gn = float(tts.global_norm(_t(v) for v in grads.values()))
        np.testing.assert_allclose(gn, float(optax.global_norm(grads)),
                                   rtol=1e-6)
        if 'grad_clip' in kw:
            assert gn > kw['grad_clip']
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert st.count == 4


# ------------------------------------------------------------ train step
@pytest.fixture(scope='module', params=list(MODES))
def step_pair(request):
    """One train step's loss terms, gradients and new running statistics,
    from the JAX package and from the port, on the same weights and batch.
    """
    head_cfg = dict(TINY_HEAD, pos_cap=MODES[request.param])
    jd = jdet.PointPillarsDetector(model_cfg=TINY_MODEL, head_cfg=head_cfg)
    jbatch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                  pc_range=TINY_MODEL['point_cloud_range'])
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), jbatch)
    variables = randomize(variables, np.random.RandomState(0))

    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch)
        total, losses = jd.loss(outs, jbatch)
        return total, (losses, stats)

    (total, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    want = dict(total=float(total),
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_to_torch(_np_tree(grads)),
                state=jax_variables_to_torch(
                    {'params': variables['params'],
                     'batch_stats': _np_tree(stats)}))

    td = tdet.PointPillarsDetector(dict(TINY_MODEL, s2d_canvas='off'),
                                   head_cfg, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    batch = _batch()
    total_t, losses_t = td.loss(td.apply_train(batch), batch)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(total=float(total_t.detach()),
               losses={k: float(v.detach()) for k, v in losses_t.items()},
               grads=dict(zip(params, grads_t)),
               state=td.trunk.state_dict())
    return want, got


def test_train_step_losses(step_pair):
    want, got = step_pair
    assert set(got['losses']) == set(want['losses']) == {
        'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, v in want['losses'].items():
        np.testing.assert_allclose(got['losses'][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got['total'], want['total'], rtol=1e-5)
    assert want['losses']['loss_bbox'] > 0


def test_train_step_gradients(step_pair):
    want, got = step_pair
    assert set(got['grads']) == set(want['grads'])
    for k, w in want['grads'].items():
        w = w.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got['grads'][k].numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def test_train_step_running_stats(step_pair):
    """0.99 old + 0.01 batch, with the biased batch variance."""
    want, got = step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    assert len(keys) == 2 * (1 + 6 + 3)
    for k in keys:
        np.testing.assert_allclose(got['state'][k].numpy(),
                                   want['state'][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_train_steps_descend():
    """Five port train steps on one batch: finite losses that go down;
    parameters and running statistics move."""
    det = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD, device='cpu')
    batch = _batch()
    before = {k: v.clone() for k, v in det.trunk.state_dict().items()}
    state = det.init_train(1e-3, total_steps=100, grad_clip=10.0)
    losses = []
    for _ in range(5):
        state, metrics = det.train_step(batch, state)
        assert set(metrics) == {'loss_cls', 'loss_bbox', 'loss_dir', 'loss',
                                'grad_norm'}
        assert all(math.isfinite(float(v)) for v in metrics.values())
        losses.append(float(metrics['loss']))
    assert state.step == 5 and state.opt_state.count == 5
    assert losses[-1] < losses[0]
    after = det.trunk.state_dict()
    assert not torch.equal(after['backbone.blocks.0.0.weight'],
                           before['backbone.blocks.0.0.weight'])
    assert not torch.equal(after['neck.deblocks.1.1.running_var'],
                           before['neck.deblocks.1.1.running_var'])
    assert int(after['backbone.blocks.0.1.num_batches_tracked']) == 5


def test_train_step_builds_its_state():
    """train_step without a state builds the optimizer and state itself."""
    det = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD, device='cpu')
    state, metrics = det.train_step(_batch())
    assert state.step == 1
    assert float(metrics['grad_norm']) > 0
    # predict after training runs in eval mode on the same trunk
    boxes = det.predict(_batch())[0]
    assert not det.trunk.training and boxes.shape == (2, 32, 7)
