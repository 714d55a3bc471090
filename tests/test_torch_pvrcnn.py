"""The port's PV-RCNN against the JAX package on the CPU.

The RoI stage's functions (``assign_and_sample``, the canonical targets,
the decode, the corner loss, the mask head's targets) and the RPN's
class-agnostic ``get_proposals`` on inputs drawn from a seed; then the
TINY two-stage model of ``tests/test_pvrcnn.py`` with JAX's weights
(BatchNorm statistics, scales and biases redrawn) moved by the converter:
voxelize, the sparse levels, FPS, the ball queries, proposals and the
predict; one train step on a batch whose first two GT boxes a sample are
train-mode proposals (so the RPN and the RoI stage both have positives):
every loss term, every gradient (through ``jax_grads_to_torch``), the new
running statistics, and one AdamW update against optax on JAX's
gradients.  Dropout is off on both sides.

Tolerances: integers exactly (voxel coords, every level's sites and
overflow, FPS and ball-query indices, proposal and NMS keep, samples'
masks, segmentation targets); box outputs, targets and the predict within
1e-5 of their scale; the train step's samples and loss terms within 1e-4
(``STEP_TOL``); each gradient within 5e-4 of that parameter's largest
gradient (``GRAD_TOL``: JAX's own f32 error on this step, measured against
a float64 run of the port).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.core.bbox.coders import \
    DeltaXYZWLHRBBoxCoder as JCoder
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.engine.pvrcnn import PVRCNNDetector as JDet
from mmdet3d_gaussian_tpu.models import middle_encoders as jme
from mmdet3d_gaussian_tpu.models import roi_heads as jroi
from mmdet3d_gaussian_tpu.models.dense_heads.anchor3d_head import \
    GDAnchor3DHead as JHead
from mmdet3d_gaussian_tpu.ops import vsa as jvsa
from mmdet3d_gaussian_tpu.parallel import train_state as jts

from mmdet3d_gaussian_tpu_torch.core.bbox.coders import \
    DeltaXYZWLHRBBoxCoder as TCoder
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import PVRCNNDetector as TDet
from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import positive_batch
from mmdet3d_gaussian_tpu_torch.models import roi_heads as troi
from mmdet3d_gaussian_tpu_torch.models.dense_heads.anchor3d_head import \
    GDAnchor3DHead as THead
from mmdet3d_gaussian_tpu_torch.ops import vsa as tvsa
from mmdet3d_gaussian_tpu_torch.parallel import train_state as tts
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from tests.test_pvrcnn import TINY_PVRCNN, TINY_RPN
from tests.test_torch_sparse_conv import _t, close, randomize

torch.set_num_threads(2)

# The TINY step's gradients, of each parameter's largest: against a
# float64 run of the port on this batch (its discrete steps in f32), JAX's
# f32 gradient is up to 3.4e-4 off (the mask head's output bias, a sum of
# cancelling focal gradients over the keypoints; 1.5e-4 elsewhere) and the
# port's f32 8.7e-5, so the two are held to 5e-4 of each other
GRAD_TOL = 5e-4
# the step's outputs and loss terms: the proposals differ by f32 rounding
# between the packages, and the corner loss on random RoI deltas (~100)
# carries it to ~1.3e-5 relative
STEP_TOL = 1e-4
B, N, G = 2, 512, 4
PCR = TINY_PVRCNN['point_cloud_range']


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rois(rng, n, spread=10.0):
    return np.c_[rng.uniform(-spread, spread, (n, 2)),
                 rng.uniform(-2, -1, (n, 1)), rng.uniform(2.5, 4.5, (n, 2)),
                 rng.uniform(1.3, 1.8, (n, 1)),
                 rng.uniform(-4 * np.pi, 4 * np.pi, (n, 1))].astype(
        np.float32)


# ------------------------------------------------------- RoI stage math
def sample_inputs(seed, b=3, p=40, g=5):
    """Proposals around the gts (some exact, some jittered, some far, a
    few invalid), per-class labels, padded gts."""
    rng = np.random.RandomState(seed)
    gt = np.stack([rois(rng, g, 6.0) for _ in range(b)])
    gl = rng.randint(0, 3, (b, g)).astype(np.int32)
    gv = np.ones((b, g), bool)
    gv[:, -1] = False
    owner = rng.randint(0, g, (b, p))
    props = np.take_along_axis(gt, owner[..., None], 1).copy()
    props[:, :, :3] += rng.randn(b, p, 3).astype(np.float32) * \
        rng.choice([0.0, 0.2, 1.0, 8.0], (b, p, 1))
    labels = np.take_along_axis(gl, owner, 1)
    labels[:, ::7] = (labels[:, ::7] + 1) % 3       # wrong class: no match
    valid = rng.rand(b, p) > 0.1
    return props.astype(np.float32), labels, valid, gt, gl, gv


@pytest.mark.parametrize('num_samples', [16, 40])
def test_assign_and_sample_matches_jax(num_samples):
    """Order, masks and the matched gts of the ranked sampling: positives
    (capped at half), hard and easy negatives, and ties at -1 (invalid
    and discarded proposals) to the lower index."""
    args = sample_inputs(0)
    want = jax.jit(jax.vmap(lambda *a: jroi.assign_and_sample(
        *a, num_samples=num_samples)))(*map(jnp.asarray, args))
    got = troi.assign_and_sample(*map(_t, args), num_samples=num_samples)
    for f in ('roi_labels', 'is_pos', 'valid'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ('rois', 'gt_of_roi', 'ious'):
        close(getattr(got, f), getattr(want, f), what=f)
    pos = got.is_pos.sum(1)
    assert (pos > 0).all() and (pos <= num_samples // 2).all()
    assert (~got.valid).any() == (num_samples == 40)


def samples_of(seed, b=2, r=24):
    rng = np.random.RandomState(seed)
    rr = np.stack([rois(rng, r) for _ in range(b)])
    gt = rr + rng.uniform(-0.4, 0.4, rr.shape).astype(np.float32)
    gt[..., 6] += rng.choice([0.0, np.pi], (b, r))    # opposite headings
    ious = rng.uniform(0, 1, (b, r)).astype(np.float32)
    arrays = dict(rois=rr, roi_labels=np.zeros((b, r), np.int32),
                  gt_of_roi=gt, ious=ious, is_pos=ious > 0.55,
                  valid=rng.rand(b, r) > 0.1)
    return (jroi.RoISamples(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            troi.RoISamples(**{k: _t(v) for k, v in arrays.items()}))


def test_roi_targets_decode_and_corner_loss_match_jax():
    js, ts = samples_of(1)
    want = jax.vmap(lambda s: jroi.roi_canonical_targets(s, JCoder()))(js)
    got = troi.roi_canonical_targets(ts, TCoder())
    for name, g, w in zip(('label', 'label_w', 'bbox', 'reg_w'), got, want):
        close(g, w, what=name)
    deltas = np.random.RandomState(2).randn(2, 24, 7).astype(np.float32) * .2
    close(troi.decode_roi_boxes(ts.rois, _t(deltas), TCoder()),
          jroi.decode_roi_boxes(js.rois, jnp.asarray(deltas), JCoder()),
          what='decode')
    pred = np.asarray(js.gt_of_roi).reshape(-1, 7) + deltas.reshape(-1, 7)
    gt = np.asarray(js.gt_of_roi).reshape(-1, 7)
    close(troi.corner_loss_lidar(_t(pred), _t(gt)),
          jroi.corner_loss_lidar(jnp.asarray(pred), jnp.asarray(gt)),
          what='corner')


def test_rcnn_losses_match_jax():
    """The second stage's loss group on drawn samples with positives."""
    js, ts = samples_of(3)
    rng = np.random.RandomState(4)
    cls = rng.randn(2, 24, 1).astype(np.float32)
    reg = (rng.randn(2, 24, 7) * 0.2).astype(np.float32)
    want = JDet(TINY_PVRCNN, TINY_RPN).rcnn_losses(js, jnp.asarray(cls),
                                                   jnp.asarray(reg))
    got = tdet_tiny().rcnn_losses(ts, _t(cls), _t(reg))
    assert set(got) == set(want)
    for k, w in want.items():
        assert float(w) > 0, k
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5,
                                   err_msg=k)


def test_corner_loss_nan_on_an_overflowed_negative():
    """The JAX package takes the corner loss of every sampled RoI and
    weights it by 0 off the positives, so a negative whose size decode
    overflows (inf corners) makes the sum NaN (0 x NaN): a reference fault
    (ROADMAP section 3).  The port takes the positives' only, as upstream
    does: its losses and their gradient in the deltas are finite and equal
    JAX's on the same samples with that negative's deltas at 0."""
    rois = np.tile(np.array([[1, 2, -1, 3.9, 1.6, 1.5, 0.3]], np.float32),
                   (1, 4, 1))
    arrays = dict(rois=rois, roi_labels=np.zeros((1, 4), np.int32),
                  gt_of_roi=rois + 0.1,
                  ious=np.array([[0.8, 0.3, 0.1, 0.0]], np.float32),
                  is_pos=np.array([[True, False, False, False]]),
                  valid=np.ones((1, 4), bool))
    reg = np.random.RandomState(7).randn(1, 4, 7).astype(np.float32) * 0.2
    clean = reg.copy()
    clean[0, 3] = 0.0
    reg[0, 3, 3] = 100.0                  # exp(100) overflows f32
    cls = np.zeros((1, 4, 1), np.float32)
    jdet = JDet(TINY_PVRCNN, TINY_RPN)
    js = jroi.RoISamples(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def jax_losses(r):
        return jdet.rcnn_losses(js, jnp.asarray(cls), r)

    def jax_total(r):
        return sum(jax_losses(r).values())
    assert np.isnan(float(jax_losses(jnp.asarray(reg))['loss_corner']))
    want = jax_losses(jnp.asarray(clean))
    want_grad = np.asarray(jax.grad(jax_total)(jnp.asarray(clean)))
    treg = _t(reg).requires_grad_(True)
    got = tdet_tiny().rcnn_losses(
        troi.RoISamples(**{k: _t(v) for k, v in arrays.items()}), _t(cls),
        treg)
    sum(got.values()).backward()
    for k, w in want.items():
        assert float(w) > 0, k
        np.testing.assert_allclose(float(got[k].detach()), float(w),
                                   rtol=1e-5, err_msg=k)
    grad = treg.grad.numpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def tdet_tiny():
    return TDet(TINY_PVRCNN, TINY_RPN, device='cpu')


def test_mask_head_targets_match_jax():
    """Inside, in the ignore ring of the enlarged boxes, background, and
    padded gts left out."""
    rng = np.random.RandomState(5)
    kp = np.c_[rng.uniform(-10, 10, (2 * 256, 2)),
               rng.uniform(-2.4, 0.5, (2 * 256, 1))].reshape(
        2, 256, 3).astype(np.float32)
    gt = np.stack([rois(rng, 6, 8.0) for _ in range(2)])
    gl = rng.randint(0, 3, (2, 6)).astype(np.int32)
    gv = rng.rand(2, 6) > 0.2
    want = np.asarray(jroi.PointwiseMaskHead().get_targets(
        *map(jnp.asarray, (kp, gt, gl, gv))))
    got = troi.PointwiseMaskHead().get_targets(
        *map(_t, (kp, gt, gl, gv))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got == 3).any() and (
        (got >= 0) & (got < 3)).any()


def test_get_proposals_matches_jax():
    """Class-agnostic proposals of two samples, batched into one NMS
    problem each, against JAX's per-sample ``get_proposals``; overlapping
    boxes of different classes suppress each other."""
    hc = copy.deepcopy(tdet.KITTI_3CLASS_HEAD)
    hc['anchor_generator'] = dict(
        ranges=[[0., 0., -1., 8., 8., -1.]] * 3,
        sizes=[[3.9, 1.6, 1.56], [1.76, 0.6, 1.73], [0.8, 0.6, 1.73]],
        rotations=[0.0, 1.57])
    hc['test_cfg'] = dict(use_rotate_nms=True, nms_thr=0.1, score_thr=0.0,
                          nms_pre=48, max_num=12)
    jh, th = JHead(**hc), THead(**hc)
    anchors = jh.anchors_for((4, 4))                # (4, 4, 3, 2, 7)
    rng = np.random.RandomState(6)
    cls = rng.randn(2, 4, 4, 18).astype(np.float32)
    # a car anchor (class 0) and a cyclist-size anchor inside it (class 1)
    # in one cell: the second is suppressed across classes
    cls[0, 0, 0, 0], cls[0, 0, 0, 2 * 3 + 1] = 6.0, 5.5
    bbox = (rng.randn(2, 4, 4, 42) * 0.1).astype(np.float32)
    bbox[0, 0, 0, :21] = 0.0          # those two boxes are their anchors
    dirp = rng.randn(2, 4, 4, 12).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda c, b, d: jh.get_proposals(c, b, d, anchors)))(
        *map(jnp.asarray, (cls, bbox, dirp)))
    got = th.get_proposals(_t(cls), _t(bbox), _t(dirp), _t(anchors))
    close(got[0], want[0], what='boxes')
    close(got[1], want[1], what='scores')
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    top = torch.sigmoid(torch.tensor([6.0, 5.5]))
    assert torch.isclose(got[1][0, 0], top[0]) and int(got[2][0, 0]) == 0
    assert not torch.isclose(got[1], top[1]).any()


# ------------------------------------------------------------ TINY model
def tiny_batch(td, seed=0):
    """``synthetic_batch`` with RPN and RoI positives from ``td``'s
    train-mode proposals (``engine.pvrcnn.positive_batch``)."""
    batch = tdet.synthetic_batch(B, N, G, seed=seed, pc_range=PCR,
                                 device='cpu')
    out = positive_batch(td, batch)
    assert out['gt_valid'][:, :2].all()
    return out


@pytest.fixture(scope='module')
def tiny():
    """The JAX TINY detector's outputs, computed once: eval (voxelize, the
    levels, keypoints, proposals, predict) and one train step (losses,
    gradients, new statistics, samples); the port with the same weights."""
    jd = JDet(TINY_PVRCNN, TINY_RPN)
    jb0 = jdet.synthetic_batch(batch_size=B, num_points=N, num_gt=G,
                               pc_range=PCR)
    v = np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0), jb0))
    v = randomize(v, np.random.RandomState(0))
    td = tdet_tiny()
    td.trunk.load_state_dict(jax_variables_to_torch(v), strict=True)
    batch = tiny_batch(td)
    jb = {k: jnp.asarray(t.numpy()) for k, t in batch.items()}

    @jax.jit
    def eval_all(v, b):
        feats, coords = jd.voxelize(b)
        levels = jd.first.apply(v['first'], feats, coords, B)[0]
        out2, props = jd.apply_eval(v, b)
        return (feats, coords, [(l.coords, l.keys, l.overflow)
                                for l in levels], levels[0], out2, props,
                jd.predict(v, b))

    def loss_fn(params):
        vv = {s: {'params': params[s], 'batch_stats': v[s]['batch_stats']}
              for s in ('first', 'second')}
        outs, stats = jd.apply_train(vv, jb)
        total, losses = jd.loss(outs, jb)
        return total, (losses, stats, outs[2], outs[1]['keypoints'])

    (total, (losses, stats, samples, kp)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        {s: v[s]['params'] for s in ('first', 'second')})
    ev = eval_all(v, jb)
    return dict(jd=jd, v=v, td=td, batch=batch, jb=jb, eval=ev,
                train=dict(total=float(total), losses=np_tree(losses),
                           stats=np_tree(stats), samples=samples,
                           keypoints=np.asarray(kp), grads=np_tree(grads)))


@pytest.fixture(scope='module')
def port_eval(tiny):
    td, batch = tiny['td'], tiny['batch']
    with torch.inference_mode():
        td.trunk.eval()
        feats, coords = td.voxelize(batch)
        levels = td.trunk.first(feats, coords, B)[0]
        out2, props = td.apply_eval(batch)
        pred = td.predict(batch)
    return feats, coords, levels, out2, props, pred


def test_converter_maps_every_pvrcnn_leaf(tiny):
    """Every leaf of the TINY tree lands on a parameter or buffer of the
    same size, and every parameter and buffer is filled (load_state_dict
    strict in the fixture); the gradient tree maps to the parameters."""
    sd = jax_variables_to_torch(tiny['v'])
    trunk = tiny['td'].trunk.state_dict()
    assert set(sd) == set(trunk)
    leaves = sum(x.size for x in jax.tree_util.tree_leaves(tiny['v']))
    assert leaves == sum(t.numel() for k, t in sd.items()
                         if not k.endswith('num_batches_tracked'))
    names = {k for k, _ in tiny['td'].trunk.named_parameters()}
    assert set(jax_grads_to_torch(tiny['train']['grads'])) == names


@pytest.mark.parametrize('where', ['first/params', 'first/batch_stats',
                                   'second/params', 'second/batch_stats'])
def test_converter_raises_on_unknown_pvrcnn_leaf(tiny, where):
    v = copy.deepcopy(tiny['v'])
    stage, col = where.split('/')
    v[stage][col]['not_a_module'] = {'kernel': np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match='not_a_module'):
        jax_variables_to_torch(v)


def test_voxelize_and_levels_match_jax(tiny, port_eval):
    """Voxel feats (1e-5) and coords, then every level's sites, keys and
    overflow (TINY overflows at level 1: batch-major truncation)."""
    jfeats, jcoords, jlevels = tiny['eval'][:3]
    feats, coords, levels = port_eval[:3]
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    close(feats, jfeats, what='voxel feats')
    for t, (c, k, o) in zip(levels, jlevels):
        np.testing.assert_array_equal(t.coords.numpy(), np.asarray(c))
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(k))
        assert int(t.overflow) == int(o)
    assert int(levels[-1].overflow) > 0


def test_fps_and_ball_queries_match_jax(tiny, port_eval):
    """The keypoints (FPS over the raw points) and the ball queries of
    the raw-point SA and of level 0's SA (into the shared voxel table),
    every radius."""
    out2 = port_eval[3]
    jout2 = tiny['eval'][4]
    np.testing.assert_array_equal(out2['keypoints'].numpy(),
                                  np.asarray(jout2['keypoints']))
    batch, kp = tiny['batch'], out2['keypoints']
    idx = tvsa.furthest_point_sample(batch['points'][..., :3],
                                     TINY_PVRCNN['num_keypoints'],
                                     batch['points_mask'])
    np.testing.assert_array_equal(out2['keypoint_indices'].numpy(),
                                  idx.numpy())
    enc = tiny['td'].trunk.second.keypoints_encoder
    raw = TINY_PVRCNN['rawpoint_sa_config']
    jkp = jout2['keypoints']
    for r, k in zip(raw['pool_radius'], raw['samples']):
        want = jax.vmap(lambda s, q, m: jvsa.ball_query(r, k, s, q, m))(
            tiny['jb']['points'][..., :3], jkp, tiny['jb']['points_mask'])
        got = tvsa.ball_query(r, k, batch['points'][..., :3], kp,
                              batch['points_mask'])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jl0 = tiny['eval'][3]
    l0 = port_eval[2][0]
    cfg = TINY_PVRCNN['voxel_sa_configs'][0]
    centers = enc.voxel_centers(l0.coords[:, 1:4], cfg['scale_factor'])
    mask = l0.valid[None] & (l0.coords[None, :, 0] == torch.arange(B)[:, None])
    jmask = jl0.valid[None] & (jl0.coords[None, :, 0]
                               == jnp.arange(B)[:, None])
    jcenters = jme.VoxelSetAbstraction(
        voxel_size=TINY_PVRCNN['voxel_size'],
        point_cloud_range=PCR).voxel_centers(jl0.coords[:, 1:4],
                                             cfg['scale_factor'])
    valid = l0.valid.numpy()
    np.testing.assert_array_equal(centers.numpy()[valid],
                                  np.asarray(jcenters)[valid])
    for r, k in zip(cfg['pool_radius'], cfg['samples']):
        want = jax.vmap(lambda q, m: jvsa.ball_query(r, k, jcenters, q, m))(
            jkp, jmask)
        _, got = enc.voxel_sa_0.group(r, k, centers, l0.feats, kp, mask)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got[..., 0] >= 0).all()     # keypoints lie in voxels


def test_proposals_match_jax(tiny, port_eval):
    jb, jl, js, jv = tiny['eval'][5]
    boxes, labels, scores, valid = port_eval[4]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    close(boxes, jb, what='proposal boxes')
    close(scores, js, what='proposal scores')


def test_predict_matches_jax(tiny, port_eval):
    want, got = tiny['eval'][6], port_eval[5]
    close(got[0], want[0], what='boxes')
    close(got[1], want[1], what='scores')
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    close(port_eval[3]['roi_cls'], tiny['eval'][4]['roi_cls'], what='cls')
    close(port_eval[3]['roi_reg'], tiny['eval'][4]['roi_reg'], what='reg')


@pytest.fixture(scope='module')
def port_step(tiny):
    """The port's train step pieces on the JAX weights: loss terms,
    gradients, the new running statistics, the samples."""
    td = copy.deepcopy(tiny['td'])
    outs = td.apply_train(tiny['batch'])
    total, losses = td.loss(outs, tiny['batch'])
    params = dict(td.trunk.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return dict(total=float(total.detach()), losses=losses,
                grads={k: torch.zeros_like(p) if g is None else g
                       for (k, p), g in zip(params.items(), grads)},
                state=td.trunk.state_dict(), samples=outs[2],
                keypoints=outs[1]['keypoints'])


def test_train_step_losses_match_jax(tiny, port_step):
    want, got = tiny['train']['losses'], port_step['losses']
    assert set(got) == set(want) == {
        'rpn.loss_cls', 'rpn.loss_bbox', 'rpn.loss_dir', 'loss_semantic',
        'loss_roi_cls', 'loss_roi_bbox', 'loss_corner',
        'metric.sparse_overflow'}
    for k, w in want.items():
        assert np.isfinite(w), k
        assert w > 0, k
        np.testing.assert_allclose(float(got[k]), float(w), rtol=STEP_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(port_step['total'], tiny['train']['total'],
                               rtol=STEP_TOL)


def test_train_step_samples_match_jax(tiny, port_step):
    want, got = tiny['train']['samples'], port_step['samples']
    for f in ('roi_labels', 'is_pos', 'valid'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.is_pos.any()
    for f in ('rois', 'gt_of_roi', 'ious'):
        close(getattr(got, f), getattr(want, f), tol=STEP_TOL, what=f)
    np.testing.assert_array_equal(port_step['keypoints'].numpy(),
                                  tiny['train']['keypoints'])


def test_train_step_gradients_match_jax(tiny, port_step):
    want = jax_grads_to_torch(tiny['train']['grads'])
    got = port_step['grads']
    assert set(got) == set(want)
    nonzero = 0
    for k, w in want.items():
        w = w.numpy()
        scale = float(np.abs(w).max())
        nonzero += scale > 0
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)
    assert nonzero == len(want)


def test_train_step_running_stats_match_jax(tiny, port_step):
    """0.99 old + 0.01 batch, biased variance, masked statistics in the
    sparse encoder, VSA and RoI stage."""
    want = jax_variables_to_torch({
        s: {'params': tiny['v'][s]['params'],
            'batch_stats': tiny['train']['stats'][s]}
        for s in ('first', 'second')})
    keys = [k for k in want if 'running_' in k]
    # 15 BatchNorms in the first stage (9 sparse, 4 SECOND, 2 neck), 17 in
    # the second (7 VSA, 2 mask head, 2 grid pool, 6 box head)
    assert len(keys) == 2 * (15 + 17)
    for k in keys:
        close(port_step['state'][k], want[k], what=k)


def test_adamw_step_matches_optax(tiny):
    """One update of the port's AdamW (with the weight and bias warmup
    masks) on JAX's gradients of the TINY step against optax's, over the
    whole two-stage tree."""
    params = {s: tiny['v'][s]['params'] for s in ('first', 'second')}
    grads = tiny['train']['grads']
    kw = dict(warmup=dict(warmup_iters=3, lr_bias_warmup_ratio=10.0))
    oj = jts.make_optimizer(2e-3, 10, **kw)
    ot = tts.make_optimizer(2e-3, 10, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    uj, _ = jax.jit(oj.update)(jax.tree_util.tree_map(jnp.asarray, grads),
                               oj.init(pj), pj)
    pt = jax_grads_to_torch(params)
    ut, st = ot.update(jax_grads_to_torch(grads), ot.init(pt), pt)
    want = jax_grads_to_torch(np_tree(uj))
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(ut[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=k)
    assert st.count == 1
    assert any(bool(w.abs().max() > 0) for k, w in want.items()
               if tts.is_bias(k))


def test_train_step_runs_and_descends():
    """Three port steps on one batch through ``train_step``: finite terms,
    the overflow metric, the loss moves."""
    td = tdet_tiny()
    batch = tiny_batch(td, seed=1)
    state = td.init_train(1e-3, total_steps=100)
    losses = []
    for _ in range(3):
        state, metrics = td.train_step(batch, state)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        losses.append(float(metrics['loss']))
    assert float(metrics['metric.sparse_overflow']) > 0
    assert losses[-1] != losses[0] and state.step == 3


def test_dropout_only_with_a_generator(tiny):
    """The box head's dropout is off by default (as in every JAX caller)
    and draws from the caller's generator when given one."""
    head = tiny['td'].trunk.second.bbox_head
    x = torch.randn(2, 5, head.shared[0].linear.in_features)
    head.eval()
    a = head(x)[0]
    assert torch.equal(a, head(x)[0])
    b = head(x, generator=torch.Generator().manual_seed(0))[0]
    c = head(x, generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(b, c) and not torch.equal(a, b)


def test_pvrcnn_refuses_bf16_and_axis_name():
    """bf16 raises; ``axis_name`` (the JAX modules' cross-replica
    BatchNorm) is accepted and changes nothing, as PointPillarsNet takes
    it: a data-parallel step syncs every BatchNorm through its group."""
    with pytest.raises(ValueError, match='f32 only'):
        TDet(dict(TINY_PVRCNN, compute_dtype='bfloat16'), TINY_RPN,
             device='cpu')
    a = TDet(dict(TINY_PVRCNN, axis_name='batch'), TINY_RPN, device='cpu')
    b = TDet(TINY_PVRCNN, TINY_RPN, device='cpu')
    assert 'axis_name' not in a.cfg
    sa, sb = a.trunk.state_dict(), b.trunk.state_dict()
    assert set(sa) == set(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
