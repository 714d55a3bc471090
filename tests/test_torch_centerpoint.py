"""The port's CenterPoint against the JAX package's, on the CPU.

At ``tests/test_centerpoint.py``'s TINY shape (``TINY_CP_MODEL``: dynamic
pillars on the s2d canvas, a neck at strides (0.5, 1, 2); ``TINY_CP_HEAD``:
two tasks of 2 and 1 classes), inputs from a seed with numpy and JAX's
weights carried over by ``weights.jax_variables_to_torch``: the coders,
``gaussian_radius``, ``splat_heatmap`` and ``circle_nms`` (keep masks
equal); SECONDFPN at strides (0.5, 1, 2); the forward maps of both heads
(CenterHead and CenterGDHead); the targets (integers equal); every loss
term and every parameter's gradient with ``yaw_mode`` off and on and
velocity off and on; the predict (rotated and circle NMS), also of a
six-task head in the nuScenes layout, and its decode on planted ties,
bitwise equal to the per-task decode it replaced and one batched pass
(as many operators for two tasks as for six).  Losses within
rtol 1e-5, gradients within 1e-4 of each tensor's largest value (and
1e-7), boxes within 1e-5 of their scale; integer outputs equal.  The TINY
bf16 predict is held as ``tests/test_torch_bf16.py`` holds the anchor
head's, to JAX numbers made with XLA's excess precision off.
"""
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX modules)
from mmdet3d_gaussian_tpu.core.bbox import coders as jcoders
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.models.backbones import SECONDFPN as JSECONDFPN
from mmdet3d_gaussian_tpu.ops import heatmap as jheat
from mmdet3d_gaussian_tpu.ops import nms as jnms

from mmdet3d_gaussian_tpu_torch.core.bbox import coders as tcoders
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models.backbones import SECONDFPN
from mmdet3d_gaussian_tpu_torch.ops import heatmap as theat
from mmdet3d_gaussian_tpu_torch.ops import nms as tnms
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from tests.test_centerpoint import TINY_CP_HEAD, TINY_CP_MODEL

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STRIDES = TINY_CP_MODEL['neck_cfg']['upsample_strides']
PCR = TINY_CP_MODEL['point_cloud_range']
GD = dict(type='GDLoss', loss_type='gwd3d', fun='log1p', tau=1.0,
          loss_weight=5.0)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
BOX_TOL = 1e-5


def head_cfg(yaw_mode=False, with_vel=False, **test_cfg):
    hc = copy.deepcopy(TINY_CP_HEAD)
    hc.update(with_vel=with_vel)
    if yaw_mode:
        hc.update(yaw_mode=True, loss_gd=GD)
    hc['test_cfg'].update(test_cfg)
    return hc


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize(tree, rng):
    """Redraw BN statistics, scales and biases (so a swapped mean / var or
    scale / bias, or a bias left at its init, cannot pass)."""
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


def batch_np(with_vel, seed=0, b=2, n=1024, g=8):
    """The JAX ``synthetic_batch`` (4 channels), with velocities appended
    to the boxes when ``with_vel``."""
    batch = {k: np.array(v) for k, v in jdet.synthetic_batch(
        batch_size=b, num_points=n, num_gt=g, pc_range=PCR,
        seed=seed).items()}
    if with_vel:
        vel = np.random.RandomState(seed + 100).uniform(
            -3, 3, (b, g, 2)).astype(np.float32)
        batch['gt_bboxes'] = np.concatenate([batch['gt_bboxes'], vel], -1)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, tol=BOX_TOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize('yaw', [False, True])
@pytest.mark.parametrize('with_vel', [False, True])
def test_coders(yaw, with_vel):
    kw = dict(pc_range=(-51.2, -51.2, -5, 51.2, 51.2, 3),
              voxel_size=(0.2, 0.2, 8), out_size_factor=4,
              code_size=(9 if yaw else 8) + 2 * with_vel)
    cls = 'CenterPointBBoxYawCoder' if yaw else 'CenterPointBBoxCoder'
    jc, tc = getattr(jcoders, cls)(**kw), getattr(tcoders, cls)(**kw)
    rng = np.random.RandomState(1)
    n = 64
    boxes = np.c_[rng.uniform(-50, 50, (n, 2)), rng.uniform(-3, 1, (n, 1)),
                  rng.uniform(0.3, 12, (n, 3)),
                  rng.uniform(-np.pi, np.pi, (n, 1))].astype(np.float32)
    if with_vel:
        boxes = np.c_[boxes, rng.uniform(-10, 10, (n, 2))].astype(np.float32)
    jix, jiy, jcode = jc.encode(jnp.asarray(boxes))
    tix, tiy, tcode = tc.encode(torch.from_numpy(boxes))
    np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(tiy.numpy(), np.asarray(jiy))
    assert tix.dtype == torch.int32
    close(tcode, jcode, 1e-6, 'encode')
    # decode regressed codes (noise on every channel; the direction branch
    # off the yaw, so that the snap turns boxes by quarter-turns)
    codes = np.asarray(jcode) + rng.normal(0, 0.3, jcode.shape).astype(
        np.float32)
    for kwargs in ([dict(correct_yaw=False), dict(correct_yaw=True)]
                   if yaw else [dict()]):
        want = jc.decode_cells(jnp.asarray(codes), jix, jiy, **kwargs)
        got = tc.decode_cells(torch.from_numpy(codes), tix, tiy, **kwargs)
        close(got, want, 1e-6, f'decode {kwargs}')
    if yaw:
        snapped = tc.decode_cells(torch.from_numpy(codes), tix, tiy)
        assert not torch.allclose(snapped[:, 6], torch.from_numpy(
            codes[:, 6])), 'no box was snapped'


def test_gaussian_radius():
    """Within f32 rounding of the inputs' scale: the third root subtracts
    ~(h + w) from a square root of the same size."""
    rng = np.random.RandomState(2)
    h, w = rng.uniform(0.1, 40, (2, 256)).astype(np.float32)
    for overlap in (0.1, 0.5, 0.7):
        want = jheat.gaussian_radius((jnp.asarray(h), jnp.asarray(w)),
                                     overlap)
        got = theat.gaussian_radius((torch.from_numpy(h),
                                     torch.from_numpy(w)), overlap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float((h + w).max()))


def test_splat_heatmap():
    """The batched splat (B, K, C, H, W max) against JAX's per sample:
    overlapping Gaussians, objects at the border and off the map, invalid
    objects, radii from 1 to 6."""
    rng = np.random.RandomState(3)
    b, k, c, h, w = 3, 12, 3, 24, 20
    centers = np.c_[rng.randint(-2, w + 2, (b * k, 1)),
                    rng.randint(-2, h + 2, (b * k, 1))].reshape(b, k, 2)
    centers = centers.astype(np.int32)
    radius = rng.uniform(1, 6, (b, k)).astype(np.float32)
    cls = rng.randint(0, c, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.2
    got = theat.splat_heatmap(torch.from_numpy(centers),
                              torch.from_numpy(radius),
                              torch.from_numpy(cls), torch.from_numpy(valid),
                              c, h, w)
    assert got.shape == (b, c, h, w)
    for i in range(b):
        want = jheat.splat_heatmap(centers[i], radius[i], cls[i], valid[i],
                                   c, h, w)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
    assert float(got.max()) == 1.0


@pytest.mark.parametrize('min_radius', [0.175, 1.0, 4.0, 12.0])
def test_circle_nms(min_radius):
    """Keep masks equal to JAX's on P problems of clustered centres sorted
    by score, with invalid candidates; the threshold is the squared
    distance (the reference's quirk)."""
    rng = np.random.RandomState(4)
    p, k = 5, 96
    centers = (rng.randint(0, 6, (p, k, 2)) * 1.5
               + rng.normal(0, 0.6, (p, k, 2))).astype(np.float32)
    valid = rng.rand(p, k) > 0.1
    got = tnms.circle_nms(torch.from_numpy(centers), min_radius,
                          torch.from_numpy(valid))
    for i in range(p):
        want = jnms.circle_nms(jnp.asarray(centers[i]),
                               jnp.arange(k, 0, -1.0), min_radius,
                               valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize('train', [False, True])
def test_secondfpn_fractional_stride(train):
    """SECONDFPN at strides (0.5, 1, 2): the stride-0.5 level is a 2 x 2
    conv at stride 2 (not a transposed conv), placed by the converter from
    the strides; train mode through the port's BatchNorm (K4's plain
    version) and its running statistics."""
    rng = np.random.RandomState(5)
    cin, cout = (6, 10, 12), (8, 8, 8)
    feats = [rng.normal(0, 1, (2, 16 // 2 ** i, 12 // 2 ** i, c)).astype(
        np.float32) for i, c in enumerate(cin)]
    jneck = JSECONDFPN(in_channels=cin, out_channels=cout,
                       upsample_strides=STRIDES)
    variables = jneck.init(jax.random.PRNGKey(0), feats)
    variables = randomize(np_tree(variables), rng)
    if train:
        want, upd = jneck.apply(variables, feats, train=True,
                                mutable=['batch_stats'])
    else:
        want = jneck.apply(variables, feats)
    sd = jax_variables_to_torch({'params': {'neck': variables['params']},
                                 'batch_stats': {'neck': variables[
                                     'batch_stats']}}, STRIDES)
    neck = SECONDFPN(cin, cout, STRIDES)
    neck.load_state_dict({k[5:]: v for k, v in sd.items()}, strict=True)
    assert tuple(neck.deblocks[0][0].weight.shape) == (8, 6, 2, 2)
    neck.train(train)
    got = neck([torch.from_numpy(f) for f in feats])
    close(got.detach(), want, 1e-5, 'neck output')
    if train:
        new = jax_variables_to_torch(
            {'params': {'neck': variables['params']},
             'batch_stats': {'neck': np_tree(upd['batch_stats'])}}, STRIDES)
        for k, v in neck.state_dict().items():
            if 'running_' in k:
                close(v, new['neck.' + k], 1e-5, k)
    # without the strides the stride-0.5 kernel would load flipped as a
    # transposed conv: a center-head tree refuses that
    with pytest.raises(ValueError, match='upsample_strides'):
        jax_variables_to_torch({'params': {'bbox_head': {'shared_conv': {}}},
                                'batch_stats': {}})


# ------------------------------------------------------ model and steps
@pytest.fixture(scope='module')
def init_variables():
    """JAX's TINY CenterPoint variables of each head (the trees depend on
    the branches), BN statistics, scales and biases redrawn."""
    out = {}
    for yaw in (False, True):
        for vel in (False, True):
            jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL,
                                          head_cfg=head_cfg(yaw, vel))
            batch = batch_np(vel)
            v = jax.jit(jd.init)(jax.random.PRNGKey(0), batch)
            out[yaw, vel] = randomize(np_tree(v), np.random.RandomState(6))
    return out


def pair(yaw, vel, variables, **test_cfg):
    hc = head_cfg(yaw, vel, **test_cfg)
    jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL, head_cfg=hc)
    td = tdet.CenterPointDetector(TINY_CP_MODEL, hc, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables, STRIDES),
                             strict=True)
    return jd, td


def test_converter_places_every_leaf(init_variables):
    """Every JAX leaf of both heads has a port tensor of its size, and the
    port has no tensor the tree does not fill (besides BN counters)."""
    for (yaw, vel), variables in init_variables.items():
        sd = jax_variables_to_torch(variables, STRIDES)
        td = tdet.CenterPointDetector(TINY_CP_MODEL, head_cfg(yaw, vel),
                                      device='cpu')
        mine = td.trunk.state_dict()
        assert set(sd) == set(mine), set(sd) ^ set(mine)
        for k, v in sd.items():
            assert v.shape == mine[k].shape, k
        n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(
            variables))
        n_port = sum(v.numel() for k, v in sd.items()
                     if not k.endswith('num_batches_tracked'))
        assert n_jax == n_port
        # 1 shared conv + (6 or 7 branches) x 2 convs a task, 2 tasks
        n_heads = len(td.head.common_heads) + 1
        convs = [k for k in sd if k.startswith('bbox_head')
                 and k.endswith('weight') and sd[k].dim() == 4]
        assert len(convs) == 1 + 2 * 2 * n_heads


@pytest.mark.parametrize('yaw', [False, True])
def test_forward_maps(yaw, init_variables):
    """Eval and train-mode maps of every branch of both tasks."""
    variables = init_variables[yaw, False]
    jd, td = pair(yaw, False, variables)
    batch = batch_np(False)
    want = jd.apply_eval(variables, batch)
    got = td.apply_eval(to_torch(batch))
    want_tr, _ = jd.apply_train(variables, batch)
    got_tr = td.apply_train(to_torch(batch))
    for mode, g_all, w_all in (('eval', got, want),
                               ('train', got_tr, want_tr)):
        assert len(g_all) == len(w_all) == 2
        for t, (g, w) in enumerate(zip(g_all, w_all)):
            assert set(g) == set(w) == set(td.head.common_heads) | {
                'heatmap'}
            for name in w:
                close(g[name].detach(), w[name], 1e-5,
                      f'{mode} task{t} {name}')


@pytest.mark.parametrize('train', [False, True])
def test_ds_conv_head(train):
    """The head with depthwise-separable tower convs (``use_ds_conv``,
    JAX's ``ConvDS``: a depthwise conv and a 1x1 conv with bias), alone on
    a random NHWC map, in eval and training mode."""
    from mmdet3d_gaussian_tpu.models.dense_heads.centerpoint_head import \
        CenterHeadConvs as JHead
    from mmdet3d_gaussian_tpu_torch.models.dense_heads.centerpoint_head \
        import CenterHeadConvs
    kw = dict(tasks=TINY_CP_HEAD['tasks'], in_channels=24,
              share_conv_channel=16, head_conv=8, use_ds_conv=True,
              common_heads=dict(reg=(2, 2), dim=(3, 3)))
    x = np.random.RandomState(9).normal(0, 1, (2, 8, 6, 24)).astype(
        np.float32)
    jhead = JHead(**kw)
    variables = randomize(np_tree(jhead.init(jax.random.PRNGKey(0), x)),
                          np.random.RandomState(10))
    if train:
        want, _ = jhead.apply(variables, x, train=True,
                              mutable=['batch_stats'])
    else:
        want = jhead.apply(variables, x)
    sd = jax_variables_to_torch(
        {'params': {'bbox_head': variables['params']},
         'batch_stats': {'bbox_head': variables['batch_stats']}}, STRIDES)
    assert 'bbox_head.task_heads.0.dim.1.conv.chn_conv.weight' in sd
    head = CenterHeadConvs(**kw)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    head.train(train)
    got = head(torch.from_numpy(x))
    for t, (g, w) in enumerate(zip(got, want)):
        for name in w:
            close(g[name].detach(), w[name], 1e-5, f'task{t} {name}')


@pytest.mark.parametrize('yaw', [False, True])
@pytest.mark.parametrize('with_vel', [False, True])
def test_targets(yaw, with_vel, init_variables):
    jd, td = pair(yaw, with_vel, init_variables[yaw, with_vel])
    batch = batch_np(with_vel, seed=3)
    # two objects in one cell and one off the map
    batch['gt_bboxes'][0, 1, :2] = batch['gt_bboxes'][0, 0, :2] + 0.05
    batch['gt_bboxes'][1, 2, 0] = 40.0
    want = jax.vmap(jd.head.get_targets_single, in_axes=(0, 0, 0, None))(
        jnp.asarray(batch['gt_bboxes']), jnp.asarray(batch['gt_labels']),
        jnp.asarray(batch['gt_valid']), jd.featmap_size)
    got = td.head.get_targets(torch.from_numpy(batch['gt_bboxes']),
                              torch.from_numpy(batch['gt_labels']),
                              torch.from_numpy(batch['gt_valid']),
                              td.featmap_size)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g['heatmap'].numpy(),
                                   np.asarray(w['heatmap']), rtol=1e-6,
                                   atol=0, err_msg=f'task{t} heatmap')
        assert int((g['heatmap'] == 1).sum()) == int(
            (np.asarray(w['heatmap']) == 1).sum()) > 0
        np.testing.assert_array_equal(g['inds'].numpy(),
                                      np.asarray(w['inds']))
        np.testing.assert_array_equal(g['mask'].numpy(),
                                      np.asarray(w['mask']))
        close(g['anno'], w['anno'], 1e-6, f'task{t} anno')
    assert not bool(got[0]['mask'][1].all())


@pytest.fixture(scope='module', params=[(False, False), (False, True),
                                        (True, False), (True, True)],
                ids=['rot', 'rot-vel', 'yaw', 'yaw-vel'])
def step_pair(request, init_variables):
    """One train step's loss terms, gradients and new running statistics
    from both packages on the same weights and batch."""
    yaw, vel = request.param
    variables = init_variables[yaw, vel]
    jd, td = pair(yaw, vel, variables)
    batch = batch_np(vel, seed=1)

    def f(params):
        preds, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch)
        total, losses = jd.loss(preds, batch)
        return total, (losses, stats)

    (total, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    want = dict(total=float(total),
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_to_torch(np_tree(grads), STRIDES),
                state=jax_variables_to_torch(
                    {'params': variables['params'],
                     'batch_stats': np_tree(stats)}, STRIDES))
    tb = to_torch(batch)
    total_t, losses_t = td.loss(td.apply_train(tb), tb)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(total=float(total_t.detach()),
               losses={k: float(v.detach()) for k, v in losses_t.items()},
               grads=dict(zip(params, grads_t)),
               state=td.trunk.state_dict())
    return yaw, want, got


def test_step_losses(step_pair):
    yaw, want, got = step_pair
    kinds = ('loss_heatmap', 'loss_gd', 'loss_l1') if yaw else (
        'loss_heatmap', 'loss_bbox')
    assert set(got['losses']) == set(want['losses']) == {
        f'task{t}.{k}' for t in range(2) for k in kinds}
    for k, v in want['losses'].items():
        assert v > 0, k
        np.testing.assert_allclose(got['losses'][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got['total'], want['total'], rtol=LOSS_RTOL)


def test_step_gradients(step_pair):
    _, want, got = step_pair
    assert set(got['grads']) == set(want['grads'])
    for k, w in want['grads'].items():
        w = w.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got['grads'][k].numpy(), w, rtol=0,
                                   atol=max(GRAD_RTOL * scale, GRAD_ATOL),
                                   err_msg=k)


def test_step_running_stats(step_pair):
    _, want, got = step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    assert keys
    for k in keys:
        close(got['state'][k], want['state'][k], 1e-5, k)


@pytest.mark.parametrize('case', ['rot', 'yaw', 'circle'])
def test_predict(case, init_variables):
    """Boxes, scores, labels and valid of the eval predict, with the
    heatmap output conv scaled so that the scores spread around the
    threshold: some candidates clear it and some do not, of every class
    (suppressed and dropped candidates score -1)."""
    yaw = case == 'yaw'
    # every candidate of both tasks in the output, the suppressed too
    test_cfg = dict(post_max_size=64)
    if case == 'circle':
        test_cfg.update(nms_type='circle', min_radius=[1.0, 4.0])
    variables = copy.deepcopy(init_variables[yaw, False])
    batch = batch_np(False, seed=2)
    heads = variables['params']['bbox_head']
    for task in ('task0', 'task1'):
        heads[task]['heatmap_out']['kernel'] *= 4
        heads[task]['heatmap_out']['bias'][:] = 0
    jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL,
                                  head_cfg=head_cfg(yaw, False))
    for t, maps in enumerate(jd.apply_eval(variables, batch)):
        # each class's median logit onto the score threshold's (0.05)
        logits = np.asarray(maps['heatmap'])
        med = np.median(logits.reshape(-1, logits.shape[-1]), axis=0)
        heads[f'task{t}']['heatmap_out']['bias'][:] = (
            -med + np.log(0.05 / 0.95))
    jd, td = pair(yaw, False, variables, **test_cfg)
    want = [np.asarray(x) for x in jax.jit(jd.predict)(variables, batch)]
    got = [x.numpy() for x in td.predict(to_torch(batch))]
    boxes, scores, labels, valid = got
    assert boxes.shape == want[0].shape == (2, 64, 7)
    close(scores, want[1], 1e-6, 'scores')
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_array_equal(valid, want[3])
    assert labels.dtype == np.int32 and valid.any() and not valid.all()
    assert set(labels[valid].tolist()) == {0, 1, 2}
    assert (scores == -1).any()
    close(boxes, want[0], BOX_TOL, 'boxes')


@pytest.mark.parametrize('yaw', [False, True])
def test_code_weights_must_match_code(yaw):
    """A ``code_weights`` list of another length than the box code (the
    gwd5 config's has 12 entries for an 11-channel code) fails the loss in
    both packages; the port names the mismatch."""
    hc = head_cfg(yaw, True)
    hc['code_weights'] = [1.0] * 7 + [1.0, 1.0, 1.0, 0.2, 0.2]
    if not yaw:
        hc['code_weights'] = hc['code_weights'][1:]
    jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL, head_cfg=hc)
    batch = batch_np(True)
    variables = jd.init(jax.random.PRNGKey(0), batch)
    preds, _ = jd.apply_train(variables, batch)
    with pytest.raises(TypeError, match='broadcast'):
        jd.loss(preds, batch)
    td = tdet.CenterPointDetector(TINY_CP_MODEL, hc, device='cpu')
    with pytest.raises(ValueError, match='code_weights has'):
        td.loss(td.apply_train(to_torch(batch)), to_torch(batch))


# ------------------------------------------------------------------ bf16
MAP_TOL = 2e-2      # of each map's largest magnitude (bf16, 8 bits)


@pytest.fixture(scope='module')
def bf16_ref(tmp_path_factory):
    """JAX's bf16 and f32 maps and bf16 detections of both heads, from
    ``tests/torch_bf16_reference.py center`` run in its own process with
    XLA's excess precision off (as ``tests/test_torch_bf16.py`` holds the
    anchor head)."""
    out = tmp_path_factory.mktemp('cp_bf16') / 'ref.npz'
    proc = subprocess.run(
        [sys.executable, '-m', 'tests.torch_bf16_reference', str(out),
         'center'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        arrays = dict(f)

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items()
                if k.startswith(prefix + '/')}
    return group


@pytest.mark.parametrize('yaw', [False, True])
def test_bf16_predict(yaw, bf16_ref):
    """The TINY bf16 predict: every branch map in bf16, within 2e-2 of its
    largest magnitude of JAX bf16, and on the mean nearer to it than half
    of JAX bf16's own mean distance from JAX f32 (a missing or misplaced
    cast moves the port about that whole distance; the mean, since one
    value whose f32 sum crosses a rounding boundary moves by a bf16 step,
    as far as the largest gap on a small map); the decode on JAX's bf16
    maps equals JAX's detections."""
    pre = 'yaw' if yaw else 'rot'
    hc = head_cfg(yaw)
    det = tdet.CenterPointDetector(dict(TINY_CP_MODEL,
                                        compute_dtype='bfloat16'), hc,
                                   device='cpu')
    det.trunk.load_state_dict({k: torch.from_numpy(v) for k, v in
                               bf16_ref(f'{pre}_sd').items()}, strict=True)
    got = det.apply_eval(to_torch(batch_np(False, seed=2)))
    m16, m32 = bf16_ref(f'{pre}_maps16'), bf16_ref(f'{pre}_maps32')
    for t, task in enumerate(got):
        for branch, g in task.items():
            key = f'{t}.{branch}'
            assert g.dtype == torch.bfloat16, key
            assert str(m16[key + '.dtype']) == 'bfloat16'
            g = g.float().numpy()
            scale = float(np.abs(m16[key]).max())
            err = float(np.abs(g - m16[key]).max()) / scale
            mean_err = float(np.abs(g - m16[key]).mean())
            mean_gap = float(np.abs(m32[key] - m16[key]).mean())
            print(f'{pre} {key}: port vs JAX bf16 {err:.3g} of the largest '
                  f'magnitude, mean {mean_err:.3g}; JAX bf16 vs f32 mean '
                  f'{mean_gap:.3g}')
            assert err <= MAP_TOL, key
            assert mean_err < 0.5 * mean_gap, key
    maps = [{branch: torch.from_numpy(m16[f'{t}.{branch}']).to(
        torch.bfloat16) for branch in task} for t, task in enumerate(got)]
    dets = [x.numpy() for x in det.head.get_bboxes(maps)]
    want = [bf16_ref(f'{pre}_dets16')[str(i)] for i in range(4)]
    assert want[3].sum() >= 5
    np.testing.assert_array_equal(dets[3], want[3])
    np.testing.assert_array_equal(dets[2], want[2])
    close(dets[1], want[1], 1e-6, 'scores')
    close(dets[0], want[0], BOX_TOL, 'boxes')


# ------------------------------------------------------ the batched decode
NUS_TASKS = (1, 2, 2, 1, 2, 2)      # nuScenes' six tasks' class counts
POST_RANGE = [-12.0, -12.2, -4.0, 11.8, 12.4, 2.0]
RADII = [1.0, 4.0, 4.0, 1.0, 2.0, 4.0]


def per_task_get_bboxes(head, preds):
    """The port's decode as it ran before the batched pass, one task at a
    time: the oracle the batched decode is held to bitwise."""
    cfg = head.test_cfg
    k = int(cfg.get('max_per_img', 128))
    score_thr = float(cfg.get('score_threshold', 0.1))
    post_range = cfg.get('post_center_limit_range')
    boxes_t, scores_t, labels_t, valid_t = [], [], [], []
    flag = 0
    for t, pred in enumerate(preds):
        heat = torch.sigmoid(pred['heatmap'].float())
        b, h, w, c = heat.shape
        code = head._reconstruct(pred)
        flat = heat.reshape(b, h * w, c).transpose(1, 2)
        top_s, top_i = tnms.top_k(flat, k)
        scores, i2 = tnms.top_k(top_s.reshape(b, -1), k)
        cls = (i2 // k).to(torch.int32)
        cell = torch.gather(top_i.reshape(b, -1), 1, i2)
        codes = torch.gather(code.reshape(b, h * w, -1), 1,
                             cell[..., None].expand(-1, -1, code.shape[-1]))
        boxes = head.coder.decode_cells(codes, cell % w, cell // w)
        valid = scores >= score_thr
        if post_range is not None:
            pr = torch.tensor(post_range, dtype=torch.float32)
            valid &= (boxes[..., :3] >= pr[:3]).all(-1)
            valid &= (boxes[..., :3] <= pr[3:6]).all(-1)
        order = torch.argsort(-torch.where(valid, scores, -torch.inf),
                              dim=-1, stable=True)
        boxes_t.append(torch.gather(
            boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1])))
        scores_t.append(torch.gather(scores, 1, order))
        labels_t.append(torch.gather(cls, 1, order) + flag)
        valid_t.append(torch.gather(valid, 1, order))
        flag += head.tasks[t]['num_classes']
    boxes = torch.stack(boxes_t, 1)
    scores = torch.stack(scores_t, 1)
    valid = torch.stack(valid_t, 1)
    b, n_task = scores.shape[:2]
    if cfg.get('nms_type', 'rotate') == 'circle':
        mr = cfg.get('min_radius_task', cfg.get('min_radius', 4.0))
        radii = (list(mr) if isinstance(mr, (list, tuple))
                 else [mr] * n_task)
        keep = torch.zeros_like(valid)
        for r in sorted(set(float(v) for v in radii)):
            ts = [t for t in range(n_task) if float(radii[t]) == r]
            keep[:, ts] = tnms.circle_nms(
                boxes[:, ts, :, :2].reshape(-1, k, 2), r,
                valid[:, ts].reshape(-1, k)).reshape(b, len(ts), k)
    else:
        bev = boxes[..., [0, 1, 3, 4, 6]].reshape(b * n_task, k, 5)
        keep = tnms.nms_bev(bev, float(cfg.get('nms_thr', 0.2)),
                            valid.reshape(b * n_task, k)).reshape(
                                b, n_task, k)
    kept = torch.where(keep, scores, -1.0).reshape(b, n_task * k)
    final, idx = tnms.top_k(kept, min(int(cfg.get('post_max_size', 83)),
                                      n_task * k))
    boxes = torch.gather(boxes.reshape(b, n_task * k, -1), 1,
                         idx[..., None].expand(-1, -1, boxes.shape[-1]))
    labels = torch.gather(torch.stack(labels_t, 1).reshape(b, -1), 1, idx)
    return boxes, final, labels, final > score_thr


def assert_bitwise(got, want):
    for name, g, w in zip(('boxes', 'scores', 'labels', 'valid'), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def six_task_cfg(case, tasks=NUS_TASKS, radii=RADII):
    """The TINY head in the nuScenes layout (velocity on), every candidate
    in the output, centres limited to a range that cuts some; circle NMS
    with a radius a task."""
    test_cfg = dict(post_max_size=len(tasks) * 32,
                    post_center_limit_range=POST_RANGE)
    if case == 'circle':
        test_cfg.update(nms_type='circle', min_radius=list(radii))
    hc = head_cfg(case == 'yaw', True, **test_cfg)
    hc['tasks'] = [dict(num_classes=n) for n in tasks]
    return hc


@pytest.fixture(scope='module')
def six_task():
    """JAX's TINY CenterPoint variables with six tasks, BN and biases
    redrawn, each task's heatmap output conv scaled and its bias set so
    that every class's median score sits on the threshold (0.05); per
    head (rot, yaw)."""
    batch = batch_np(True, seed=2)
    out = {}
    for yaw in (False, True):
        jd = jdet.CenterPointDetector(
            model_cfg=TINY_CP_MODEL,
            head_cfg=six_task_cfg('yaw' if yaw else 'rot'))
        variables = copy.deepcopy(randomize(np_tree(jax.jit(jd.init)(
            jax.random.PRNGKey(1), batch)), np.random.RandomState(7)))
        heads = variables['params']['bbox_head']
        for t in range(len(NUS_TASKS)):
            heads[f'task{t}']['heatmap_out']['kernel'] *= 4
            heads[f'task{t}']['heatmap_out']['bias'][:] = 0
        for t, maps in enumerate(jd.apply_eval(variables, batch)):
            logits = np.asarray(maps['heatmap'])
            med = np.median(logits.reshape(-1, logits.shape[-1]), axis=0)
            heads[f'task{t}']['heatmap_out']['bias'][:] = (
                -med + np.log(0.05 / 0.95))
        out[yaw] = variables
    return batch, out


@pytest.mark.parametrize('case', ['rot', 'yaw', 'circle'])
def test_six_task_predict(case, six_task):
    """The predict of a six-task head (classes 1, 2, 2, 1, 2, 2, as
    nuScenes') against JAX's, scores straddling the threshold and centres
    the range: labels and valid equal, scores and boxes within the
    tolerances of :func:`test_predict`; the decode on the port's own maps
    bitwise equal to the per-task decode."""
    batch, variables = six_task
    variables = variables[case == 'yaw']
    hc = six_task_cfg(case)
    jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL, head_cfg=hc)
    td = tdet.CenterPointDetector(TINY_CP_MODEL, hc, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables, STRIDES),
                             strict=True)
    want = [np.asarray(x) for x in jax.jit(jd.predict)(variables, batch)]
    got = [x.numpy() for x in td.predict(to_torch(batch))]
    boxes, scores, labels, valid = got
    assert boxes.shape == want[0].shape == (2, 192, 9)
    close(scores, want[1], 1e-6, 'scores')
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_array_equal(valid, want[3])
    assert valid.any() and not valid.all()
    # a detection of every task
    task_of = np.searchsorted(np.cumsum(NUS_TASKS), labels[valid], 'right')
    assert set(task_of.tolist()) == set(range(len(NUS_TASKS)))
    close(boxes, want[0], BOX_TOL, 'boxes')
    with torch.inference_mode():
        maps = td.apply_eval(to_torch(batch))
        assert_bitwise(td.head.get_bboxes(maps),
                       per_task_get_bboxes(td.head, maps))
        # the centre range drops candidates that clear the threshold
        wide = copy.copy(td.head)
        wide.test_cfg = dict(td.head.test_cfg, post_center_limit_range=None)
        assert (wide.get_bboxes(maps)[3].sum()
                > td.head.get_bboxes(maps)[3].sum())


def plant_ties(maps, k=32):
    """Exact ties in every task's heatmap: the first k + 8 cells of every
    class at one logit above the threshold (more tied cells than a class
    keeps, and the same score in both classes of a two-class task), and
    the scores of task 3 (one class, padded) all exactly 0 (a logit of
    -200), so that its top k are zeros beside the padded class."""
    out = []
    for t, task in enumerate(maps):
        task = {n: np.array(v) for n, v in task.items()}
        heat = task['heatmap']
        b, h, w, c = heat.shape
        heat.reshape(b, h * w, c)[:, :k + 8] = 1.25
        if t == 3:
            heat[...] = -200.0
        out.append(task)
    return out


@pytest.mark.parametrize('case', ['rot', 'yaw', 'circle'])
def test_six_task_decode_ties(case, six_task):
    """``get_bboxes`` on JAX's six-task maps with planted ties equals
    JAX's decode (the lower index wins a tie, across the classes and past
    the padded class of a one-class task) and, bitwise, the per-task
    decode."""
    batch, variables = six_task
    variables = variables[case == 'yaw']
    hc = six_task_cfg(case)
    jd = jdet.CenterPointDetector(model_cfg=TINY_CP_MODEL, head_cfg=hc)
    maps = plant_ties(np_tree(jd.apply_eval(variables, batch)))
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        jd.head.get_bboxes_single))(maps)]
    head = tdet.CenterPointDetector(TINY_CP_MODEL, hc, device='cpu').head
    tmaps = [{n: torch.from_numpy(v) for n, v in task.items()}
             for task in maps]
    got = head.get_bboxes(tmaps)
    assert_bitwise(got, per_task_get_bboxes(head, tmaps))
    boxes, scores, labels, valid = [x.numpy() for x in got]
    close(scores, want[1], 1e-6, 'scores')
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_array_equal(valid, want[3])
    close(boxes, want[0], BOX_TOL, 'boxes')
    # task 3 (class 5) keeps k zero scores, none from the padded class
    assert (labels == 5).sum() == 2 * 32 and not valid[labels == 5].any()
    top_scores, top_labels = head.select_best(tmaps, 32)[:2]
    assert (top_scores[:, 3] == 0).all() and (top_labels[:, 3] == 5).all()


def random_maps(tasks, yaw, b=2, hw=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    branches = dict(reg=2, height=1, dim=3, vel=2,
                    **(dict(yaw=1, dir=2) if yaw else dict(rot=2)))
    maps = []
    for n in tasks:
        task = {name: torch.randn(b, hw, hw, c, generator=g)
                for name, c in branches.items()}
        task['heatmap'] = torch.randn(b, hw, hw, n, generator=g) * 2 - 3
        maps.append({name: v.to(dtype) for name, v in task.items()})
    return maps


def aten_ops(fn):
    """-> the number of aten operators that compute (views apart) run
    under the profiler by ``fn()``."""
    def view(name):
        ops = getattr(torch.ops.aten, name[len('aten::'):], None)
        return ops is not None and any(getattr(ops, o).is_view
                                       for o in ops.overloads())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events()
               if e.name.startswith('aten::') and not view(e.name))


@pytest.mark.parametrize('case', ['rot', 'yaw', 'circle'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_decode_is_one_batched_pass(case, dtype, monkeypatch):
    """One ``get_bboxes`` call runs as many aten operators for a two-task
    head (classes 1, 2) as for the six-task head of the same maps (circle
    NMS: radii 1, 4 and 1, 4, 4, 1, 4, 1, one sweep a distinct radius),
    where the per-task decode runs more; the call builds no tensor from Python
    data (``torch.tensor``, ``as_tensor`` and ``new_tensor`` raise inside
    it), so no host-to-device copy is made on the card; its detections
    equal the per-task decode's bitwise (bf16 maps too)."""
    maps = random_maps(NUS_TASKS, case == 'yaw', dtype=dtype)
    radii = [1.0, 4.0, 4.0, 1.0, 4.0, 1.0]
    heads = {n: tdet.CenterPointDetector(
        TINY_CP_MODEL, six_task_cfg(case, NUS_TASKS[:n], radii[:n]),
        device='cpu').head for n in (2, 6)}
    want = {n: per_task_get_bboxes(heads[n], maps[:n]) for n in (2, 6)}
    old = {n: aten_ops(lambda: per_task_get_bboxes(heads[n], maps[:n]))
           for n in (2, 6)}

    def refuse(*args, **kwargs):
        raise AssertionError('a tensor built from Python data')
    monkeypatch.setattr(torch, 'tensor', refuse)
    monkeypatch.setattr(torch, 'as_tensor', refuse)
    monkeypatch.setattr(torch.Tensor, 'new_tensor', refuse)
    new = {}
    for n in (2, 6):
        new[n] = aten_ops(lambda: heads[n].get_bboxes(maps[:n]))
        assert_bitwise(heads[n].get_bboxes(maps[:n]), want[n])
    assert new[2] == new[6], new
    assert old[6] > old[2]
