"""The PyTorch port's hard voxelize branch vs the JAX package on the CPU.

* ``hard_voxelize`` (``mask_slots`` on and off): table, coords and
  num_points exactly equal to JAX's, on a pillar of 40 copies of one point
  at capacity 4, on a cloud with more live pillars than ``max_voxels`` and
  on a batched cloud compacted in canvas raster order.
* ``PillarFeatureNet`` (the packed encoder) and ``SortedPillarFeatureNet``
  against JAX's on the same weights, in eval and in training (outputs and
  running statistics within 1e-5, f32 in another summation order), and the
  sorted encoder against the port's packed one.  Gradients through the
  max with ties: the packed max splits them evenly (``amax``, as
  ``jnp.max``), the sorted max gives them to the lowest row (K1's winner,
  as JAX's ``segment_max_lowtie``); each against JAX's own gradient.
* The TINY hard predict (packed and sorted) and one TINY hard train step
  (sparse and dense targets) on a batch whose pillars overflow
  ``max_points`` and whose live pillars overflow ``max_voxels``, by the
  rules of ``tests/test_torch_predict.py`` and ``tests/test_torch_train.py``.
* bf16 (against JAX numbers made by ``tests/torch_bf16_reference.py
  hard`` with XLA's excess precision off, on the crowded batch): both
  encoders' pillar rows in the model, eval, bitwise equal; each encoder
  alone in training, outputs within one bf16 step and gradients within
  1e-5; the TINY hard predict's maps and the train step's loss terms by
  ``tests/test_torch_bf16.py``'s rules, the step's gradients within
  GRAD_TOL of JAX's or of JAX's own spread (see
  :func:`test_bf16_hard_train_step`).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.models import voxel_encoders as jve
from mmdet3d_gaussian_tpu.ops import scatter as jsc
from mmdet3d_gaussian_tpu.ops import voxelize as jvox
from mmdet3d_gaussian_tpu.ops.scan import cummax_i32 as jcummax

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models import voxel_encoders as tve
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.ops import scatter as tsc
from mmdet3d_gaussian_tpu_torch.ops import voxelize as tvox
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from .test_torch_bf16 import BF16_STEP, F32_SUMS, GRAD_TOL, MAP_TOL, _rel
from .test_torch_train import GRAD_RTOL, TINY_HEAD, TINY_MODEL, _np_tree, \
    randomize

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

HARD_MODEL = dict(TINY_MODEL, voxelize_mode='hard')
PCR = TINY_MODEL['point_cloud_range']
VOXEL = TINY_MODEL['voxel_size']
TOL = 1e-5     # f32: the same sums in another order
# The TINY hard train step's gradients, of each parameter's largest: against
# a float64 run of the port on the crowded batch, JAX's f32 gradient of the
# PFN linear weight is 7.4e-5 off (conv_reg 5.8e-5; sums over 32,768 slots
# of coordinates up to 25.6), the port's f32 1.9e-5, so the two are held to
# 1e-4 of each other, not test_torch_train's 2e-5
HARD_GRAD_RTOL = 1e-4


def crowded(device='cpu'):
    """2 x 2,048 points on the TINY 64 x 64 grid: 12 piles of 40 points a
    sample (capacity 16; 8 copies of one point a pile) and ~1,600 live
    pillars a sample against a capacity of 2,048 for the batch.  Seed 6:
    it has positive anchors, and no pair of NMS candidates of the TINY
    predict lies within 1e-4 of nms_thr, where f32 rounding could flip a
    suppression (of seeds 0-9 only 3 and 6 have no such pair, and 3 no
    positive anchor)."""
    return tdet.crowded_batch(2, 2048, 8, seed=6, pc_range=PCR,
                              voxel_size=VOXEL, device=device)


def jax_batch():
    return {k: jnp.asarray(v.numpy()) for k, v in crowded().items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------------ hard voxelize
def _cloud(kind, seed=0):
    """(points (N, 4) f32, coords (N, K) int32, spatial, max_points,
    max_voxels, key_order) of a test cloud; a few points out of range."""
    rng = np.random.RandomState(seed)
    lo, hi = [0., -12.8, -3., 0.], [25.6, 12.8, 1., 1.]
    n = 512 if kind == 'crowded' else 2048
    pts = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    pts[0, :2] = (0.1, -12.7)       # the first pillar in either key order
    pts[100:140] = pts[0]           # 40 points in one pillar (capacity 4)
    pts[-7:, 0] = 30.0              # out of range: invalid
    coords, grid = jsc.compute_voxel_coords(jnp.asarray(pts[:, :3]), PCR,
                                            VOXEL)
    coords = np.asarray(coords)
    spatial = tuple(int(g) for g in np.asarray(grid))
    key_order = None
    if kind == 'batched':
        bidx = (np.arange(n) >= n // 2).astype(np.int32)
        coords = np.asarray(jsc.batch_coords(jnp.asarray(coords),
                                             jnp.asarray(bidx)))
        spatial = (2,) + spatial
        key_order = tvox.CANVAS_KEY_ORDER
    max_voxels = {'crowded': 1024, 'overflow': 300, 'batched': 1000}[kind]
    return pts, coords.astype(np.int32), spatial, 4, max_voxels, key_order


@pytest.mark.parametrize('mask_slots', [True, False])
@pytest.mark.parametrize('kind', ['crowded', 'overflow', 'batched'])
def test_hard_voxelize_matches_jax(kind, mask_slots):
    pts, coords, spatial, max_points, max_voxels, key_order = _cloud(kind)
    want = jvox.hard_voxelize(jnp.asarray(pts), jnp.asarray(coords), spatial,
                              max_points, max_voxels, key_order=key_order,
                              mask_slots=mask_slots)
    got = tvox.hard_voxelize(_t(pts), _t(coords), spatial, max_points,
                             max_voxels, key_order=key_order,
                             mask_slots=mask_slots)
    np.testing.assert_array_equal(got.voxels.numpy(), np.asarray(want.voxels))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.num_points.numpy(),
                                  np.asarray(want.num_points))
    counts = got.scatter.voxel_counts
    assert int(counts.max()) > max_points           # truncation ran
    if kind != 'crowded':
        assert int(got.scatter.num_overflow) > 0    # dropping ran
    if not mask_slots:      # slots past num_points hold neighbours' rows
        slot = torch.arange(max_points)[None, :]
        pad = slot >= got.num_points[:, None]
        assert bool((got.voxels[pad] != 0).any())


# ------------------------------------------------------------- encoders
ENC_CASES = {
    'one_layer': dict(feat_channels=(16,)),
    'masked_max': dict(feat_channels=(16,), masked_max=True),
    'two_layers_distance': dict(feat_channels=(8, 16), with_distance=True),
}


def _enc_inputs(cols):
    """Packed pillars (mask_slots=False, as the trunk) and the sorted rows
    of one cloud, numpy: 3-column coords from the crowded cloud, 4-column
    from the batched one."""
    kind = 'crowded' if cols == 3 else 'batched'
    pts, coords, spatial, max_points, max_voxels, key_order = _cloud(kind)
    hv = jvox.hard_voxelize(jnp.asarray(pts), jnp.asarray(coords), spatial,
                            max_points, max_voxels, key_order=key_order,
                            mask_slots=False)
    return dict(pts=pts, coords=coords, spatial=spatial,
                max_points=max_points, max_voxels=max_voxels,
                key_order=key_order, voxels=np.asarray(hv.voxels),
                vcoords=np.asarray(hv.coords),
                num_points=np.asarray(hv.num_points))


def _jax_sorted(inp):
    """JAX's sorted-encoder arguments, as its PointPillarsNet builds
    them."""
    sc = jsc.build_scatter(jnp.asarray(inp['coords']), inp['spatial'],
                           inp['max_voxels'], key_order=inp['key_order'])
    sv = sc.sorted_view()
    seg = sv.point_voxel_ids
    pos = jnp.arange(seg.shape[0], dtype=jnp.int32)
    firstf = jnp.concatenate([jnp.ones((1,), bool), seg[1:] != seg[:-1]])
    rank = pos - jcummax(jnp.where(firstf, pos, 0))
    kept = (seg < inp['max_voxels']) & (rank < inp['max_points'])
    kept_cnt = jnp.minimum(sc.voxel_counts, inp['max_points'])
    rows = jnp.take(jnp.asarray(inp['pts']), sc.sort_order, axis=0)
    return rows, (sv, kept, kept_cnt, inp['max_points'])


def _port_sorted(inp):
    sc = tsc.build_scatter(_t(inp['coords']), inp['spatial'],
                           inp['max_voxels'], key_order=inp['key_order'])
    sv = sc.sorted_view()
    kept = tvox.hard_kept_rows(sv.point_voxel_ids, inp['max_voxels'],
                               inp['max_points'])
    kept_cnt = sc.voxel_counts.clamp(max=inp['max_points'])
    return _t(inp['pts'])[sc.sort_order], (sv, kept, kept_cnt,
                                           inp['max_points'])


def _pair(cfg, inp, sorted_form=False):
    """(JAX module, randomized variables, port module with them loaded)."""
    kw = dict(cfg, voxel_size=VOXEL, point_cloud_range=PCR)
    if sorted_form:
        mod = jve.SortedPillarFeatureNet(**kw)
        rows, args = _jax_sorted(inp)
        variables = mod.init(jax.random.PRNGKey(0), rows, *args)
        port = tve.SortedPillarFeatureNet(**kw)
    else:
        mod = jve.PillarFeatureNet(**kw)
        variables = mod.init(jax.random.PRNGKey(0), inp['voxels'],
                             inp['vcoords'], inp['num_points'])
        port = tve.PillarFeatureNet(**kw)
    variables = randomize(_np_tree(variables), np.random.RandomState(1))
    port.load_state_dict(_encoder_sd(variables), strict=True)
    return mod, variables, port


def _encoder_sd(variables):
    sd = jax_variables_to_torch(
        {'params': {'voxel_encoder': variables['params']},
         'batch_stats': {'voxel_encoder': variables['batch_stats']}})
    return {k[len('voxel_encoder.'):]: v for k, v in sd.items()}


def _packed_args(inp):
    return (_t(inp['voxels']), _t(inp['vcoords']), _t(inp['num_points']))


def _live(inp, out):
    """Rows of live pillars (masked_max leaves -1e4 in an empty pillar's
    packed row and 0 in its sorted row; neither reaches the canvas)."""
    return out[inp['num_points'] > 0]


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case,cols', [('one_layer', 3), ('masked_max', 4),
                                       ('two_layers_distance', 3),
                                       ('two_layers_distance', 4)])
def test_pillar_feature_net_matches_jax(case, cols, train):
    inp = _enc_inputs(cols)
    mod, variables, port = _pair(ENC_CASES[case], inp)
    want, upd = mod.apply(variables, inp['voxels'], inp['vcoords'],
                          inp['num_points'], train=train,
                          mutable=['batch_stats'])
    port.train(train)
    got = port(*_packed_args(inp))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    stats = _encoder_sd({'params': variables['params'],
                         'batch_stats': _np_tree(upd['batch_stats'])})
    for k, v in port.state_dict().items():
        if 'running_' in k:
            if not train:
                np.testing.assert_array_equal(v.numpy(), stats[k].numpy())
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case,cols', [('one_layer', 4), ('masked_max', 3),
                                       ('two_layers_distance', 4)])
def test_sorted_pillar_feature_net_matches_jax_and_packed(case, cols,
                                                           train):
    """Against JAX's sorted encoder, and against the port's packed
    encoder with the same weights (live pillars)."""
    inp = _enc_inputs(cols)
    mod, variables, port = _pair(ENC_CASES[case], inp, sorted_form=True)
    rows, args = _jax_sorted(inp)
    want, upd = mod.apply(variables, rows, *args, train=train,
                          mutable=['batch_stats'])
    port.train(train)
    trows, targs = _port_sorted(inp)
    got = port(trows, *targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    stats = _encoder_sd({'params': variables['params'],
                         'batch_stats': _np_tree(upd['batch_stats'])})
    packed = tve.PillarFeatureNet(**ENC_CASES[case], voxel_size=VOXEL,
                                  point_cloud_range=PCR)
    packed.load_state_dict(_encoder_sd(variables), strict=True)
    packed.train(train)
    other = packed(*_packed_args(inp))
    np.testing.assert_allclose(_live(inp, got.detach().numpy()),
                               _live(inp, other.detach().numpy()),
                               rtol=TOL, atol=TOL)
    for k, v in port.state_dict().items():
        if 'running_' in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)
            np.testing.assert_allclose(v.numpy(),
                                       packed.state_dict()[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)


def _grad_check(got, want, rtol=GRAD_RTOL):
    """Each gradient within ``rtol`` of its largest magnitude."""
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=rtol * scale,
                                   err_msg=k)


def _last_layer_rows(port, x_fn):
    """The last PFN layer's rows before its max (ReLU of its BatchNorm's
    output, from a forward hook) in the forward ``x_fn()`` runs."""
    seen = []
    h = port.pfn_layers[-1].norm.register_forward_hook(
        lambda _m, _i, out: seen.append(torch.relu(out.detach())))
    try:
        x_fn()
    finally:
        h.remove()
    return seen[0]


def test_packed_max_gradient_splits_ties():
    """Training-mode gradients of a weighted sum of the packed encoder's
    output, with respect to the table and every parameter, against JAX's:
    the 40 copies fill a pillar with equal slots, whose tied maxima split
    the gradient evenly (``max(dim)`` would give it all to one slot)."""
    inp = _enc_inputs(3)
    mod, variables, port = _pair(ENC_CASES['one_layer'], inp)
    g = np.random.RandomState(2).randn(inp['voxels'].shape[0], 16).astype(
        np.float32)

    def f(params, vox):
        out, _ = mod.apply({'params': params,
                            'batch_stats': variables['batch_stats']}, vox,
                           inp['vcoords'], inp['num_points'], train=True,
                           mutable=['batch_stats'])
        return jnp.sum(out * g)
    gp, gv = jax.grad(f, argnums=(0, 1))(variables['params'],
                                         jnp.asarray(inp['voxels']))
    port.train()
    vox, vc, npts = _packed_args(inp)
    vox.requires_grad_(True)
    y = _last_layer_rows(port, lambda: port(vox, vc, npts))
    ties = (y == y.amax(1, keepdim=True)).sum(1) > 1
    full = npts == inp['max_points']
    assert bool(ties[full].any())          # tied real slots in full pillars
    out = port(vox, vc, npts)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((out * _t(g)).sum(),
                                [vox] + list(params.values()))
    want = {'voxels': np.asarray(gv),
            **{k: v.numpy() for k, v in _encoder_sd(
                {'params': _np_tree(gp),
                 'batch_stats': variables['batch_stats']}).items()
               if k in params}}
    got = {'voxels': grads[0].numpy(),
           **{k: v.numpy() for k, v in zip(params, grads[1:])}}
    _grad_check(got, want)


def test_sorted_max_gradient_goes_to_lowest_row():
    """The same for the sorted encoder with respect to the sorted rows:
    of equal rows holding a voxel's max, the lowest takes the gradient (K1's
    winner; JAX's ``segment_max_lowtie``), and a tie with the padded slots
    splits evenly (``maximum``)."""
    inp = _enc_inputs(4)
    mod, variables, port = _pair(ENC_CASES['one_layer'], inp,
                                 sorted_form=True)
    rows, args = _jax_sorted(inp)
    g = np.random.RandomState(3).randn(inp['max_voxels'], 16).astype(
        np.float32)

    def f(params, r):
        out, _ = mod.apply({'params': params,
                            'batch_stats': variables['batch_stats']}, r,
                           *args, train=True, mutable=['batch_stats'])
        return jnp.sum(out * g)
    gp, gr = jax.grad(f, argnums=(0, 1))(variables['params'], rows)
    port.train()
    trows, targs = _port_sorted(inp)
    trows.requires_grad_(True)
    out = port(trows, *targs)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((out * _t(g)).sum(),
                                [trows] + list(params.values()))
    d_rows = grads[0].numpy()
    want = {'rows': np.asarray(gr),
            **{k: v.numpy() for k, v in _encoder_sd(
                {'params': _np_tree(gp),
                 'batch_stats': variables['batch_stats']}).items()
               if k in params}}
    _grad_check({'rows': d_rows, **{k: v.numpy() for k, v in
                                    zip(params, grads[1:])}}, want)
    # the 41 copies of point 0 are sorted rows p..p+40 of one voxel, which
    # keeps the first 4, equal rows with no padded slot: the lowest takes
    # the max's gradient, the other three only what the decoration and the
    # BatchNorm statistics send them
    same = np.all(trows.detach().numpy() == inp['pts'][0], axis=1)
    p = int(np.flatnonzero(same)[0])
    assert same[p:p + 41].all() and int(targs[2][targs[0].point_voxel_ids[
        p]]) == inp['max_points']
    assert not np.allclose(d_rows[p], d_rows[p + 1])
    np.testing.assert_array_equal(d_rows[p + 1], d_rows[p + 2])
    assert not d_rows[p + 4:p + 41].any()          # rows past the capacity


# ------------------------------------------------------- the TINY model
def _jax_tiny(cfg, head=TINY_HEAD):
    jd = jdet.PointPillarsDetector(model_cfg=cfg, head_cfg=head)
    batch = jax_batch()
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), batch)
    return jd, batch, randomize(_np_tree(variables),
                                np.random.RandomState(0))


@pytest.fixture(scope='module')
def predict_pair():
    """JAX's hard predict (packed, its default) and the weights."""
    jd, batch, variables = _jax_tiny(HARD_MODEL)
    maps = jax.jit(jd.apply_eval)(variables, batch)
    dets = jax.jit(jax.vmap(jd.head.get_bboxes, in_axes=(0, 0, 0, None)))(
        maps[0], maps[1], maps[2], jd.anchors)
    _, inter = jd.trunk.apply(
        variables, batch['points'], batch['points_mask'], train=False,
        capture_intermediates=lambda mdl, _: mdl.name == 'voxel_encoder')
    pillars = inter['intermediates']['voxel_encoder']['__call__'][0]
    return dict(variables=variables, maps=[np.asarray(m) for m in maps[:4]],
                dets=[np.asarray(d) for d in dets],
                pillars=np.asarray(pillars))


def _port_tiny(cfg, variables, head=TINY_HEAD):
    det = tdet.PointPillarsDetector(cfg, head, device='cpu')
    det.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    return det


@pytest.mark.parametrize('encoder', ['packed', 'sorted'])
def test_hard_pillar_rows_and_maps(predict_pair, encoder):
    det = _port_tiny(dict(HARD_MODEL, hard_encoder=encoder),
                     predict_pair['variables'])
    assert not det.trunk.s2d
    batch = crowded()
    with torch.inference_mode():
        feats, coords, scatter = det.trunk.pillars(batch['points'],
                                                   batch['points_mask'])
        maps = det.apply_eval(batch)
    assert int(scatter.num_overflow) > 0
    assert int(scatter.voxel_counts.max()) > HARD_MODEL['max_points_per_voxel']
    np.testing.assert_allclose(feats.numpy(), predict_pair['pillars'],
                               rtol=1e-5, atol=1e-5)
    for g, w, name in zip(maps, predict_pair['maps'],
                          ('cls', 'bbox', 'dir', 'packed')):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_hard_predict(predict_pair):
    """Equal valid / labels, scores and boxes within tolerance; every
    candidate IoU at least 1e-4 from nms_thr."""
    det = _port_tiny(HARD_MODEL, predict_pair['variables'])
    batch = crowded()
    got = [x.numpy() for x in det.predict(batch)]
    want = predict_pair['dets']
    with torch.inference_mode():
        maps = det.apply_eval(batch)
        b_sorted, _, v_sorted = det.head.select_candidates(
            maps[0], maps[1], maps[2], det.anchors)
    k = b_sorted.shape[2]
    iou = tiou.iou_bev_pairwise(
        b_sorted[..., [0, 1, 3, 4, 6]].reshape(-1, k, 5).contiguous())
    v = v_sorted.reshape(-1, k).numpy()
    pair = v[:, :, None] & v[:, None, :]
    assert np.abs(iou.numpy()[pair] - 0.01).min() > 1e-4
    assert got[3].sum() >= 10
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], atol=1e-5)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-4)


@pytest.fixture(scope='module', params=['sparse', 'dense'])
def hard_step_pair(request):
    """One hard train step (packed encoder) of JAX and of the port on the
    same weights and batch: loss terms, gradients, running statistics."""
    head = dict(TINY_HEAD, pos_cap={'sparse': 1024, 'dense': 0}[
        request.param])
    jd, jbatch, variables = _jax_tiny(HARD_MODEL, head)

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
    td = _port_tiny(HARD_MODEL, variables, head)
    batch = crowded()
    total_t, losses_t = td.loss(td.apply_train(batch), batch)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(total=float(total_t.detach()),
               losses={k: float(v.detach()) for k, v in losses_t.items()},
               grads=dict(zip(params, grads_t)),
               state=td.trunk.state_dict())
    return want, got


def test_hard_train_step_losses(hard_step_pair):
    want, got = hard_step_pair
    assert set(got['losses']) == set(want['losses']) == {
        'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, v in want['losses'].items():
        np.testing.assert_allclose(got['losses'][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got['total'], want['total'], rtol=1e-5)
    assert want['losses']['loss_bbox'] > 0


def test_hard_train_step_gradients(hard_step_pair):
    want, got = hard_step_pair
    assert set(got['grads']) == set(want['grads'])
    assert 'voxel_encoder.pfn_layers.0.linear.weight' in want['grads']
    _grad_check({k: v.numpy() for k, v in got['grads'].items()},
                {k: v.numpy() for k, v in want['grads'].items()},
                HARD_GRAD_RTOL)


def test_hard_train_step_running_stats(hard_step_pair):
    want, got = hard_step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    assert len(keys) == 2 * (1 + 6 + 3)
    for k in keys:
        np.testing.assert_allclose(got['state'][k].numpy(),
                                   want['state'][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_hard_train_steps_descend():
    """Three port train steps of the sorted encoder on one batch: finite
    losses that go down; the encoder's weights and statistics move."""
    det = tdet.PointPillarsDetector(dict(HARD_MODEL, hard_encoder='sorted'),
                                    TINY_HEAD, device='cpu')
    batch = crowded()
    before = {k: v.clone() for k, v in det.trunk.state_dict().items()}
    state = det.init_train(1e-3, total_steps=100)
    losses = []
    for _ in range(3):
        state, metrics = det.train_step(batch, state)
        losses.append(float(metrics['loss']))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    after = det.trunk.state_dict()
    for k in ('voxel_encoder.pfn_layers.0.linear.weight',
              'voxel_encoder.pfn_layers.0.norm.running_var'):
        assert not torch.equal(after[k], before[k]), k


# ------------------------------------------------------- TINY bf16 hard
@pytest.fixture(scope='module')
def ref16(tmp_path_factory):
    """JAX's hard numbers from ``tests/torch_bf16_reference.py hard``, in a
    process of its own with XLA's excess precision off."""
    out = tmp_path_factory.mktemp('bf16hard') / 'ref.npz'
    proc = subprocess.run(
        [sys.executable, '-m', 'tests.torch_bf16_reference', str(out),
         'hard'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        arrays = dict(f)

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items()
                if k.startswith(prefix + '/')}
    return group


def _port16(ref, head=TINY_HEAD):
    det = tdet.PointPillarsDetector(dict(HARD_MODEL,
                                         compute_dtype='bfloat16'), head,
                                    device='cpu')
    det.trunk.load_state_dict({k: torch.from_numpy(v)
                               for k, v in ref('sd').items()}, strict=True)
    assert not det.trunk.s2d
    return det


def _load(port, sd):
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    return port


@pytest.mark.parametrize('encoder', ['packed', 'sorted'])
def test_bf16_hard_pillar_rows(ref16, encoder):
    """The bf16 model's pillar rows (linear layers in bf16, BatchNorm in
    f32), eval: bitwise equal to JAX's, from either encoder."""
    det = tdet.PointPillarsDetector(
        dict(HARD_MODEL, compute_dtype='bfloat16', hard_encoder=encoder),
        TINY_HEAD, device='cpu')
    _load(det.trunk, ref16('sd'))
    batch = crowded()
    with torch.inference_mode():
        feats = det.trunk.pillars(batch['points'], batch['points_mask'])[0]
    assert feats.dtype == torch.bfloat16
    assert str(ref16('pillars16')['dtype']) == 'bfloat16'
    np.testing.assert_array_equal(feats.float().numpy(),
                                  ref16('pillars16')['rows'])


@pytest.mark.parametrize('encoder', ['packed', 'sorted'])
def test_bf16_hard_encoder_train(ref16, encoder):
    """Each hard encoder alone in bf16, training mode, one layer (as the
    KITTI config): output rows within one bf16 step, the gradient of a
    weighted sum of them for every parameter (each element within one bf16
    step of its value, or 1e-5 of the largest) and the running statistics
    (1e-5), against JAX's bf16 encoder.  (With two layers the gradients
    part: the tiled max's cotangent is summed over the slots, which XLA on
    the CPU does in bf16, one rounding an add, and PyTorch in f32.  A port
    summing in bf16 one slot after another matches JAX there to 1.2e-6 of
    the largest value, against 3.6e-2 summing in f32.)"""
    want = ref16(f'enc_{encoder}_out')
    inp = _enc_inputs(4)
    cls = tve.SortedPillarFeatureNet if encoder == 'sorted' else \
        tve.PillarFeatureNet
    port = _load(cls(**ENC_CASES['one_layer'], voxel_size=VOXEL,
                     point_cloud_range=PCR, dtype='bfloat16'),
                 ref16(f'enc_{encoder}_sd'))
    port.train()
    if encoder == 'sorted':
        rows, args = _port_sorted(inp)
        out = port(rows, *args)
    else:
        out = port(*_packed_args(inp))
    assert out.dtype == torch.bfloat16 and str(want['dtype']) == 'bfloat16'
    differ = float((out.detach().float().numpy() != want['rows']).mean())
    print(f'{encoder}: share of bf16 outputs that differ {differ:.3g}')
    np.testing.assert_allclose(out.detach().float().numpy(), want['rows'],
                               rtol=BF16_STEP, atol=0)
    g = np.random.RandomState(2).randn(*out.shape).astype(np.float32)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((out.float() * _t(g)).sum(),
                                list(params.values()))
    want = ref16(f'enc_{encoder}_grad')
    assert set(want) == set(params)
    for k, got in zip(params, grads):
        w = want[k]
        np.testing.assert_allclose(got.numpy(), w, rtol=BF16_STEP,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    for k, w in ref16(f'enc_{encoder}_state').items():
        if 'running_' in k:
            np.testing.assert_allclose(port.state_dict()[k].numpy(), w,
                                       rtol=TOL, atol=TOL, err_msg=k)


def _port16(ref, head=TINY_HEAD):
    det = tdet.PointPillarsDetector(dict(HARD_MODEL,
                                         compute_dtype='bfloat16'), head,
                                    device='cpu')
    _load(det.trunk, ref('sd'))
    assert not det.trunk.s2d
    return det


def test_bf16_hard_predict(ref16):
    """Head maps within MAP_TOL of JAX bf16 and nearer to it than half of
    JAX bf16's distance from JAX f32 (``tests/test_torch_bf16.py``'s
    rule)."""
    det = _port16(ref16)
    maps = det.apply_eval(crowded())
    m16, m32 = ref16('maps16'), ref16('maps32')
    for i, name in enumerate(('cls', 'bbox', 'dir', 'packed')):
        assert str(m16[f'{i}/dtype']) == 'bfloat16'
        assert maps[i].dtype == torch.bfloat16
        err, gap = _rel(maps[i], m16[str(i)]), _rel(m16[str(i)], m32[str(i)])
        print(f'{name}: port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {gap:.3g}')
        assert err <= MAP_TOL, name
        assert err < 0.5 * gap, name


def _jax_bf16_step_excess(head):
    """JAX's bf16 step (loss terms, gradients) in this process, where XLA
    keeps its excess precision (on by default): the same program with
    fewer roundings, a measure of how far bf16 rounding alone moves
    them."""
    jd, jbatch, variables = _jax_tiny(dict(HARD_MODEL,
                                           compute_dtype='bfloat16'), head)

    def f(params):
        outs, _ = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch)
        total, losses = jd.loss(outs, jbatch)
        return total, losses
    (_, losses), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])
    return ({k: float(v) for k, v in losses.items()},
            jax_grads_to_torch(_np_tree(grads)))


@pytest.mark.parametrize('mode', ['sparse', 'dense'])
def test_bf16_hard_train_step(ref16, mode):
    """Each loss term within 2e-2 of JAX bf16 (excess precision off), and
    each loss term and parameter gradient nearer to it than half of JAX
    bf16's distance from JAX f32 (``tests/test_torch_bf16.py``'s rule) or
    than JAX's own bf16 step with XLA's excess precision on, and within
    GRAD_TOL of it or of that spread.  In the hard step the two JAX bf16
    runs differ as much as bf16 differs from f32 (the PFN weight's
    gradient 0.83 of its largest value apart, JAX bf16 0.79 from f32): sums
    with deep cancellation that XLA on the CPU partly rounds in bf16 (see
    :func:`test_bf16_hard_encoder_train`), where the half-gap rule alone
    cannot hold.  ``F32_SUMS`` are held to JAX f32 as there.  The sparse
    step's running statistics within 1e-5.  The
    hard encoders' casts are held exactly by the two tests above; the trunk
    after the canvas is the dynamic path's, held by
    ``tests/test_torch_bf16.py``."""
    tag = '' if mode == 'sparse' else 'd'
    head = TINY_HEAD if mode == 'sparse' else dict(TINY_HEAD, pos_cap=0)
    port = _port16(ref16, head)
    tb = crowded()
    total, losses = port.loss(port.apply_train(tb), tb)
    params = dict(port.trunk.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    want16, want32 = ref16(f'loss16{tag}'), ref16(f'loss32{tag}')
    excess_losses, excess = _jax_bf16_step_excess(head)
    assert set(losses) == set(want16) == {'loss_cls', 'loss_bbox',
                                          'loss_dir'}
    for k, v in losses.items():
        got, w, f = float(v.detach()), float(want16[k]), float(want32[k])
        print(f'{k}: port {got:.6g}, JAX bf16 {w:.6g} (excess precision on '
              f'{excess_losses[k]:.6g}), JAX f32 {f:.6g}')
        np.testing.assert_allclose(got, w, rtol=2e-2, err_msg=k)
        assert (abs(got - w) < 0.5 * abs(w - f)
                or abs(got - w) <= abs(excess_losses[k] - w)), k
    want, f32 = ref16(f'grad16{tag}'), ref16(f'grad32{tag}')
    assert set(grads) == set(want)
    worst = []
    for k, w in want.items():
        assert grads[k].dtype == torch.float32, k
        gap = _rel(w, f32[k])
        if k in F32_SUMS:       # held to JAX f32, as in test_torch_bf16
            err = _rel(grads[k], f32[k])
            assert err <= GRAD_TOL and err < 0.5 * gap, (k, err, gap)
            continue
        err, noise = _rel(grads[k], w), _rel(excess[k], w)
        worst.append((err / max(noise, 0.5 * gap), err, noise, gap, k))
        assert err <= max(GRAD_TOL, noise), (k, err, noise)
        assert err < 0.5 * gap or err <= noise, (k, err, noise, gap)
    worst.sort(reverse=True)
    print('largest port error / max(JAX excess on vs off, half JAX bf16 vs '
          'f32) (error, on vs off, bf16 vs f32):', worst[:3])
    if mode == 'sparse':
        want = ref16('state16')
        got = port.trunk.state_dict()
        assert len(want) == 2 * (1 + 6 + 3)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
