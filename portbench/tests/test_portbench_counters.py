"""The frozen yardstick: the FLOP counter against
``torch.utils.flop_counter.FlopCounterMode`` on a tiny configuration,
and the hand kernels' work counters against ``chip_smoke.py``'s and the
port's on the same inputs."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou
from portbench import flops, traffic, work
from portbench.families.common import to_device
from portbench.tests import tiny

SEED = 2 ** 31 + 77


def _batch(name, over, cfg):
    tf = dict(traffic.load(name), **dict(over, pool=1))
    return to_device(traffic.make_pool(tf, SEED)[0], 'cpu'), tf


def _counted(det, batch):
    with FlopCounterMode(display=False) as fc:
        det.apply_eval(batch)
    return fc.get_total_flops()


def test_flops_pointpillars_forward():
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        PointPillarsDetector
    cfg = tiny.pp_config()
    batch, tf = _batch('kitti_train_b12', tiny.PP_TRAFFIC, cfg)
    det = PointPillarsDetector(cfg['model'], cfg['head'], device='cpu')
    got = _counted(det, batch)
    b = tf['frames']
    want = flops.forward(cfg, b, tf['pad_points'])
    # the port's head multiplies by its fused weight padded to 128 output
    # lanes, on each of the neck's three branches
    hc = cfg['model']['head_cfg']
    outs = hc['num_anchors'] * (hc['num_classes'] + 9)
    h, w, c = flops.trunk(cfg['model'], b)[1]
    pad = 2 * b * h * w * c * (128 - outs)
    assert got == want + pad


def test_flops_centerpoint_forward():
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        CenterPointDetector
    cfg = tiny.cp_config()
    batch, tf = _batch('nus_lidar_b4', tiny.CP_TRAFFIC, cfg)
    det = CenterPointDetector(cfg['model'], cfg['head'], device='cpu')
    assert det.trunk.s2d
    want = flops.forward(cfg, tf['frames'], tf['pad_points'])
    # on the space-to-depth canvas the port runs stage 0's stride-2 3 x 3
    # conv as a 2 x 2 conv over 4 Cin channels (its folded kernel holds
    # zeros): 16 Cin taps in place of 9 Cin
    bb = cfg['model']['backbone_cfg']
    ny, nx = det.trunk.ny, det.trunk.nx
    fold = tf['frames'] * flops.conv(ny // 2, nx // 2, bb['in_channels'],
                                     bb['out_channels'][0], 1) * (16 - 9)
    assert _counted(det, batch) == want + fold


def test_flops_train_step_is_three_forwards():
    """Backward as twice the forward, but for the padded lanes of the
    head's fused weight (forward and backward) and the encoder's linear
    layer, whose input needs no gradient."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        PointPillarsDetector
    cfg = tiny.pp_config()
    batch, tf = _batch('kitti_train_b12', tiny.PP_TRAFFIC, cfg)
    det = PointPillarsDetector(cfg['model'], cfg['head'], device='cpu')
    state = det.init_train()
    with FlopCounterMode(display=False) as fc:
        det.train_step(batch, state)
    b, m = tf['frames'], cfg['model']
    hc = m['head_cfg']
    h, w, c = flops.trunk(m, b)[1]
    pad = 2 * b * h * w * c * (128 - hc['num_anchors']
                               * (hc['num_classes'] + 9))
    pfn = 2 * m['max_voxels_per_sample'] * b * m['max_points_per_voxel'] \
        * (m['encoder_cfg']['in_channels'] + 6) \
        * m['encoder_cfg']['feat_channels'][0]
    want = flops.step(cfg, b, tf['pad_points'], train=True) + 3 * pad - pfn
    assert fc.get_total_flops() == want


@pytest.mark.parametrize('config, frames, points, train, want', [
    ('pp_kitti_3class_kld', 12, 20000, True, 2484107476992.0),
    ('centerpoint_nus_gwd5', 4, 60000, False, 538651672576.0)])
def test_flops_of_the_cells_are_pinned(config, frames, points, train, want):
    """The cells' step FLOPs, bit for bit as the counter read them when
    the families came to count their own forward passes: ``mfu.*`` keeps
    its scale."""
    from portbench import configs
    assert flops.step(configs.load(config), frames, points, train) == want


def test_k1_work_as_chip_smoke():
    data = torch.randn(100, 64)
    counts = torch.tensor([3, 0, 5, 7], dtype=torch.int32)
    starts = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    ids = torch.randint(0, 4, (100,), dtype=torch.int32)
    for form in ('reduce', 'mapback', 'winner'):
        assert work.k1_work(form, data, ids, starts, counts) == \
            chip_smoke.k1_work(form, data, ids, starts, counts)


@pytest.mark.parametrize('case', ['clustered', 'all near', 'none near'])
def test_k5_work_as_chip_smoke(case, monkeypatch):
    monkeypatch.setattr(torch.Tensor, 'cuda', lambda self: self)
    boxes = chip_smoke.k5_boxes(case, seed=3, p=2, k=64)
    n_near = int(rotated_iou.near_pairs_plain(boxes).sum())
    assert work.near_pairs(boxes) == n_near
    assert work.k5_work(boxes) == chip_smoke.k5_work(boxes, n_near)


def test_k6_work_as_chip_smoke():
    gen = torch.Generator().manual_seed(5)
    valid = torch.rand(3, 50, generator=gen) > 0.2
    keep = valid & (torch.rand(3, 50, generator=gen) > 0.5)
    iou = torch.rand(3, 50, 50, generator=gen)
    assert work.k6_work(iou, valid, 0.2, keep) == chip_smoke.k6_work(valid,
                                                                     keep)


def test_splat_and_moments_bytes_as_chip_smoke():
    feats = torch.randn(300, 64)
    lin = torch.arange(300, dtype=torch.int32) * 2
    ncell = 1000
    out = torch.zeros(ncell, 64)
    # chip_smoke's K2 count: rows, ids and the canvas once each
    assert work._splat((feats, lin, ncell), out) == (
        feats.numel() * 4 + lin.numel() * 4 + ncell * 64 * 4, 0)
    x = torch.randn(2, 64, 10, 12).to(memory_format=torch.channels_last)
    m, cc = 2 * 10 * 12, 64
    assert work._moments((x,), None) == (m * cc * 4 + 2 * cc * 4, 2 * m * cc)
    g = torch.randn_like(x)
    assert work._grad_moments((g, x, None, None), None) == (
        2 * m * cc * 4 + 4 * cc * 4, 4 * m * cc)


def test_bound_is_the_larger_time():
    assert work.bound_s(3.35e12, 0) == 1.0
    assert math.isclose(work.bound_s(0, 134e12), 2.0)


def test_recorded_calls_hold_no_large_tensor():
    big = torch.zeros(2, 64, 64, 80)
    small = torch.ones(7, dtype=torch.int32)
    args = work.light((big, small, 3))
    assert isinstance(args[0], work.Shape) and args[1] is small
    assert work._moments(args, None) == work._moments((big,), None)


def test_collective_ms_takes_each_collective_of_the_last_rank():
    """Each collective's NCCL kernel on the rank that reached it last (the
    least time): the ranks' waits are left out; unmatched counts fall
    back to the least rank's total; one card reads nothing."""
    from types import SimpleNamespace
    from portbench.metrics.common import collective_ms
    ctx = SimpleNamespace(kind='train', units=2,
                          collectives=[[900.0, 10.0, 30.0],
                                       [20.0, 400.0, 50.0]])
    assert collective_ms(ctx, 'train') == (20.0 + 10.0 + 30.0) / 1e3 / 2
    ctx.collectives = [[900.0, 10.0], [20.0, 400.0, 50.0]]
    assert collective_ms(ctx, 'train') == 470.0 / 1e3 / 2
    assert collective_ms(ctx, 'predict') is None
    ctx.collectives = [[], []]
    assert collective_ms(ctx, 'train') is None
    assert collective_ms(SimpleNamespace(kind='train', units=2),
                         'train') is None
