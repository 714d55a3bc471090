"""The port's spans and counters (``engine/profiling.py``) on the CPU: a
no-op with recording off; with it on, the span tree, parents and unit ids
of the TINY hard PointPillars train step and the dynamic s2d CenterPoint
predict; the pillar counters against the Scatter, also with pillars
dropped at capacity; the spans on the profiler's clock; outputs and
gradients bitwise equal with recording on and off; an exception inside a
span; an export under a recording records nothing."""
import contextlib

import pytest
import torch

from mmdet3d_gaussian_tpu_torch.engine import profiling
from mmdet3d_gaussian_tpu_torch.engine.detector import (CenterPointDetector,
                                                        PointPillarsDetector,
                                                        crowded_batch,
                                                        synthetic_batch)

TINY_HARD = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    max_points_per_voxel=16,
    max_voxels_per_sample=1024,
    voxelize_mode='hard',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))
# dynamic pillars on the s2d canvas (stride-2 first stage, even grid)
TINY_CP = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 1.0),
    max_voxels_per_sample=1024,
    voxelize_mode='dynamic',
    head_type='center',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(0.5, 1, 2)),
)
TINY_CP_HEAD = dict(
    tasks=[dict(num_classes=2), dict(num_classes=1)],
    out_size_factor=4, with_vel=False, code_weights=None, max_objs=16,
    test_cfg=dict(max_per_img=32, score_threshold=0.05, nms_type='rotate',
                  nms_thr=0.2, post_max_size=16))

TRUNK = ['voxelize', 'encoder', 'canvas', 'backbone', 'neck', 'head']


def pp_case(model=TINY_HARD):
    det = PointPillarsDetector(model, TINY_HEAD, device='cpu')
    batch = crowded_batch(2, 1024, 8, pc_range=model['point_cloud_range'],
                          voxel_size=model['voxel_size'], device='cpu')
    return det, batch


def cp_case():
    det = CenterPointDetector(TINY_CP, TINY_CP_HEAD, device='cpu')
    batch = synthetic_batch(2, 1024, 8, pc_range=TINY_CP['point_cloud_range'],
                            device='cpu')
    return det, batch


def tree(rec):
    """[(name, parent's name, unit)] in the order the spans opened."""
    by_id = {s.id: s for s in rec.spans}
    return [(s.name, by_id[s.parent].name if s.parent is not None else None,
             s.unit) for s in rec.spans]


def annotations(prof):
    """(start us, end us, name) of the profiled host events."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()]


def test_recording_off_is_a_no_op():
    from torch.profiler import ProfilerActivity, profile
    assert profiling.span('voxelize') is profiling.span('nms')
    profiling.count('pillars.live', 5)
    det, batch = pp_case()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.predict(batch)
    names = [n for _s, _e, n in annotations(prof)]
    assert 'aten::sort' in names
    assert not [n for n in names if n.startswith(profiling.ANNOTATION)]


def test_train_step_span_tree():
    det, batch = pp_case()
    state = det.init_train(1e-3, 100)
    with profiling.recording() as rec:
        state, _ = det.train_step(batch, state)
        state, _ = det.train_step(batch, state)
    assert rec.units == 2
    one = ([('train_step', None), ('forward', 'train_step')]
           + [(n, 'forward') for n in TRUNK]
           + [(n, 'train_step')
              for n in ('targets', 'loss', 'backward', 'optimizer')])
    got = tree(rec)
    assert [(n, p) for n, p, _u in got] == one + one
    assert [u for _n, _p, u in got] == [0] * len(one) + [1] * len(one)
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_predict_span_trees():
    cp, cp_batch = cp_case()
    assert cp.trunk.s2d and cp.trunk.voxelize_mode == 'dynamic'
    pp, pp_batch = pp_case()
    with profiling.recording() as rec:
        cp.predict(cp_batch)
        pp.predict(pp_batch)
    one = ([('predict', None), ('forward', 'predict')]
           + [(n, 'forward') for n in TRUNK]
           + [('decode', 'predict'), ('nms', 'decode')])
    got = tree(rec)
    assert [(n, p) for n, p, _u in got] == one + one
    assert [u for _n, _p, u in got] == [0] * len(one) + [1] * len(one)


@pytest.mark.parametrize('capacity', [1024, 100])
def test_pillar_counters_are_the_scatters(capacity):
    """``pillars.live`` and ``pillars.dropped`` a unit are the Scatter's
    ``num_live`` and ``num_overflow``; at 100 pillars a sample the crowded
    batch drops some."""
    model = dict(TINY_HARD, max_voxels_per_sample=capacity)
    det, batch = pp_case(model)
    det.trunk.eval()
    with torch.no_grad():
        _f, _c, scatter = det.trunk.pillars(batch['points'],
                                            batch['points_mask'])
    live, dropped = int(scatter.num_live), int(scatter.num_overflow)
    assert live == int(scatter.num_voxels) + dropped
    assert (dropped > 0) == (capacity < 1024)
    state = det.init_train(1e-3, 100)
    with profiling.recording() as rec:
        det.predict(batch)
        det.train_step(batch, state)
    assert rec.units == 2
    assert rec.counts == {'pillars.live': 2 * live,
                          'pillars.dropped': 2 * dropped}


def test_counter_sums_tensors_when_the_recording_closes():
    with profiling.recording() as rec:
        with profiling.span('predict'):
            profiling.count('n', torch.tensor(3, dtype=torch.int32))
            profiling.count('n', 4)
        profiling.count('m', 1)
        assert rec.counts == {}
    assert rec.counts == {'n': 7, 'm': 1}


def test_spans_lie_on_the_profilers_clock():
    """Under a CPU profiler each span is an ``mmdet3d::`` annotation that
    contains the ops called inside it: every sort in ``voxelize`` (the
    pillars' keys) or ``decode`` (the scores), every convolution in
    ``backbone``, ``neck`` or ``head``."""
    from torch.profiler import ProfilerActivity, profile
    det, batch = cp_case()
    with profiling.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        det.predict(batch)
    events = annotations(prof)
    spans = [(s, e, n[len(profiling.ANNOTATION):]) for s, e, n in events
             if n.startswith(profiling.ANNOTATION)]
    assert sorted(n for _s, _e, n in spans) == \
        sorted(s.name for s in rec.spans)

    def inside(op, names):
        found = [(s, e) for s, e, n in events if n == op]
        assert found, op
        return all(any(a <= s and e <= b for a, b, n in spans if n in names)
                   for s, e in found)
    assert inside('aten::sort', {'voxelize', 'decode'})
    assert not inside('aten::sort', {'decode'})
    assert inside('aten::convolution', {'backbone', 'neck', 'head'})
    assert not inside('aten::convolution', {'backbone'})


def test_recording_changes_nothing_computed():
    """Outputs, gradients and the step's update bitwise equal with
    recording on and off."""
    cp, cp_batch = cp_case()
    pp, batch = pp_case()
    off = cp.predict(cp_batch) + pp.predict(batch)
    with profiling.recording():
        on = cp.predict(cp_batch) + pp.predict(batch)
    params = dict(pp.trunk.named_parameters())

    def grads():    # train mode: batch statistics, whatever the running
        total, _ = pp.loss(pp.apply_train(batch), batch)
        return torch.autograd.grad(total, list(params.values()))
    off += grads()
    with profiling.recording():
        on += grads()
    assert len(off) == 8 + len(params)
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    steps = []
    for recorded in (contextlib.nullcontext(), profiling.recording()):
        det, b = pp_case()
        state = det.init_train(1e-3, 100)
        with recorded:
            _state, m = det.train_step(b, state)
        steps.append((m, {k: v.detach().clone()
                          for k, v in det.trunk.named_parameters()}))
    (m0, p0), (m1, p1) = steps
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_exception_inside_a_span_closes_the_recording():
    with pytest.raises(ValueError):
        with profiling.recording() as rec:
            with profiling.span('train_step'):
                with profiling.span('forward'):
                    raise ValueError('in the forward')
    assert [(s.name, s.unit) for s in rec.spans] == [('train_step', 0),
                                                    ('forward', 0)]
    assert profiling.span('forward') is profiling.span('loss')
    with profiling.recording() as again:
        with profiling.span('predict'):
            pass
    assert again.units == 1


def test_export_under_a_recording_records_nothing(tmp_path):
    """``torch.export`` traces through a span as a no-op, recording or
    not: nothing is kept and the graph calls no profiler op."""
    from mmdet3d_gaussian_tpu_torch.engine.export import (export_predict,
                                                          load_exported)
    det, batch = pp_case()
    with profiling.recording() as rec:
        export_predict(det, batch, str(tmp_path))
    assert rec.spans == [] and rec.counts == {}
    graph = load_exported(str(tmp_path)).program.graph
    assert not [n for n in graph.nodes if 'profiler' in str(n.target)]
