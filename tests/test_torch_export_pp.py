"""The port's serving export of the TINY PointPillars predict, hard
(packed encoder, plain canvas) and dynamic (the s2d canvas): the bundle
of ``mmdet3d_gaussian_tpu_torch.engine.export`` against the JAX package's
``export_predict`` bundle with the same weights, on the example batch and
on a fresh one; the exported graph calls the port's registered ops; the
bundle serves in a fresh process that imports torch and the loader only.
"""
import pytest

from tests import torch_export_cases as cases

KINDS = ('hard', 'dynamic')
# the registered ops each exported graph must call
GRAPH_OPS = {
    'hard': ['mmdet3d_torch::bev_splat', 'mmdet3d_torch::nms_sweep',
             'mmdet3d_torch::rotated_iou'],
    'dynamic': ['mmdet3d_torch::bev_splat_pairs', 'mmdet3d_torch::nms_sweep',
                'mmdet3d_torch::rotated_iou',
                'mmdet3d_torch::segment_reduce',
                'mmdet3d_torch::segment_reduce_mapback'],
}


@pytest.fixture(scope='module', params=KINDS)
def case(request, tmp_path_factory):
    kind = request.param
    return kind, cases.run_case(kind, str(tmp_path_factory.mktemp(kind)))


def test_served_matches_jax_bundle(case):
    _, run = case
    for got, want in zip(run['port'], run['jax']):
        cases.assert_outputs_match(got, want)


def test_served_equals_eager_predict(case):
    _, run = case
    for got, want in zip(run['port'], run['eager']):
        for a, b in zip(got, want):
            assert (a == b).all()


def test_graph_calls_registered_ops(case):
    kind, run = case
    from mmdet3d_gaussian_tpu_torch.ops.library import ops_in_graph
    assert ops_in_graph(run['served'].program.graph) == GRAPH_OPS[kind]
    assert run['served'].meta['ops'] == GRAPH_OPS[kind]
    assert run['served'].meta['device'] == 'cpu'
    assert run['served'].meta['classes'] == ['Pedestrian', 'Cyclist', 'Car']


def test_bundle_serves_in_fresh_process(case, tmp_path):
    _, run = case
    outs, report = cases.serve_in_fresh_process(run['bundle'],
                                                run['batches'],
                                                str(tmp_path))
    cases.assert_serving_imports(report['modules'])
    for got, want in zip(outs, run['port']):
        for a, b in zip(got, want):
            assert (a == b).all()
