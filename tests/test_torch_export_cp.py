"""The port's serving export of the TINY CenterPoint predict (dynamic
pillars on the s2d canvas, the center head, rotated NMS) against the JAX
package's ``export_predict`` bundle with the same weights, on the example
batch and on a fresh one; the graph calls the port's registered ops; the
bundle serves in a fresh process that imports torch and the loader only.
"""
import pytest

from tests import torch_export_cases as cases

GRAPH_OPS = ['mmdet3d_torch::bev_splat_pairs', 'mmdet3d_torch::nms_sweep',
             'mmdet3d_torch::rotated_iou', 'mmdet3d_torch::segment_reduce',
             'mmdet3d_torch::segment_reduce_mapback']


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    return cases.run_case('centerpoint', str(tmp_path_factory.mktemp('cp')))


def test_served_matches_jax_bundle(run):
    for got, want in zip(run['port'], run['jax']):
        cases.assert_outputs_match(got, want)


def test_served_equals_eager_predict(run):
    for got, want in zip(run['port'], run['eager']):
        for a, b in zip(got, want):
            assert (a == b).all()


def test_graph_calls_registered_ops(run):
    from mmdet3d_gaussian_tpu_torch.ops.library import ops_in_graph
    assert ops_in_graph(run['served'].program.graph) == GRAPH_OPS
    assert run['served'].meta['ops'] == GRAPH_OPS


def test_bundle_serves_in_fresh_process(run, tmp_path):
    outs, report = cases.serve_in_fresh_process(run['bundle'],
                                                run['batches'],
                                                str(tmp_path))
    cases.assert_serving_imports(report['modules'])
    for got, want in zip(outs, run['port']):
        for a, b in zip(got, want):
            assert (a == b).all()
