"""Data-parallel training of PV-RCNN at a capacity that overflows, on 2
gloo ranks on the CPU (the checks of ``tests/test_torch_dist_families.py``,
in a file of its own to keep each file's time short).

``synthetic_batch`` at B = 4 with RPN and RoI positives
(``engine.pvrcnn.positive_batch``): the voxelize keeps every voxel, level
1 keeps 2,048 sites of samples 0 and 1, and rank 1 keeps no site from
level 1 on, so it runs those levels on all-invalid tables (a per-rank
capacity would keep 1,024 sites a rank).  The overflow metric is the
global count.  Against JAX, the gradients are held to 5e-4 of each
parameter's largest (JAX's own f32 error on its TINY step,
``tests/test_torch_pvrcnn.py``).
"""
import pytest
import torch

from . import torch_dist_families as fam

torch.set_num_threads(2)

NAME = 'pvrcnn'


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    return fam.make_job([NAME], tmp_path_factory.mktemp('dist_pvrcnn'))


@pytest.fixture(scope='module')
def one_process(job):
    return fam.one_process(job['steps'][NAME],
                           job['ranks'][0]['steps'][NAME])


def test_kept_sites_are_the_one_process_set(job, one_process):
    ranks = [r['steps'][NAME] for r in job['ranks']]
    assert fam.check_kept_sets(ranks, one_process)
    # calls: the voxelize, the three strided levels, the z conv; rank 1
    # keeps no site from level 1 on
    for s in range(2):
        calls = ranks[1]['kept'][s]
        assert len(calls) == 5
        assert len(calls[0]['kept']) > 0
        assert all(len(c['kept']) == 0 for c in calls[1:])
        assert one_process['kept'][s][1]['overflow'] > 0


def test_overflow_metric_is_global(job, one_process):
    want = [m['metric.sparse_overflow'] for m in one_process['metrics']]
    assert want[0] > 0
    for rank in job['ranks']:
        got = [m['metric.sparse_overflow']
               for m in rank['steps'][NAME]['metrics']]
        assert got == want


def test_step_matches_one_process(job, one_process):
    for rank in job['ranks']:
        fam.check_against_one_process(rank['steps'][NAME], one_process)


def test_step_matches_jax_sharded(job):
    fam.check_against_jax(NAME, job['ranks'][0]['steps'][NAME],
                          fam.jax_steps(NAME, job))


def test_ranks_end_bitwise_equal(job):
    fam.check_ranks_bitwise(job['ranks'], NAME)
