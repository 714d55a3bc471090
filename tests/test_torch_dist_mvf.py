"""Data-parallel training of MVF at a capacity that overflows, on 2 gloo
ranks on the CPU (the checks of ``tests/test_torch_dist_families.py``, in
a file of its own to keep each file's time short).

The TINY MVF PointPillars model (dense targets) runs at its config's own
``max_voxels``, the global batch's as in JAX, below the live pillars of
both views, with piles on rank 0's samples; each view keeps the
one-process set with its own rank offset.  Against JAX, the encoder's
gradients are its VJP run op by op at the jitted gradient of the pillar
features (ROADMAP section 3).
"""
import pytest
import torch

from . import torch_dist_families as fam

torch.set_num_threads(2)

NAME = 'mvf'


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    return fam.make_job([NAME], tmp_path_factory.mktemp('dist_mvf'))


@pytest.fixture(scope='module')
def one_process(job):
    return fam.one_process(job['steps'][NAME],
                           job['ranks'][0]['steps'][NAME])


def test_kept_voxels_of_both_views_are_the_one_process_set(job,
                                                           one_process):
    ranks = [r['steps'][NAME] for r in job['ranks']]
    assert fam.check_kept_sets(ranks, one_process)
    # both views overflow and truncate with their own offsets
    for s in range(2):
        assert len(one_process['kept'][s]) == 2
        assert all(c['overflow'] > 0 for c in one_process['kept'][s])


def test_step_matches_one_process(job, one_process):
    for rank in job['ranks']:
        fam.check_against_one_process(rank['steps'][NAME], one_process)


def test_step_matches_jax_sharded(job):
    fam.check_against_jax(NAME, job['ranks'][0]['steps'][NAME],
                          fam.jax_steps(NAME, job))


def test_ranks_end_bitwise_equal(job):
    fam.check_ranks_bitwise(job['ranks'], NAME)
