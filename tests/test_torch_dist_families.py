"""Data-parallel training of CenterPoint, MVX and the PointPillars trunks
at a capacity that overflows, on 2 gloo ranks on the CPU.

One group of 2 ranks (``tests/torch_dist_worker.py``) runs 2 TINY train
steps of each case of ``tests/torch_dist_families.py`` on its rows of a
global batch of 4 (2 + 2) whose live voxels overflow the capacity
unevenly over the ranks: CenterPoint (the gwd5 head, dynamic pillars on
the s2d canvas) and MVX (f32) with piles on rank 0's samples, hard (the
packed and the sorted encoder) and dynamic PointPillars on
``crowded_batch``.  The
capacity is the global batch's, truncated in key order over the ranks as
the JAX package's sharded step (one program over the whole batch):

* the kept voxels of every voxelization equal the one-process set
  exactly, with the global overflow, where a per-rank capacity would keep
  another set;
* (a) against the port's one process on the 4 samples, step by step from
  the same state, at 1e-5 of each leaf's largest value (loss terms
  relative);
* (b) against JAX's step jitted with the batch on ``Mesh(jax.devices()
  [:2], ('data',))`` sharded ``P('data')``, at the port's state before
  each step, at 1e-4;
* the ranks end bitwise equal;
* ``mesh.rank_offset`` on counts with a rank of count 0.
"""
import pytest
import torch

from . import torch_dist_families as fam

torch.set_num_threads(2)

NAMES = ['centerpoint', 'mvx', 'hard', 'sorted', 'dynamic']


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    return fam.make_job(NAMES, tmp_path_factory.mktemp('dist_families'))


@pytest.fixture(scope='module')
def one_process(job):
    return {name: fam.one_process(job['steps'][name],
                                  job['ranks'][0]['steps'][name])
            for name in NAMES}


def test_rank_offset(job):
    for r, rank in enumerate(job['ranks']):
        want = [(sum(row[:r]), sum(row)) for row in fam.OFFSET_COUNTS]
        assert rank['offsets'] == want


@pytest.mark.parametrize('name', NAMES)
def test_kept_voxels_are_the_one_process_set(job, one_process, name):
    ranks = [r['steps'][name] for r in job['ranks']]
    differs = fam.check_kept_sets(ranks, one_process[name])
    # the batch overflows unevenly: a per-rank capacity keeps another set
    assert differs, name
    assert all(c['overflow'] > 0 for c in one_process[name]['kept'][0])


@pytest.mark.parametrize('name', NAMES)
def test_step_matches_one_process(job, one_process, name):
    for rank in job['ranks']:
        fam.check_against_one_process(rank['steps'][name],
                                      one_process[name])


@pytest.mark.parametrize('name', NAMES)
def test_step_matches_jax_sharded(job, name):
    fam.check_against_jax(name, job['ranks'][0]['steps'][name],
                          fam.jax_steps(name, job))


@pytest.mark.parametrize('name', NAMES)
def test_ranks_end_bitwise_equal(job, name):
    fam.check_ranks_bitwise(job['ranks'], name)


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_mvx_image_branch_batchnorms_are_synced(dtype):
    """``KITTI_MVX_MODEL``'s image branch: its 20 promoting BatchNorms take
    the group with the trunk's (``mesh.sync_batchnorms`` through
    ``set_group``), in f32 and in bf16, and so does the trunk's capacity."""
    from mmdet3d_gaussian_tpu_torch.engine.mvx import MVXDetector
    from mmdet3d_gaussian_tpu_torch.models.backbones import BatchNorm2d
    from mmdet3d_gaussian_tpu_torch.parallel import mesh
    det = MVXDetector(dict(compute_dtype=dtype), device='cpu')
    group = mesh.Group(rank=0, world=2, device=torch.device('cpu'))
    mesh.sync_batchnorms(det.trunk, group)
    image = [m for part in (det.trunk.img_backbone, det.trunk.img_neck)
             for m in part.modules() if isinstance(m, BatchNorm2d)]
    assert len(image) == 20
    assert all(m.promote and m.group is group for m in image)
    assert det.trunk.group is group
    mesh.sync_batchnorms(det.trunk, None)
    assert all(m.group is None for m in image) and det.trunk.group is None
