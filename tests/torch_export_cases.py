"""Shared by the port's export tests: one TINY detector of each family
exported by the JAX package's ``export_predict`` and by the port's, with
the same weights (JAX's init, BatchNorm statistics, scales and biases
redrawn, carried over by ``jax_variables_to_torch``), served on the
example batch and on a fresh one (seed 7).  Imports JAX; not a test file.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# served outputs against JAX's bundle: boxes and scores as
# tests/test_export.py holds JAX's bundle to its predict; labels and valid
# exactly equal
RTOL = ATOL = 1e-5

# what a fresh process that loads a bundle may import of the port: the
# package, the loader and the op registrations
SERVE_MODULES = ('mmdet3d_gaussian_tpu_torch',
                 'mmdet3d_gaussian_tpu_torch.engine',
                 'mmdet3d_gaussian_tpu_torch.engine.export')
SERVE_PREFIX = 'mmdet3d_gaussian_tpu_torch.ops'

SERVE_SCRIPT = r'''
import json, sys
import torch
from mmdet3d_gaussian_tpu_torch.engine.export import load_exported
bundle, inputs, out = sys.argv[1:4]
served = load_exported(bundle)
outs = [[t.cpu() for t in served(batch)]
        for batch in torch.load(inputs, weights_only=True)]
torch.save(outs, out)
print(json.dumps(dict(
    meta=served.meta,
    modules=sorted(m for m in sys.modules if m.split('.')[0] in (
        'jax', 'jaxlib', 'mmdet3d_gaussian_tpu',
        'mmdet3d_gaussian_tpu_torch')))))
'''


def randomize(tree, rng):
    """Redraw BN running statistics, scales and biases (the cls bias loses
    its focal prior, so scores spread over the score threshold)."""
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


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def build(kind):
    """-> (JAX detector, JAX variables, port detector with the same
    weights, [batch, fresh batch] as numpy dicts)."""
    from mmdet3d_gaussian_tpu.engine import detector as jdet
    from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
    from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch
    from tests.test_torch_predict import TINY_HEAD, TINY_MODEL
    if kind == 'pvrcnn':
        return _build_pvrcnn()
    if kind == 'centerpoint':
        from tests.test_centerpoint import TINY_CP_HEAD, TINY_CP_MODEL
        model, head = TINY_CP_MODEL, TINY_CP_HEAD
        jcls, tcls = jdet.CenterPointDetector, tdet.CenterPointDetector
        strides = model['neck_cfg']['upsample_strides']
    else:
        model = dict(TINY_MODEL, voxelize_mode=kind)
        head = TINY_HEAD
        jcls, tcls = jdet.PointPillarsDetector, tdet.PointPillarsDetector
        strides = None
    pcr = model['point_cloud_range']
    batches = [{k: np.array(v) for k, v in jdet.synthetic_batch(
        batch_size=2, num_points=1024, num_gt=8, pc_range=pcr,
        seed=seed).items()} for seed in (0, 7)]
    jd = jcls(model_cfg=model, head_cfg=head)
    variables = randomize(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                           batches[0]),
                          np.random.RandomState(0))
    td = tcls(model, head, device='cpu')
    sd = (jax_variables_to_torch(variables) if strides is None
          else jax_variables_to_torch(variables, strides))
    td.trunk.load_state_dict(sd, strict=True)
    return jd, variables, td, batches


def _build_pvrcnn():
    """The TINY PV-RCNN of ``tests/test_torch_pvrcnn.py`` (JAX's init on
    its batch, BatchNorm statistics, scales and biases redrawn by
    ``tests/test_torch_sparse_conv.py::randomize``) on batches with RPN
    and RoI positives."""
    from mmdet3d_gaussian_tpu.engine import detector as jdet
    from mmdet3d_gaussian_tpu.engine.pvrcnn import PVRCNNDetector as JDet
    from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch
    from tests.test_torch_pvrcnn import B, G, N, PCR, tdet_tiny, tiny_batch
    from tests.test_torch_sparse_conv import randomize as pv_randomize
    from tests.test_pvrcnn import TINY_PVRCNN, TINY_RPN
    jd = JDet(TINY_PVRCNN, TINY_RPN)
    jb0 = jdet.synthetic_batch(batch_size=B, num_points=N, num_gt=G,
                               pc_range=PCR)
    variables = pv_randomize(jax.tree_util.tree_map(
        np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(0), jb0)),
        np.random.RandomState(0))
    td = tdet_tiny()
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    batches = [{k: t.numpy() for k, t in tiny_batch(td, seed).items()}
               for seed in (0, 7)]
    return jd, variables, td, batches


def run_case(kind, root):
    """Export ``kind`` both ways under ``root`` and serve both bundles on
    the two batches -> dict(port=..., jax=..., eager=..., bundle=...,
    program=..., batches=...)."""
    from mmdet3d_gaussian_tpu.engine import export as jexp
    from mmdet3d_gaussian_tpu_torch.engine import export as texp
    jd, variables, td, batches = build(kind)
    jbundle = jexp.export_predict(jd, variables, batches[0],
                                  os.path.join(root, 'jax'))
    jserved = jexp.load_exported(jbundle)
    tbundle = texp.export_predict(td, to_torch(batches[0]),
                                  os.path.join(root, 'port'),
                                  classes=('Pedestrian', 'Cyclist', 'Car'))
    tserved = texp.load_exported(tbundle)
    tb = [to_torch(b) for b in batches]
    return dict(
        jax=[[np.asarray(x) for x in jserved(b)] for b in batches],
        port=[[x.numpy() for x in tserved(b)] for b in tb],
        eager=[[x.numpy() for x in td.predict(b)] for b in tb],
        bundle=tbundle, served=tserved, batches=tb)


def assert_outputs_match(got, want):
    """(boxes, scores, labels, valid): floats within RTOL / ATOL, integers
    and masks equal."""
    assert int(want[3].sum()) > 0, 'no valid detection to compare'
    for a, b, name in zip(got[:2], want[:2], ('boxes', 'scores')):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    for a, b, name in zip(got[2:], want[2:], ('labels', 'valid')):
        np.testing.assert_array_equal(a, b, err_msg=name)


def serve_in_fresh_process(bundle, batches, tmp):
    """Load ``bundle`` in a new python that imports torch and the loader
    only, serve ``batches`` -> (outputs as numpy, the process's report:
    meta and the imported modules of JAX and of both packages)."""
    inputs = os.path.join(tmp, 'inputs.pt')
    out = os.path.join(tmp, 'served.pt')
    torch.save(batches, inputs)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', SERVE_SCRIPT, bundle, inputs,
                        out], capture_output=True, text=True, env=env,
                       cwd=tmp, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    outs = [[t.numpy() for t in o] for o in torch.load(out,
                                                       weights_only=True)]
    return outs, report


def assert_serving_imports(modules):
    """Nothing of JAX or the JAX package, and of the port only the loader
    and the op registrations."""
    for m in modules:
        assert m in SERVE_MODULES or m.startswith(SERVE_PREFIX + '.') \
            or m == SERVE_PREFIX, f'serving imported {m}'
