"""What ``tests/test_torch_dist_families.py``,
``tests/test_torch_dist_mvf.py`` and ``tests/test_torch_dist_pvrcnn.py``
share: each family's TINY case on a global batch of 4 that overflows its
capacity unevenly over 2 ranks, the 2-rank job
(``tests/torch_dist_worker.py``), the port's one-process steps, JAX's step
jitted on a 2-device mesh with the batch sharded ``P('data')``, and the
checks.  Imports JAX: the spawned ranks never import it.

Every comparison is step by step from the same state: step 1 from the
weights JAX initialized (BatchNorm statistics, scales and biases redrawn),
step 2 from rank 0's state after step 1 (a random init's first AdamW step
moves every weight by about lr, so a gradient at its rounding carries into
the next step's weights at full size, and a PV-RCNN proposal can change
its rank).  JAX's step is its loss and gradients under ``value_and_grad``
and its new running statistics, at the port's state mapped back
(:func:`torch_to_jax`); the optimizer is held to optax elsewhere.

The gradients are taken from runs that share the 2-rank run's forward
BatchNorm sums: the one process replays them (``worker.step_run``'s
``replay``), JAX takes them through :func:`bn_replay`; the loss terms and
running statistics come from each side's own sums.  These TINY models'
f32 gradients jump where an activation sits within rounding of a ReLU's
kink: a small-variance channel's ``rsqrt`` amplifies the other summation
order of its batch sums and the activation falls on the kink's other side
(the port's own gwd5 CenterPoint gradient moves by 8.6e-4 of a leaf's
largest under 1e-7 relative weight noise; without the replay every seed
0-5 of its batch put some gradient 1e-4-5e-2 off JAX's).
"""
import contextlib

import numpy as np
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.engine import mvx as jmvx
from mmdet3d_gaussian_tpu.engine.pvrcnn import PVRCNNDetector as JPVRCNN
from mmdet3d_gaussian_tpu.models import mvf_encoder as jmvf
from mmdet3d_gaussian_tpu.models import voxel_encoders as jve
from mmdet3d_gaussian_tpu.ops.pallas import bn_kernel as jbn

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.engine import mvx as tmvx
from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import positive_batch
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from . import torch_dist_worker as worker
from .test_centerpoint import TINY_CP_HEAD, TINY_CP_MODEL
from .test_mvx_fusion import TINY_MVX, TINY_MVX_HEAD
from .test_pvrcnn import TINY_PVRCNN, TINY_RPN
from .test_torch_mvf import TINY_HEAD as MVF_HEAD, TINY_MVF
from .test_torch_train import TINY_HEAD, TINY_MODEL, _np_tree, randomize

B = 4                  # the global batch: 2 + 2 on the ranks
LR, TOTAL = 1e-3, 10
TOL_ONE = 1e-5         # against one process: the same sums in another order
TOL_JAX = 1e-4         # against JAX, as the families' TINY steps
# PV-RCNN's gradients: JAX's own f32 error on its TINY step against a
# float64 run is up to 3.4e-4 of a parameter's largest gradient
# (tests/test_torch_pvrcnn.py)
TOL_JAX_PV_GRAD = 5e-4
GWD = dict(type='GDLoss', loss_type='gwd3d', fun='log1p', tau=1.0,
           loss_weight=5.0)
MVX_IMG_HW = (36, 68)
PILE = (0.4, 0.4, 4.0)     # the TINY pillar size of every piled family


def piled(batch, pcr, voxel_size=PILE, seed=0):
    """``batch`` with ``crowded_batch``'s piles (12 pillars of 40 points a
    sample) on the first half of its samples, rank 0's: rank 0 then holds
    fewer live pillars than rank 1."""
    b, n = batch['points'].shape[:2]
    crowded = tdet.crowded_batch(b, n, batch['gt_bboxes'].shape[1],
                                 seed=seed, pc_range=pcr,
                                 voxel_size=voxel_size, device='cpu')
    out = dict(batch)
    out['points'] = batch['points'].clone()
    out['points'][:b // 2] = crowded['points'][:b // 2]
    return out


# -------------------------------------------------------------- the cases
# family -> (port family, JAX detector, model, head, neck strides of the
# converter); each capacity sits below the batch's live voxels, so that a
# per-rank capacity keeps another set (checked by the tests)
CP_HEAD = dict(TINY_CP_HEAD, yaw_mode=True, loss_gd=GWD)
MVF_MODEL = dict(TINY_MVF, encoder_cfg=dict(TINY_MVF['encoder_cfg'],
                                            max_voxels=1100))
CASES = {
    # the nuScenes CenterPoint's gwd5 head (CenterGDHead), dynamic pillars
    # on the s2d canvas; 1,033 + 1,815 live pillars against 2,400
    'centerpoint': ('centerpoint', jdet.CenterPointDetector,
                    dict(TINY_CP_MODEL, max_voxels_per_sample=600),
                    CP_HEAD, TINY_CP_MODEL['neck_cfg']['upsample_strides']),
    # the config's own max_voxels (the global batch's, as in JAX): view 0
    # 802 + 1,389 live pillars, view 1 555 + 652, against 1,100 each
    'mvf': ('pointpillars', jdet.PointPillarsDetector, MVF_MODEL,
            dict(MVF_HEAD, pos_cap=0),
            TINY_MVF['neck_cfg']['upsample_strides']),
    # f32; 864 + 1,301 live pillars against 1,800
    'mvx': ('mvx', jmvx.MVXDetector,
            dict(TINY_MVX, max_voxels_per_sample=450), TINY_MVX_HEAD,
            None),
    # synthetic_batch: the voxelize keeps all, level 1 keeps 2,048 sites of
    # samples 0 and 1 and none of samples 2 and 3 (rank 1) from there on
    'pvrcnn': ('pvrcnn', JPVRCNN, TINY_PVRCNN, TINY_RPN, None),
    # crowded_batch on all four samples: 1,038 + 1,048 live pillars
    # against 2,000, hard (packed encoder) and dynamic (s2d canvas)
    'hard': ('pointpillars', jdet.PointPillarsDetector,
             dict(TINY_MODEL, voxelize_mode='hard',
                  max_voxels_per_sample=500),
             dict(TINY_HEAD, pos_cap=1024), None),
    'dynamic': ('pointpillars', jdet.PointPillarsDetector,
                dict(TINY_MODEL, max_voxels_per_sample=500),
                dict(TINY_HEAD, pos_cap=1024), None),
    # the hard trunk's sorted encoder (hard_kept_rows on the sorted rows)
    'sorted': ('pointpillars', jdet.PointPillarsDetector,
               dict(TINY_MODEL, voxelize_mode='hard', hard_encoder='sorted',
                    max_voxels_per_sample=500),
               dict(TINY_HEAD, pos_cap=1024), None),
}


def port_batch(name, weights=None, seed=None):
    """The global batch of a case (torch, CPU)."""
    _, _, model, head, _ = CASES[name]
    pcr = model['point_cloud_range']
    seed = SEEDS[name] if seed is None else seed
    if name == 'mvx':
        return piled(tmvx.synthetic_mvx_batch(
            B, 1024, 8, img_hw=MVX_IMG_HW, seed=seed, pc_range=pcr,
            device='cpu'), pcr, seed=seed)
    if name == 'pvrcnn':
        # RPN and RoI positives from the detector's train-mode proposals
        det = worker.build_detector(dict(family='pvrcnn', model=model,
                                         head=head))
        det.trunk.load_state_dict(weights, strict=True)
        return positive_batch(det, tdet.synthetic_batch(
            B, 512, 4, seed=seed, pc_range=pcr, device='cpu'))
    if name in ('hard', 'dynamic', 'sorted'):
        return tdet.crowded_batch(B, 1024, 8, seed=seed, pc_range=pcr,
                                  device='cpu')
    return piled(tdet.synthetic_batch(B, 1024, 8, seed=seed, pc_range=pcr,
                                      device='cpu'), pcr, seed=seed)


# the batches' seeds.  MVF's is 1, the first of seeds 0-11 where both
# comparisons hold: with the BatchNorm sums replayed, seeds 0, 7 and 8
# still meet an activation at a ReLU's kink that the two packages'
# convolutions round to either side of (a backbone or neck weight's
# gradient 1e-2-2.6e-2 of its leaf's largest off JAX's; the port on one
# process and on two ranks agree there), and on seeds 3 and 11 one
# process and two ranks sum the cylindrical view's fuse-conv bias
# gradient, a cancelling sum, 1-2e-5 of its largest apart
SEEDS = dict(centerpoint=0, mvf=1, mvx=0, pvrcnn=0, hard=0, dynamic=0,
             sorted=0)


def jax_detector(name):
    _, cls, model, head, _ = CASES[name]
    if name == 'pvrcnn':
        return cls(model, head)
    return cls(model_cfg=model, head_cfg=head)


def jax_variables(name, batch):
    """JAX's initial variables of the case, BN statistics, scales and
    biases redrawn."""
    jd = jax_detector(name)
    init_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    v = _np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0), init_batch))
    return randomize(v, np.random.RandomState(0))


def to_torch(name, variables):
    return jax_variables_to_torch(variables, CASES[name][4])


def make_job(names, tmp):
    """The cases' weights and global batches, the 2-rank run of their
    steps (and of :data:`OFFSET_COUNTS`) and JAX's initial variables."""
    steps, variables = {}, {}
    for name in names:
        fam, _, model, head, _ = CASES[name]
        if name == 'pvrcnn':
            batch = tdet.synthetic_batch(B, 512, 4, seed=SEEDS[name],
                                         pc_range=model['point_cloud_range'],
                                         device='cpu')
        else:
            batch = port_batch(name)
        v = jax_variables(name, batch)
        sd = to_torch(name, v)
        if name == 'pvrcnn':
            batch = port_batch(name, sd)
        torch.save(sd, tmp / f'{name}_weights.pt')
        torch.save(batch, tmp / f'{name}_batch.pt')
        variables[name] = v
        steps[name] = dict(family=fam, model=model, head=head,
                           weights=str(tmp / f'{name}_weights.pt'),
                           batch=str(tmp / f'{name}_batch.pt'), lr=LR,
                           total_steps=TOTAL)
    ranks = worker.spawn(dict(bn=False, offsets=OFFSET_COUNTS, steps=steps),
                         str(tmp))
    return dict(tmp=tmp, ranks=ranks, steps=steps, variables=variables)


# rank_offset's inputs, one count a rank: a rank of count 0 first, last,
# and both
OFFSET_COUNTS = [[0, 5], [7, 0], [0, 0], [3, 4]]


def one_process(case, rank0):
    """The port's one-process steps on the whole batch: step 1 from the
    weights, step 2 from ``rank0``'s state after step 1.  The metrics,
    running statistics and kept sets come from steps on their own sums;
    the gradients from the same steps replaying ``rank0``'s forward
    BatchNorm sums (``worker.step_run``'s ``replay``, their gradient
    kept).  Otherwise the other f32 order of those sums moves an
    activation that sits at a ReLU's kink to its other side, and that
    element's gradient with it: in MVF's overflowing step a ``res3.bn1``
    output of -5.2e-7 on one process is +6.0e-8 on two ranks, and the
    gradient that the ReLU then passes or stops is 1.4 % of its leaf's
    largest, against 8.8e-7 relative upstream of it."""
    start = rank0['states'][0]
    plain = [worker.step_run(case, steps=1),
             worker.step_run(case, steps=1, start=start)]
    replayed = [worker.step_run(case, steps=1, replay=rank0['sums'][:1]),
                worker.step_run(case, steps=1, replay=rank0['sums'][1:],
                                start=start)]
    out = {k: plain[0][k] + plain[1][k] for k in ('metrics', 'stats', 'kept')}
    out['grads'] = replayed[0]['grads'] + replayed[1]['grads']
    return out


# ---------------------------------------------------------------- JAX side
def torch_to_jax(sd, like, strides=None):
    """The inverse of ``jax_variables_to_torch``: a port state_dict ->
    JAX variables shaped as ``like``.  Every map of the converter moves
    elements (transposes, flips, reshapes), so converting a tree of
    element indices says where each port element comes from."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    sizes = [int(np.size(x)) for x in leaves]
    total = sum(sizes)
    assert total < 2 ** 24      # indices exact in f32
    starts = np.cumsum([0] + sizes)
    index = treedef.unflatten([
        (np.arange(s, s + n, dtype=np.float32) + 1).reshape(np.shape(x))
        for s, n, x in zip(starts, sizes, leaves)])
    flat = np.full(total, np.nan, np.float32)
    for k, t in jax_variables_to_torch(index, strides).items():
        if k.endswith('num_batches_tracked'):
            continue
        ind = t.numpy().astype(np.int64).ravel() - 1
        flat[ind] = sd[k].detach().numpy().ravel()
    assert not np.isnan(flat).any()
    return treedef.unflatten([flat[s:s + n].reshape(np.shape(x))
                              for s, n, x in zip(starts, sizes, leaves)])


def bn_replay(sums, start=(0, 0), used=None):
    """A flax interceptor that makes every training BatchNorm of a JAX
    model (``FastBatchNorm``, ``MaskedBatchNorm``, ``nn.BatchNorm``) take
    its statistics from the port's forward sums of one step, ``sums``
    (``worker.step_run``'s: K4's (sum, sum of squares, count) a
    ``BatchNorm2d`` call, (count, sum, sum of squares) a masked one), in
    call order from ``start`` (bn, masked); its own sums keep their
    gradient (``own + stop_gradient(port - own)``), and its running
    statistics are its own.  ``used`` (a list) gets the (bn, masked)
    positions reached.  So the two packages' BatchNorm outputs differ only
    by their convolutions' f32 rounding, not by another order of the
    batch sums amplified by a small-variance channel's ``rsqrt``."""
    pos = list(start)

    def take(kind, c):
        rec = sums[kind][pos[kind == 'masked']]
        pos[kind == 'masked'] += 1
        if used is not None:
            used[:] = pos
        if kind == 'bn':
            su, sq, cnt = (np.asarray(t, np.float32) for t in rec)
        else:
            rec = np.asarray(rec, np.float32)
            cnt, su, sq = rec[0], rec[1:1 + c], rec[1 + c:]
        assert su.shape == (c,), (kind, su.shape, c)
        return su, sq, cnt

    def intercept(next_fun, args, kwargs, context):
        m = context.module
        kinds = (jbn.FastBatchNorm, jve.MaskedBatchNorm, fnn.BatchNorm)
        if context.method_name != '__call__' or not isinstance(m, kinds) \
                or m.is_initializing():
            return next_fun(*args, **kwargs)
        use_ra = fnn.merge_param(
            'use_running_average', m.use_running_average,
            kwargs.get('use_running_average', args[2] if isinstance(
                m, jve.MaskedBatchNorm) and len(args) > 2 else
                args[1] if not isinstance(m, jve.MaskedBatchNorm)
                and len(args) > 1 else None))
        out = next_fun(*args, **kwargs)      # its running statistics
        if use_ra:
            return out
        x = args[0]
        c = x.shape[-1]
        flat = x.astype(jnp.float32).reshape(-1, c)
        if isinstance(m, jve.MaskedBatchNorm):
            mask = args[1] if len(args) > 1 else kwargs.get('mask')
            wm = (jnp.ones((flat.shape[0], 1), jnp.float32) if mask is None
                  else mask.reshape(-1, 1).astype(jnp.float32))
            own = (jnp.sum(wm), jnp.sum(flat * wm, 0),
                   jnp.sum(flat * flat * wm, 0))
            su, sq, cnt = take('masked', c)
            port = (cnt, su, sq)
            cnt, s1, s2 = (o + jax.lax.stop_gradient(p - o)
                           for o, p in zip(own, port))
            cnt = jnp.maximum(cnt, 1.0)
        else:
            # FastBatchNorm's channel_fold: F copies of the C channels
            fold = getattr(m, 'channel_fold', 1)
            c //= fold
            own = (jnp.sum(flat, 0).reshape(fold, c).sum(0),
                   jnp.sum(flat * flat, 0).reshape(fold, c).sum(0))
            su, sq, cnt = take('bn', c)
            s1, s2 = (o + jax.lax.stop_gradient(p - o)
                      for o, p in zip(own, (su, sq)))
        mean = s1 / cnt
        var = jnp.maximum(s2 / cnt - mean * mean, 0.0)
        params = m.variables['params']
        inv = jax.lax.rsqrt(var + m.epsilon) * params['scale']
        fold = x.shape[-1] // c
        y = ((x.astype(jnp.float32) - jnp.tile(mean, fold))
             * jnp.tile(inv, fold) + jnp.tile(params['bias'], fold))
        return y.astype(out.dtype)
    return intercept


def _mesh_batch(batch):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    return jax.device_put({k: jnp.asarray(v.numpy()) for k, v in
                           batch.items()}, NamedSharding(mesh, P('data')))


def jax_step(name, variables, batch, sums=None):
    """JAX's step at ``variables`` on ``batch`` sharded ``P('data')`` over
    2 devices, jitted: -> (loss terms, gradients and new running
    statistics under port names).  MVF's encoder gradients are its VJP run
    op by op at the jitted gradient of the pillar features, as
    ``tests/test_torch_mvf.py::jax_step`` takes them (XLA on the CPU drops
    some of the unsorted segment max's gradient under jit, ROADMAP
    section 3).  ``sums``: the port's forward BatchNorm sums of the step,
    which every JAX BatchNorm then takes (:func:`bn_replay`)."""
    jd = jax_detector(name)
    strides = CASES[name][4]
    jb = _mesh_batch(batch)
    def replay(start=(0, 0), used=None):
        if sums is None:
            return contextlib.nullcontext()
        return fnn.intercept_methods(bn_replay(sums, start, used))
    if name == 'pvrcnn':
        stages = ('first', 'second')

        def f(params, b):
            vv = {s: {'params': params[s],
                      'batch_stats': variables[s]['batch_stats']}
                  for s in stages}
            outs, stats = jd.apply_train(vv, b)
            total, losses = jd.loss(outs, b)
            return total, (losses, stats)
        with replay():
            (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(
                f, has_aux=True))({s: variables[s]['params']
                                   for s in stages}, jb)
        state = jax_variables_to_torch({
            s: {'params': variables[s]['params'],
                'batch_stats': _np_tree(stats[s])} for s in stages})
        return ({k: float(x) for k, x in losses.items()},
                jax_grads_to_torch(_np_tree(grads)), state)

    def f(params, b):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']}, b)
        total, losses = jd.loss(outs, b)
        return total, (losses, stats)
    with replay():
        (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(variables['params'], jb)
    grads = _np_tree(grads)
    if name == 'mvf':
        grads['voxel_encoder'] = _mvf_encoder_grads(jd, variables, jb,
                                                    replay)
    state = jax_variables_to_torch({'params': variables['params'],
                                    'batch_stats': _np_tree(stats)},
                                   strides)
    return ({k: float(x) for k, x in losses.items()},
            jax_grads_to_torch(grads, strides), state)


def _mvf_encoder_grads(jd, v, jb, replay):
    """The MVF encoder's parameter gradients: its VJP op by op at the
    gradient of the loss at the pillar features, jitted on the sharded
    batch (the encoder intercepted there); ``replay(start, used)`` gives
    the BatchNorm replay from a position (the trunk's after the
    encoder's)."""
    points, mask = jb['points'], jb['points_mask']
    enc_cfg = dict(jd.model_cfg['encoder_cfg'])
    enc_cfg.setdefault('max_voxels', jd.model_cfg['max_voxels_per_sample']
                       * points.shape[0])
    enc = jmvf.PillarMVFFeatureNet(**enc_cfg)
    enc_stats = v['batch_stats']['voxel_encoder']

    def encode(params, used=None):
        with replay((0, 0), used) if used is not None else replay():
            return enc.apply({'params': params, 'batch_stats': enc_stats},
                             points, mask, train=True,
                             mutable=['batch_stats'])[0]
    used = [0, 0]
    # the forward's values jitted (no gradient through it)
    pillar, coords, grid = jax.jit(lambda p: encode(p, used))(
        v['params']['voxel_encoder'])
    grid = tuple(int(g) for g in grid)

    def after_encoder(pillar, b):
        def at_encoder(call, args, kwargs, context):
            if isinstance(context.module, jmvf.PillarMVFFeatureNet):
                return pillar, coords, grid
            return call(*args, **kwargs)
        with fnn.intercept_methods(at_encoder):
            outs, _ = jd.apply_train(v, b)
        return jd.loss(outs, b)[0]
    with replay(tuple(used)):
        g_pillar = jax.jit(jax.grad(after_encoder))(pillar, jb)
    _, vjp = jax.vjp(lambda p: encode(p)[0], v['params']['voxel_encoder'])
    return _np_tree(vjp(g_pillar)[0])


def jax_steps(name, job):
    """JAX's two steps, each at the port's state before it (step 1 at the
    initial variables, step 2 at rank 0's state after step 1) and on the
    2-rank run's forward BatchNorm sums of that step."""
    like = job['variables'][name]
    batch = torch.load(job['steps'][name]['batch'], weights_only=True)
    rank0 = job['ranks'][0]['steps'][name]
    after1 = rank0['states'][0]['trunk']
    return [jax_step(name, like, batch, rank0['sums'][0]),
            jax_step(name, torch_to_jax(after1, like, CASES[name][4]),
                     batch, rank0['sums'][1])]


# ------------------------------------------------------------------ checks
def close(got, want, tol, what):
    """Within ``tol`` of ``want``'s largest magnitude."""
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * scale, err_msg=what)


def check_against_one_process(got, want):
    """Each step's metrics (relative), gradients and running statistics
    (of each leaf's largest value) within :data:`TOL_ONE`."""
    for s in range(2):
        assert set(got['metrics'][s]) == set(want['metrics'][s])
        for k, w in want['metrics'][s].items():
            np.testing.assert_allclose(got['metrics'][s][k], w,
                                       rtol=TOL_ONE, err_msg=f'step {s} {k}')
        for k, w in want['grads'][s].items():
            close(got['grads'][s][k], w, TOL_ONE, f'step {s} grad {k}')
        for k, w in want['stats'][s].items():
            close(got['stats'][s][k], w, TOL_ONE, f'step {s} {k}')


def check_against_jax(name, got, want):
    """Each step's loss terms (relative), gradients and new running
    statistics (of each leaf's largest value) within :data:`TOL_JAX`
    (PV-RCNN's gradients within :data:`TOL_JAX_PV_GRAD`)."""
    grad_tol = TOL_JAX_PV_GRAD if name == 'pvrcnn' else TOL_JAX
    for s, (losses, grads, state) in enumerate(want):
        assert losses and set(losses) <= set(got['metrics'][s])
        for k, w in losses.items():
            np.testing.assert_allclose(got['metrics'][s][k], w,
                                       rtol=TOL_JAX, err_msg=f'step {s} {k}')
        assert set(grads) == set(got['grads'][s])
        for k, w in grads.items():
            close(got['grads'][s][k], w, grad_tol, f'step {s} grad {k}')
        keys = [k for k in state if 'running_' in k]
        assert keys
        for k in keys:
            close(got['stats'][s][k], state[k], TOL_JAX, f'step {s} {k}')


def kept_rows(t):
    """(n, 4) int coords -> their set as sorted unique rows."""
    return np.unique(t.numpy(), axis=0).reshape(-1, t.shape[1])


def check_kept_sets(ranks, want, world=2):
    """Every voxelization's and sparse level's kept coords over the ranks
    equal the one-process set, with the global overflow; -> the calls
    where a per-rank capacity (capacity / world a rank) would have kept
    another set."""
    differs = []
    for s, calls in enumerate(want['kept']):
        got = [r['kept'][s] for r in ranks]
        assert all(len(g) == len(calls) for g in got)
        for i, w in enumerate(calls):
            mine = [g[i] for g in got]
            union = kept_rows(torch.cat([m['kept'] for m in mine]))
            np.testing.assert_array_equal(union, kept_rows(w['kept']),
                                          err_msg=f'step {s} call {i}')
            assert len(union) == w['num_voxels'] == sum(
                m['num_voxels'] for m in mine)
            assert all(m['overflow'] == w['overflow'] for m in mine)
            assert all(m['capacity'] == w['capacity'] for m in mine)
            per_rank = [min(m['live'], w['capacity'] // world)
                        for m in mine]
            if per_rank != [len(m['kept']) for m in mine]:
                differs.append((s, i))
    return differs


def check_ranks_bitwise(ranks, name):
    a, b = (r['steps'][name] for r in ranks)
    for k in a['params']:
        assert torch.equal(a['params'][k], b['params'][k]), k
    for k in a['stats'][-1]:
        assert torch.equal(a['stats'][-1][k], b['stats'][-1][k]), k
    assert a['metrics'] == b['metrics']
