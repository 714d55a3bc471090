"""What the ranks of ``tests/test_torch_dist*.py`` run (no JAX here: the
ranks are spawned processes that import this module, not a test file).

:func:`spawn` starts ``world`` gloo ranks on the CPU that meet through a
``file://`` store (no TCP port to race for between test workers), with a
60 s timeout on every collective, and joins them within a hard limit:
past it the ranks are killed and the test fails.  Each rank runs
:func:`rank_main` on a plan: the BatchNorm checks on its rows
(:func:`bn_checks`), the offset checks (:func:`offset_checks`), the pillar
merges of point sharding on grids of its ranks (:func:`points_checks`),
the TINY train steps of any family on its rows of a global batch
(:func:`step_run`, with the voxels and sites each voxelization and sparse
level kept; the point-sharded detector on its part of a grid,
:func:`sharded_run`), the train CLI with ``--distributed`` on each config
of the plan, and saves what it got to ``rank{r}.pt``.
"""
import datetime
import multiprocessing
import os
import traceback

import numpy as np
import torch

DIST_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_LIMIT_S = 90.0
WORLD = 2
EPS = 1e-3


def spawn(plan, out_dir, world=WORLD, limit_s=JOIN_LIMIT_S):
    """Run :func:`rank_main` on ``world`` ranks; -> each rank's results.
    Raises if a rank fails or the job outlasts ``limit_s`` (its ranks are
    then killed)."""
    import time
    ctx = multiprocessing.get_context('spawn')
    store = os.path.join(out_dir, 'store')
    procs = [ctx.Process(target=rank_main, args=(r, world, store, out_dir,
                                                 plan))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    if alive:
        raise TimeoutError(f'{len(alive)} of {world} ranks still running '
                           f'after {limit_s} s: killed')
    errors = [open(os.path.join(out_dir, f'rank{r}.err')).read()
              for r in range(world)
              if os.path.exists(os.path.join(out_dir, f'rank{r}.err'))]
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        raise RuntimeError(f'ranks exited {codes}:\n' + '\n'.join(errors))
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]


def rank_main(rank, world, store, out_dir, plan):
    torch.set_num_threads(2)
    try:
        from mmdet3d_gaussian_tpu_torch.parallel.mesh import init_distributed
        group = init_distributed(backend='gloo',
                                 init_method='file://' + store,
                                 device='cpu', rank=rank, world_size=world,
                                 timeout=DIST_TIMEOUT)
        out = dict(rank=rank, world=group.world)
        if plan.get('bn', True):
            out['bn'] = bn_checks(bn_inputs(), group)
        if plan.get('offsets'):
            out['offsets'] = offset_checks(plan['offsets'], group)
        if plan.get('points'):
            out['points'] = points_checks(group)
        if 'sharded' in plan:
            out['sharded'] = sharded_run(plan['sharded'], group)
        out['steps'] = {name: step_run(case, group)
                        for name, case in plan.get('steps', {}).items()}
        if 'cli' in plan:
            out['cli'] = cli_run(plan['cli'], group)
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(f'rank {rank}:\n{traceback.format_exc()}')
        raise


# ---------------------------------------------------------------- BatchNorm
def bn_inputs():
    """The global rows of every BatchNorm check, from seed 0."""
    rng = np.random.RandomState(0)

    def normal(shape, mu=0.0, sd=1.0):
        return rng.normal(mu, sd, shape).astype(np.float32)
    mask = rng.rand(16, 6) < 0.7
    mask[10:] = False           # rank 1's pillars: 2 live slots in all
    mask[11, 0] = mask[13, 2] = True
    return dict(
        nchw=normal((4, 8, 3, 5), 0.5, 2.0), nchw_g=normal((4, 8, 3, 5)),
        mat=normal((40, 16), -1.0, 3.0), mat_g=normal((40, 16)),
        pfn=normal((16, 6, 12), 1.0, 2.0), pfn_g=normal((16, 6, 12)),
        pfn_mask=mask, pts=normal((50, 12), 0.0, 1.5),
        pts_g=normal((50, 12)),
        scale8=rng.uniform(0.5, 1.5, 8).astype(np.float32),
        bias8=normal(8, 0.0, 0.5),
        scale16=rng.uniform(0.5, 1.5, 16).astype(np.float32),
        bias16=normal(16, 0.0, 0.5),
        scale12=rng.uniform(0.5, 1.5, 12).astype(np.float32),
        bias12=normal(12, 0.0, 0.5),
        mean12=normal(12, 0.0, 0.3),
        var12=rng.uniform(0.5, 2.0, 12).astype(np.float32))


# rows of rank 0 of each check's input (rank 1 has the rest): the NCHW
# checks split the batch evenly, the others unevenly
SPLIT = dict(nchw=2, mat=25, pfn=10, pts=35)


def rows_of(name, group):
    """The slice of ``name``'s rows this rank holds (all without a
    group)."""
    if group is None:
        return slice(None)
    k = SPLIT[name]
    return slice(0, k) if group.rank == 0 else slice(k, None)


def bn_checks(inp, group):
    """Each BatchNorm on this rank's rows (all of them without a group):
    output, batch or running statistics, and the gradients of
    ``sum(y * g)`` for x, scale and bias (the parameters' this rank's
    share)."""
    from mmdet3d_gaussian_tpu_torch.models.backbones import BatchNorm2d
    from mmdet3d_gaussian_tpu_torch.models.voxel_encoders import \
        MaskedBatchNorm
    from mmdet3d_gaussian_tpu_torch.ops.bn import bn_train
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def grads(y, g, x, params):
        gx, *gp = torch.autograd.grad((y.float() * g).sum(), [x] + params)
        return dict(dx=gx, dscale=gp[0], dbias=gp[1])

    # bn_train (K4's plain version here) on channels-last NCHW and on an
    # (M, C) matrix
    for name, c, layout in (('nchw', 8, torch.channels_last),
                            ('mat', 16, None)):
        sl = rows_of(name, group)
        x = t(inp[name][sl])
        if layout is not None:
            x = x.contiguous(memory_format=layout)
        x.requires_grad_(True)
        scale = t(inp[f'scale{c}']).requires_grad_(True)
        bias = t(inp[f'bias{c}']).requires_grad_(True)
        y, mean, var = bn_train(x, scale, bias, EPS, None, group)
        out[f'bn_train_{name}'] = dict(
            y=y.detach(), mean=mean, var=var,
            **grads(y, t(inp[name + '_g'][sl]), x, [scale, bias]))

    # BatchNorm2d: f32, bf16 (output rounded to bf16) and bf16 promoted
    sl = rows_of('nchw', group)
    for name, dtype, promote in (('bn2d_f32', torch.float32, False),
                                 ('bn2d_bf16', torch.bfloat16, False),
                                 ('bn2d_bf16_promote', torch.bfloat16, True)):
        m = BatchNorm2d(8, eps=EPS, promote=promote)
        m.group = group
        with torch.no_grad():
            m.weight.copy_(t(inp['scale8']))
            m.bias.copy_(t(inp['bias8']))
        m.train()
        x = t(inp['nchw'][sl]).to(dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        y = m(x)
        out[name] = dict(y=y.detach(), running_mean=m.running_mean.clone(),
                         running_var=m.running_var.clone(),
                         **grads(y, t(inp['nchw_g'][sl]), x,
                                 [m.weight, m.bias]))

    # MaskedBatchNorm: pillars with a slot mask (rank 1 nearly empty) and
    # point rows without one
    for name, mask in (('masked_pfn', 'pfn_mask'), ('masked_pts', None)):
        base = 'pfn' if name == 'masked_pfn' else 'pts'
        sl = rows_of(base, group)
        m = MaskedBatchNorm(12, eps=EPS)
        m.group = group
        with torch.no_grad():
            m.weight.copy_(t(inp['scale12']))
            m.bias.copy_(t(inp['bias12']))
            m.running_mean.copy_(t(inp['mean12']))
            m.running_var.copy_(t(inp['var12']))
        m.train()
        x = t(inp[base][sl]).requires_grad_(True)
        y = m(x, None if mask is None else t(inp[mask][sl]))
        out[name] = dict(y=y.detach(), running_mean=m.running_mean.clone(),
                         running_var=m.running_var.clone(),
                         **grads(y, t(inp[base + '_g'][sl]), x,
                                 [m.weight, m.bias]))
    return out


# ------------------------------------------------------------------ offsets
def offset_checks(counts, group):
    """``mesh.rank_offset`` on each row of ``counts`` (one count a rank):
    -> [(before, total), ...] as ints."""
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import rank_offset
    out = []
    for row in counts:
        before, total = rank_offset(torch.tensor(row[group.rank],
                                                 dtype=torch.int32), group)
        assert before.dtype == total.dtype == torch.int64
        out.append((int(before), int(total)))
    return out


# --------------------------------------------------------------- train steps
# the modules that voxelize through build_scatter (the voxelize of every
# family, MVF's views, the strided sparse levels)
SCATTER_USERS = ('ops.voxelize', 'models.detectors.voxelnet',
                 'models.mvf_encoder', 'ops.sparse_conv', 'engine.pvrcnn')


def build_detector(case, group=None):
    """The TINY detector of ``case['family']`` (``'pointpillars'`` by
    default, which covers the hard, dynamic and MVF trunks;
    ``'centerpoint'``, ``'mvx'``, ``'pvrcnn'``; ``'sharded'``, the
    point-sharded detector, whose ``group`` is a ``mesh.PointMesh``) on
    the CPU."""
    from mmdet3d_gaussian_tpu_torch.engine import detector, mvx, pvrcnn
    if case.get('family') == 'sharded':
        if group is None:       # JAX's point_axis=None: one process
            return detector.ShardedPointPillarsDetector(
                case['model'], case['head'], point_axis=None, device='cpu')
        return detector.ShardedPointPillarsDetector(
            case['model'], case['head'], merge=case['merge'],
            mesh=group, bucket_capacity=case.get('capacity'),
            device='cpu')
    cls = dict(pointpillars=detector.PointPillarsDetector,
               centerpoint=detector.CenterPointDetector,
               mvx=mvx.MVXDetector, pvrcnn=pvrcnn.PVRCNNDetector)[
                   case.get('family', 'pointpillars')]
    return cls(case['model'], case['head'], device='cpu', group=group)


def kept_recorder(offset, active):
    """-> (records, wrap): ``wrap(build_scatter)`` records each call's
    kept voxel or site coords (batch column moved to the global sample
    index by ``offset``), this rank's live count, the capacity and the
    overflow into ``records[-1]`` while ``active[0]`` is set."""
    records = []

    def wrap(original):
        def build_scatter(coords, spatial_shape, max_voxels,
                          key_order=None, group=None):
            sc = original(coords, spatial_shape, max_voxels,
                          key_order=key_order, group=group)
            if active[0]:
                c = coords.to(torch.int32)
                live = torch.unique(c[(c >= 0).all(-1)], dim=0).shape[0]
                kept = sc.voxel_coords[sc.voxel_counts > 0].clone()
                kept[:, 0] += offset
                records[-1].append(dict(
                    kept=kept, live=live, capacity=max_voxels,
                    num_voxels=int(sc.num_voxels),
                    overflow=int(sc.num_overflow)))
            return sc
        return build_scatter
    return records, wrap


def step_run(case, group=None, steps=2, replay=None, start=None):
    """``steps`` TINY train steps of ``case``'s family
    (:func:`build_detector`) from the weights in ``case['weights']`` (or
    from ``start``, a state this function returned) on this rank's rows of
    the global batch in ``case['batch']`` (all of them without a group):
    each step's metrics, the summed gradients AdamW was given, the running
    statistics after each step, the state (parameters, buffers, AdamW's)
    after each step, the parameters after the last, each step's kept
    voxels and sites (:func:`kept_recorder`, in call order), and (under a
    group) each step's forward BatchNorms' summed statistics in call
    order: K4's (su, sq, count) and the masked (count, s1, s2).
    ``replay``: such statistics of as many steps, which then stand in for
    a one-process run's own (the masked sums keep their gradient), so that
    a bf16 run does not carry their other f32 summation order through
    every later bf16 rounding, nor an f32 run an activation at a ReLU's
    kink to its other side."""
    import importlib
    from mmdet3d_gaussian_tpu_torch.models import voxel_encoders
    from mmdet3d_gaussian_tpu_torch.ops import bn
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import (
        PointMesh, shard_batch, shard_points)
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import (
        OptState, make_optimizer)
    det = build_detector(case, group)
    det.trunk.load_state_dict(torch.load(case['weights'], weights_only=True),
                              strict=True)
    opt = make_optimizer(case['lr'], case['total_steps'])
    seen = []
    update = opt.update

    def recording(grads, *args, **kw):
        seen.append({k: g.clone() for k, g in grads.items()})
        return update(grads, *args, **kw)
    opt.update = recording

    sums = []
    forward = [False]
    apply_train = det.apply_train
    batch = torch.load(case['batch'], weights_only=True)
    offset = 0
    if isinstance(group, PointMesh):
        batch = shard_points(batch, group)
    elif group is not None:
        batch = shard_batch(batch, group)
        offset = group.rank * batch['points'].shape[0]
    kept, wrap = kept_recorder(offset, forward)

    def apply(batch):
        sums.append(dict(bn=[], masked=[]))
        kept.append([])
        forward[0] = True
        try:
            return apply_train(batch)
        finally:
            forward[0] = False
    det.apply_train = apply
    originals = dict(group_sums=bn._group_sums, batch_stats=bn.batch_stats,
                     all_reduce=voxel_encoders.all_reduce_with_grad,
                     masked_sums=voxel_encoders.masked_sums)

    def group_sums(*args):
        out = originals['group_sums'](*args)
        if forward[0]:
            sums[-1]['bn'].append(tuple(o.clone() for o in out))
        return out

    def all_reduce(x, grp):
        out = originals['all_reduce'](x, grp)
        sums[-1]['masked'].append(out.detach().clone())
        return out
    replayed = None if replay is None else dict(
        bn=iter([x for r in replay for x in r['bn']]),
        masked=iter([x for r in replay for x in r['masked']]))

    def batch_stats(x):
        su, sq, cnt = next(replayed['bn'])
        return bn._stats(su, sq, cnt)

    def masked_sums(flat, mask=None):
        out = originals['masked_sums'](flat, mask)
        c = out[1].shape[0]
        rec = next(replayed['masked'])
        card = (rec[0], rec[1:1 + c], rec[1 + c:])
        return tuple(o + (r - o).detach() for o, r in zip(out, card))
    if group is not None:
        bn._group_sums = group_sums
        voxel_encoders.all_reduce_with_grad = all_reduce
    if replay is not None:
        bn.batch_stats = batch_stats
        voxel_encoders.masked_sums = masked_sums
    users = [importlib.import_module('mmdet3d_gaussian_tpu_torch.' + m)
             for m in SCATTER_USERS]
    scatters = [u.build_scatter for u in users]
    for u, f in zip(users, scatters):
        u.build_scatter = wrap(f)
    try:
        state = det.init_train(optimizer=opt)
        if start is not None:
            det.trunk.load_state_dict(start['trunk'], strict=True)
            state = state._replace(step=start['step'], opt_state=OptState(
                start['count'], dict(start['mu']), dict(start['nu'])))
        metrics, stats, states = [], [], []
        for _ in range(steps):
            state, m = det.train_step(batch, state)
            metrics.append({k: float(v) for k, v in m.items()})
            stats.append({k: v.clone() for k, v in det.trunk.named_buffers()
                          if 'running_' in k})
            opt_state = state.opt_state
            states.append(dict(
                trunk={k: v.clone() for k, v in
                       det.trunk.state_dict().items()},
                step=state.step, count=opt_state.count,
                mu={k: v.clone() for k, v in opt_state.mu.items()},
                nu={k: v.clone() for k, v in opt_state.nu.items()}))
    finally:
        for u, f in zip(users, scatters):
            u.build_scatter = f
        bn._group_sums = originals['group_sums']
        bn.batch_stats = originals['batch_stats']
        voxel_encoders.all_reduce_with_grad = originals['all_reduce']
        voxel_encoders.masked_sums = originals['masked_sums']
    if replay is not None:
        assert next(replayed['bn'], None) is None
        assert next(replayed['masked'], None) is None
    return dict(metrics=metrics, grads=seen, stats=stats, sums=sums,
                states=states, kept=kept,
                params={k: v.detach().clone()
                        for k, v in det.trunk.named_parameters()})


# ----------------------------------------------------------- point sharding
# the pillar merges' canvas (tests/test_point_sharding.py's): 32 x 32 cells
PS_PC_RANGE = (0., -6.4, -3., 12.8, 6.4, 1.)
PS_VOXEL = (0.4, 0.4, 4.0)
PS_NX = PS_NY = 32
PS_GRIDS = ((1, 4), (2, 2))      # (data, points) grids of the 4 ranks
PS_OPS = ('sum', 'mean', 'max')
# bucket capacities: a stripe's every cell (none dropped), and 16, which
# the ~55 (4 stripes) or ~200 (2 stripes) live cells a rank and stripe
# overflow
PS_CAPS = (PS_NX * PS_NY, 16)
# the splat: B samples of N points with C features on PS_SPLAT_CELLS
# cells (several points a cell), a default capacity and one that
# overflows
PS_SPLAT = dict(b=4, n=256, c=3, cells=120)
PS_SPLAT_CAPS = (None, 8)


def ps_inputs():
    """The global inputs of every pillar-merge check, from seed 0: points
    and mask (``tests/test_point_sharding.py::make_points``), 64 points of
    one pillar, and the splat's features, cells, valid mask and the
    canvas gradient."""
    rng = np.random.RandomState(0)
    n = 1024
    pts = np.c_[rng.uniform(0, 12.8, (n, 1)), rng.uniform(-6.4, 6.4, (n, 1)),
                rng.uniform(-3, 1, (n, 1)), rng.rand(n, 1)].astype(np.float32)
    mask = rng.rand(n) > 0.1
    one = np.zeros((64, 4), np.float32)
    one[:, 0], one[:, 1], one[:, 3] = 5.03, -1.17, 1.0
    sp = PS_SPLAT
    cells = rng.choice(PS_NX * PS_NY, sp['cells'], replace=False)
    return dict(
        points=pts, mask=mask, one_pillar=one,
        feats=rng.normal(0, 1, (sp['b'], sp['n'], sp['c'])).astype(
            np.float32),
        lin=cells[rng.randint(0, sp['cells'], (sp['b'], sp['n']))].astype(
            np.int32),
        valid=rng.rand(sp['b'], sp['n']) > 0.2,
        grad=rng.normal(0, 1, (sp['b'], PS_NY, PS_NX, sp['c'] + 1)).astype(
            np.float32))


def _slice(n, group):
    """This rank's contiguous part of ``n`` rows over ``group``."""
    m = n // group.world
    return slice(group.rank * m, (group.rank + 1) * m)


def points_checks(world):
    """Each grid of :data:`PS_GRIDS` over the 4 ranks: the dense and
    sparse pillar reduces of each op on this rank's slice of the points
    over its points group (every capacity, ``replicate_out`` both ways),
    the one pillar split over the points group (sum), and the sparse
    feature splat of this rank's samples and slice with the gradient of
    ``sum(out * grad)`` (its rows of ``grad``: the stripe without
    ``replicate_out``).  -> {grid: {check: tensors}}."""
    from mmdet3d_gaussian_tpu_torch.parallel import point_sharding as ps
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import init_mesh
    inp = {k: torch.from_numpy(v) for k, v in ps_inputs().items()}
    geo = (PS_PC_RANGE, PS_VOXEL, PS_NX, PS_NY)
    out = {}
    for d, p in PS_GRIDS:
        mesh = init_mesh(d, p, world)
        grp = mesh.points
        res = out[(d, p)] = dict(mesh=(mesh.data.rank, mesh.points.rank))
        sl = _slice(inp['points'].shape[0], grp)
        pts, mask = inp['points'][sl], inp['mask'][sl]
        for op in PS_OPS:
            res['dense', op] = ps.sharded_pillar_reduce(pts, mask, *geo, grp,
                                                        op)
            for cap in PS_CAPS:
                for rep in (True, False):
                    res['sparse', op, cap, rep] = \
                        ps.sharded_pillar_reduce_sparse(
                            pts, mask, *geo, grp, op, bucket_capacity=cap,
                            replicate_out=rep)
        one = inp['one_pillar'][_slice(64, grp)]
        ones = torch.ones(one.shape[0], dtype=torch.bool)
        res['one_pillar', 'dense'] = ps.sharded_pillar_reduce(
            one, ones, *geo, grp, 'sum')
        res['one_pillar', 'sparse'] = ps.sharded_pillar_reduce_sparse(
            one, ones, *geo, grp, 'sum')
        rows = _slice(PS_SPLAT['b'], mesh.data)
        cols = _slice(PS_SPLAT['n'], grp)
        stripe = _slice(PS_NY, grp)
        for cap in PS_SPLAT_CAPS:
            for rep in (True, False):
                f = inp['feats'][rows, cols].clone().requires_grad_(True)
                o = ps.sharded_feature_splat_sparse(
                    f, inp['lin'][rows, cols], inp['valid'][rows, cols],
                    PS_NX, PS_NY, grp, bucket_capacity=cap,
                    replicate_out=rep)
                g = inp['grad'][rows] if rep else inp['grad'][rows, stripe]
                (o * g).sum().backward()
                res['splat', cap, rep] = (o.detach(), f.grad)
    return out


def sharded_run(plan, world):
    """The point-sharded detector's cases (``plan['cases']``,
    :func:`step_run` cases of family ``'sharded'``) on a ``plan['grid']``
    grid of the ranks: a predict on this rank's part of the batch and 2
    steps each; then, with the dense merge, one step
    whose merge's backward sums its gradient over the points group (the
    P-times regression), and :func:`~train_state.reduce_gradients` of one
    forward's gradients beside the grouped reduction (the trunk's by an
    all-reduce over the data group, the encoder's over the world)."""
    from mmdet3d_gaussian_tpu_torch.parallel import mesh as tmesh
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import \
        reduce_gradients
    mesh = tmesh.init_mesh(*plan['grid'], world)
    out = dict(mesh=(mesh.data.rank, mesh.points.rank), predict={})
    for name, case in plan['cases'].items():
        det = build_detector(case, mesh)
        det.trunk.load_state_dict(torch.load(case['weights'],
                                             weights_only=True))
        out['predict'][name] = det.predict(tmesh.shard_points(
            torch.load(case['batch'], weights_only=True), mesh))
        out[name] = step_run(case, mesh)
    dense = plan['cases']['dense']
    replicated = tmesh._AllReduceReplicated.backward
    tmesh._AllReduceReplicated.backward = tmesh._AllReduce.backward
    try:
        out['summing_backward'] = step_run(dense, mesh, steps=1)
    finally:
        tmesh._AllReduceReplicated.backward = replicated

    det = build_detector(dense, mesh)
    det.trunk.load_state_dict(torch.load(dense['weights'],
                                         weights_only=True))
    batch = tmesh.shard_points(torch.load(dense['batch'], weights_only=True),
                               mesh)
    total, _ = det.loss(det.apply_train(batch), batch)
    names, leaves = zip(*det.trunk.named_parameters())
    local = dict(zip(names, torch.autograd.grad(total, leaves)))
    got = reduce_gradients(local, mesh.world, det.replicas())
    trunk = sorted(det.replicas()[1])
    encoder = [k for k in names if k not in det.replicas()[1]]
    want = dict(zip(trunk, tmesh.all_reduce_sum([local[k] for k in trunk],
                                                mesh.data)))
    want.update(zip(encoder, tmesh.all_reduce_sum(
        [local[k] for k in encoder], mesh.world)))
    out['grouped'] = dict(got=got, want=want)
    out['trunk_names'] = trunk
    return out


# ------------------------------------------------------------------ the CLI
def cli_run(plan, group):
    """The train CLI with ``--distributed --device cpu`` on this group (it
    joins the job the rank is in) on each of ``plan['runs']``' (config,
    work dir) in turn, ``plan['steps']`` steps each."""
    from mmdet3d_gaussian_tpu_torch.tools import train
    for config, work_dir in plan['runs']:
        train.main([config, '--distributed', '--device', 'cpu',
                    '--work-dir', work_dir, '--max-steps',
                    str(plan['steps']), '--log-interval', '1'])
    return dict(world=group.world)
