"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size, many seeds in one process:

    python3 -m portbench.calibrate --workload NAME --seeds 1 2 3 ... [--out F]
        [--controls K]

Each seed's pool is the cell's own, and the program is driven by the
loops' own calls (``checks.train.checked_steps``, ``loops.predict.answer``).
For each seed: the program's numbers against the reference (sound runs:
the lower readings), the control's (the reference computed with TF32 in
the program's place: the upper readings) and, for a training cell, the
reference on half of each batch (the fault "half of the batch left out,
the mean taken over the rest", planted in the reference); with
``--controls K``, the control and the faults on the first K seeds only.
A training cell of R > 1 cards runs its R ranks once for every seed
(``loops.train.checked_rank``, rank 0's readings), then the reference
on rank 0's card over the whole batches, and adds the fault "the
exchange between the cards left out": the reference on rank 0's rows
alone.  One JSON line a seed on standard output (and appended to
``--out``).  The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import configs, families, traffic, weights
from .checks import predict as pcheck
from .checks import train as tcheck
from .families.common import to_device
from .loops import common as c
from .loops.predict import answer, judged, predict, reference_answers
from .loops.train import checked_rank, train_step
from .ranks import run_ranks
from .run import load_bench

# the R-rank job's time for each seed
RANKS_SECONDS_A_SEED = 90


def train_references(fam, cfg, tf, seed, dev, prog, pool_np, faults,
                     world=1):
    """The reference's readings over the checked steps' whole batches on
    ``dev``, and with ``faults`` the control's and the faults': half of
    each batch, and on R > 1 ranks rank 0's rows alone."""
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], seed, dev)
    n = int(tf['checked_steps'])
    batches = [to_device(pool_np[i % len(pool_np)], dev) for i in range(n)]
    ref = tcheck.reference(fam, cfg, w0, batches, dev)
    out = dict(program=tcheck.numbers(prog, ref), losses=prog['losses'],
               left_out=tcheck.left_out(ref),
               program_details=tcheck.details(prog, ref))
    if not faults:
        return out
    planted = dict(
        control=tcheck.reference(fam, cfg, w0, batches, dev, lowp=True),
        half_batch=tcheck.reference(fam, cfg, w0, [
            {k: v[:v.shape[0] // 2] for k, v in b.items()}
            for b in batches], dev))
    if world > 1:
        planted['no_exchange'] = tcheck.reference(fam, cfg, w0, [
            {k: v[:v.shape[0] // world] for k, v in b.items()}
            for b in batches], dev)
    for key, got in planted.items():
        out[key] = tcheck.numbers(got, ref)
        out[f'{key}_details'] = tcheck.details(got, ref)
    return out


def train_seed(cfg, tf, seed, dev, faults=True):
    fam = families.get(cfg['family'])
    pool_np = traffic.make_pool(tf, seed)
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], seed, dev)
    det = fam.program(cfg, dev, w0)
    n = int(tf['checked_steps'])
    batches = [to_device(pool_np[i % len(pool_np)], dev) for i in range(n)]
    state, prog = tcheck.checked_steps(train_step, det, fam.init_train(
        det, cfg), batches, cfg, w0)
    del det, state, batches
    c.release(dev)
    return train_references(fam, cfg, tf, seed, dev, prog, pool_np, faults)


def _ranked_program(group, run, _first):
    """Every seed's checked steps on the job's ranks; -> on rank 0 each
    seed's (readings, pool)."""
    out = {}
    for seed in run.seeds:
        run.seed = seed
        pool_np = (traffic.make_pool(run.traffic, seed) if group.rank == 0
                   else None)
        pool_np, _w0, det, state, _pool, _step, prog = checked_rank(
            group, run, pool_np)
        del det, state, _pool, _w0
        c.release(group.device)
        out[seed] = (prog, pool_np)
    return out if group.rank == 0 else None


def ranked_train_seeds(cfg, tf, seeds, dev, world, controls):
    """Yield (seed, record) for a training cell of ``world`` ranks: the
    program's readings of every seed from one job, then the references
    on ``dev`` (rank 0's card) once every rank has ended."""
    run = c.Run(cfg=cfg, traffic=tf, seeds=list(seeds), device=dev,
                wrap=None, log=sys.stderr)
    # by the module's name, which the other ranks import
    from portbench import calibrate
    progs = run_ranks(world, calibrate._ranked_program, run,
                      RANKS_SECONDS_A_SEED * len(seeds))
    fam = families.get(cfg['family'])
    for i, seed in enumerate(seeds):
        prog, pool_np = progs[seed]
        yield seed, train_references(fam, cfg, tf, seed, dev, prog, pool_np,
                                     i < controls, world)


def predict_seed(cfg, tf, seed, dev, faults=True):
    fam = families.get(cfg['family'])
    pool_np = traffic.make_pool(tf, seed)
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], seed, dev)
    det = fam.program(cfg, dev, w0)
    answers = [(idx, answer(predict, det, to_device(b, dev)))
               for idx, b in enumerate(pool_np)]
    del det
    c.release(dev)
    failed, shaped = judged(answers, tf['frames'])
    used = range(len(pool_np))
    ref = reference_answers(fam, cfg, w0, pool_np, used, dev)
    kept = [int(a[3].sum()) for _, a in shaped]
    out = dict(program=pcheck.numbers(shaped, ref), kept=kept,
               failed=failed)
    if faults:
        ctl = reference_answers(fam, cfg, w0, pool_np, used, dev, lowp=True)
        control = [(idx, ctl[idx][0]) for idx in used]
        out['control'] = pcheck.numbers(control, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out')
    p.add_argument('--controls', type=int,
                   help='the control and the faults on the first K seeds '
                   '(default: every seed)')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    bench = load_bench()
    cell = next(w for w in bench['workloads'] if w['name'] == args.workload)
    cfg = configs.load(cell['config'])
    tf = traffic.load(cell['traffic'])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get('tf32', False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get('tf32', False))
    dev = torch.device('cuda', 0)
    controls = len(args.seeds) if args.controls is None else args.controls
    world = int(cell['chips'])
    if torch.cuda.device_count() < world:
        print(f'calibrate: the cell needs {world} CUDA cards', file=sys.stderr)
        return 2
    if world > 1:
        records = ranked_train_seeds(cfg, tf, args.seeds, dev, world,
                                     controls)
    else:
        fn = train_seed if tf['loop'] == 'train' else predict_seed
        records = ((seed, fn(cfg, tf, seed, dev, faults=i < controls))
                   for i, seed in enumerate(args.seeds))
    t = time.perf_counter()
    for seed, found in records:
        rec = dict(workload=args.workload, seed=seed, ranks=world,
                   card=torch.cuda.get_device_name(dev), **found)
        rec['seconds'] = time.perf_counter() - t
        t = time.perf_counter()
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
