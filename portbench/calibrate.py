"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size, many seeds in one process:

    python3 -m portbench.calibrate --workload NAME --seeds 1 2 3 ... [--out F]

Each seed's pool is the cell's own, and the program is driven by the
loops' own calls (``checks.train.checked_steps``, ``loops.predict.answer``).
For each seed: the program's numbers against the reference (sound runs:
the lower readings), the control's (the reference computed with TF32 in
the program's place: the upper readings) and, for a training cell, the
reference on half of each batch (the fault "half of the batch left out,
the mean taken over the rest", planted in the reference).  One JSON line
a seed on standard output (and appended to ``--out``).  The benchmark's
own runs never run this."""
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
from .loops.train import train_step
from .run import load_bench


def train_seed(cfg, tf, seed, dev):
    fam = families.get(cfg['family'])
    pool_np = traffic.make_pool(tf, seed)
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], seed, dev)
    det = fam.program(cfg, dev, w0)
    n = int(tf['checked_steps'])
    batches = [to_device(pool_np[i % len(pool_np)], dev) for i in range(n)]
    state, prog = tcheck.checked_steps(train_step, det, fam.init_train(
        det, cfg), batches, cfg, w0)
    del det, state
    c.release(dev)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    ref = tcheck.reference(fam, cfg, w0, batches, dev)
    ctl = tcheck.reference(fam, cfg, w0, batches, dev, lowp=True)
    hb = tcheck.reference(fam, cfg, w0, half, dev)
    return dict(program=tcheck.numbers(prog, ref),
                control=tcheck.numbers(ctl, ref),
                half_batch=tcheck.numbers(hb, ref),
                losses=prog['losses'], left_out=tcheck.left_out(ref),
                program_details=tcheck.details(prog, ref),
                control_details=tcheck.details(ctl, ref),
                half_batch_details=tcheck.details(hb, ref))


def predict_seed(cfg, tf, seed, dev):
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
    ctl = reference_answers(fam, cfg, w0, pool_np, used, dev, lowp=True)
    control = [(idx, ctl[idx][0]) for idx in used]
    kept = [int(a[3].sum()) for _, a in shaped]
    return dict(program=pcheck.numbers(shaped, ref),
                control=pcheck.numbers(control, ref), kept=kept,
                failed=failed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out')
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
    fn = train_seed if tf['loop'] == 'train' else predict_seed
    for seed in args.seeds:
        t = time.perf_counter()
        rec = dict(workload=args.workload, seed=seed,
                   card=torch.cuda.get_device_name(dev),
                   **fn(cfg, tf, seed, dev))
        rec['seconds'] = time.perf_counter() - t
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
