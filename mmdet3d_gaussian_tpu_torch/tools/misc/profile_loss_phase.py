"""Profile the loss alone: ``det.loss`` on precomputed head outputs, so
the trace holds only target assignment and loss arithmetic (the port's
counterpart of the JAX package's ``tools/misc/profile_loss_phase.py``).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.profile_loss_phase \
        [--voxelize hard|dynamic] [--bf16] [--dense] [--batch 4] \
        [--points 16384] [--steps 8] [--out-dir DIR] [--device cuda|cpu]

Times the loss forward and the loss forward + backward to the head
outputs (``engine/profiling.py::timeit``, the chained slope), then traces
``--steps`` loss calls and summarizes the trace.  ``--dense`` takes dense
targets (``pos_cap=0``: the decoded-box GD loss through K3).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .profile_train_step import add_model_args, build


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    add_model_args(p)
    p.add_argument('--dense', action='store_true',
                   help='dense targets (pos_cap=0; the GD loss through K3)')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    import torch
    from ...engine import profiling
    from . import summarize_trace

    det, batch = build(args, dict(pos_cap=0) if args.dense else None)
    batch = {k: v.to(det.device) for k, v in batch.items()}
    outs = [o.detach() if isinstance(o, torch.Tensor) else o
            for o in det.apply_train(batch)]

    def loss_only(outs, batch):
        with torch.no_grad():
            return det.loss(outs, batch)[0]

    def loss_grad(outs, batch):
        leaves = [o.detach().requires_grad_(o.is_floating_point())
                  if isinstance(o, torch.Tensor) else o for o in outs]
        total = det.loss(leaves, batch)[0]
        grads = torch.autograd.grad(total, [
            o for o in leaves
            if isinstance(o, torch.Tensor) and o.requires_grad],
            allow_unused=True)
        return [g for g in grads if g is not None]

    fwd = profiling.timeit(loss_only, outs, batch, iters=args.steps)
    print(f'loss fwd only: {fwd * 1e3:.3f} ms', flush=True)
    both = profiling.timeit(loss_grad, outs, batch, iters=args.steps)
    print(f'loss fwd+bwd(outputs): {both * 1e3:.3f} ms', flush=True)
    with profiling.trace(args.out_dir):
        for _ in range(args.steps):
            loss_only(outs, batch)
    path = os.path.join(args.out_dir, profiling.TRACE_FILE)
    print('trace ->', path, flush=True)
    summary = summarize_trace.main([path, '--steps', str(args.steps),
                                    '--top', str(args.top)])
    return dict(loss_s=fwd, loss_grad_s=both, summary=summary)


if __name__ == '__main__':
    main()
