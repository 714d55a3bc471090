"""Profile the PointPillars train step: the host batch's copy against a
device-resident batch, then a trace of N steps, summarized (the port's
counterpart of the JAX package's ``tools/misc/profile_train_step.py``).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.profile_train_step \
        [--voxelize hard|dynamic] [--bf16] [--batch 4] [--points 16384] \
        [--steps 8] [--out-dir DIR] [--device cuda|cpu]

1. ``train_step`` on a batch in host memory (each step copies it to the
   device) against the same batch already on the device, each timed by
   the chained slope of ``engine/timing.py::chain_time_state``.
2. ``engine/profiling.py::trace`` over ``--steps`` steps on the device
   batch, written to ``--out-dir/trace.json`` and summarized per step
   (``summarize_trace``).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model, batch and trace options that the profiling tools share."""
    p.add_argument('--voxelize', default='hard', choices=('hard', 'dynamic'))
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--points', type=int, default=16384)
    p.add_argument('--steps', type=int, default=8)
    p.add_argument('--top', type=int, default=30)
    p.add_argument('--out-dir', default='work_dirs/profile')
    p.add_argument('--device', default=None,
                   help='torch device (default cuda)')
    p.add_argument('--model-cfg', default=None,
                   help='JSON dict updating the KITTI 3-class model')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    add_model_args(p)
    return p.parse_args(argv)


def build(args, head_cfg=None):
    """(detector, host batch) of the command line."""
    import json
    from ...engine.detector import PointPillarsDetector, synthetic_batch
    mc = dict(voxelize_mode=args.voxelize)
    if args.bf16:
        mc['compute_dtype'] = 'bfloat16'
    mc.update(json.loads(args.model_cfg) if args.model_cfg else {})
    det = PointPillarsDetector(mc, head_cfg, device=args.device, seed=0)
    pcr = det.trunk.point_cloud_range
    batch = synthetic_batch(args.batch, args.points, 16, pc_range=pcr,
                            device='cpu')
    return det, batch


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from ...engine import profiling
    from ...engine.timing import chain_time_state
    from . import summarize_trace

    det, batch = build(args)
    state = det.init_train(1e-3, total_steps=1000)

    def step(state, batch):
        return det.train_step(batch, state)
    t_host, state = chain_time_state(step, state, batch)
    print(f'step (host batch, copied each step): {t_host * 1e3:.3f} ms',
          flush=True)
    dbatch = {k: v.to(det.device) for k, v in batch.items()}
    t_dev, state = chain_time_state(step, state, dbatch)
    print(f'step (device-resident batch):        {t_dev * 1e3:.3f} ms',
          flush=True)
    with profiling.trace(args.out_dir):
        for _ in range(args.steps):
            state, _ = det.train_step(dbatch, state)
    path = os.path.join(args.out_dir, profiling.TRACE_FILE)
    print(f'trace ({args.steps} steps) -> {path}', flush=True)
    summary = summarize_trace.main([path, '--steps', str(args.steps),
                                    '--top', str(args.top)])
    return dict(host_batch_s=t_host, device_batch_s=t_dev, summary=summary)


if __name__ == '__main__':
    main()
