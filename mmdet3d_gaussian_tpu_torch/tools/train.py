"""Training CLI of the port (``tools/train.py`` counterpart).

    python -m mmdet3d_gaussian_tpu_torch.tools.train CONFIG [--device cpu]
    torchrun --nproc_per_node N -m mmdet3d_gaussian_tpu_torch.tools.train \
        CONFIG --distributed

Loads a config (``--cfg-options`` nested overrides), builds the detector on
the card (``--device`` names another device; without a card and without
``--device cpu`` it raises) and runs ``engine.loop.run_training``:
checkpoints ``ckpt_{step}.pt`` and the JSON-lines log in ``--work-dir``.

``--distributed`` trains data parallel over the job torchrun started (the
reference's ``tools/dist_train.sh``): one rank a card over NCCL, or gloo
ranks on the CPU with ``--device cpu``; ``samples_per_gpu`` is the global
batch, split over the ranks (``engine/loop.py``), and the voxel and site
capacities are the global batch's.  Every family a config builds trains
so: PointPillars (hard, dynamic, MVF), CenterPoint and PV-RCNN.  In a job of more than
one process the CLI refuses to run without ``--distributed``: it would
train that many independent copies.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Train a 3D detector (PyTorch)')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None,
                   help='full train-state resume (or cfg resume_from)')
    p.add_argument('--load-from', default=None,
                   help='weights-only warm start (or cfg load_from)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-steps', type=int, default=None,
                   help='override total optimization steps')
    p.add_argument('--eval-interval', type=int, default=None,
                   help='epochs between val runs (default: cfg '
                        'evaluation.interval)')
    p.add_argument('--log-interval', type=int, default=None,
                   help='steps between log lines (default: cfg '
                        'log_config.interval)')
    p.add_argument('--profile-steps', type=int, nargs=2, default=None,
                   metavar=('START', 'STOP'),
                   help='write a torch.profiler trace of these steps to '
                        'WORK_DIR/profile')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='key=value nested config overrides')
    p.add_argument('--distributed', action='store_true',
                   help='data-parallel training over the ranks torchrun '
                        'started (NCCL on cards, gloo with --device cpu)')
    p.add_argument('--device', default=None,
                   help='torch device (default cuda)')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    world = int(os.environ.get('WORLD_SIZE', 1))
    if world > 1 and not args.distributed:
        raise RuntimeError(f'WORLD_SIZE={world}: a job of several processes '
                           f'trains with --distributed')
    from ..engine.loop import run_training
    from .common import build_detector, load_config

    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get('work_dir') or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    group, device = None, args.device
    if args.distributed:
        from ..parallel.mesh import init_distributed
        group = init_distributed(device=args.device)
        device = group.device
    det = build_detector(cfg, device, seed=args.seed, group=group)
    return run_training(det, cfg, work_dir, seed=args.seed,
                        max_steps=args.max_steps,
                        resume_from=args.resume_from,
                        load_from=args.load_from,
                        eval_interval=args.eval_interval,
                        log_interval=args.log_interval,
                        profile_steps=tuple(args.profile_steps)
                        if args.profile_steps else None)


if __name__ == '__main__':
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
