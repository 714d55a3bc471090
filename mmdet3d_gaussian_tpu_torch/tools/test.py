"""Inference and evaluation CLI of the port (``tools/test.py``
counterpart).

    python -m mmdet3d_gaussian_tpu_torch.tools.test CONFIG CKPT \
        [--metric kitti|cowa|waymo|nds|iou3d_err] [--bf16] [--device cpu]

Loads a config and a ``ckpt_{step}.pt`` (its weights), predicts over the
val split on the card (``--device`` names another device), turns the
padded detections into per-class arrays and calls ``dataset.evaluate``.
Prints the frame count and the predict and evaluate times, then the report
as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Test a 3D detector (PyTorch)')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--metric', default='kitti',
                   help="KITTI: 'kitti' = official Easy/Mod/Hard AP "
                        "(R11+R40), 'cowa' = the reference's flexible "
                        "metric; Waymo: 'waymo' = mAP / mAPH at LEVEL_1 "
                        "and LEVEL_2, 'cowa' = flexible IoU3D mAP by "
                        "range; nuScenes: 'nds' = centre-distance mAP, TP "
                        "errors and NDS, 'iou3d_err' = IoU3D-matched mAP "
                        "(mAIE; any name but 'nds' gives it, the default "
                        "too)")
    p.add_argument('--bf16', action='store_true',
                   help='predict with bf16 compute (compute_dtype)')
    p.add_argument('--out', default=None, help='dump results pkl')
    p.add_argument('--format-only', action='store_true',
                   help='dump/format results without evaluating (pair '
                        'with --out)')
    p.add_argument('--show-dir', default=None,
                   help='per-frame overlays (not ported yet)')
    p.add_argument('--show-score-thr', type=float, default=0.3)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help='torch device (default cuda)')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.show_dir:
        raise NotImplementedError('--show-dir needs the visualizer, which '
                                  'is not ported yet (ROADMAP section 1, '
                                  'item 8)')
    import torch
    from ..engine.loop import load_checkpoint, predict_split
    from .common import build_detector, load_config

    cfg = load_config(args.config, args.cfg_options)
    det = build_detector(cfg, args.device, model_overrides=dict(
        compute_dtype='bfloat16') if args.bf16 else None)
    if args.checkpoint:
        det.trunk.load_state_dict(load_checkpoint(args.checkpoint)
                                  ['state_dict'], strict=True)
    t0 = time.perf_counter()
    ds, results = predict_split(det, cfg, 'val')
    if det.device.type == 'cuda':
        torch.cuda.synchronize(det.device)
    predict_s = time.perf_counter() - t0
    print(f'frames {len(results)}, predict {predict_s:.3f} s '
          f'({len(results) / predict_s:.2f} frames/s)')
    if args.out:
        import pickle
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.format_only:
        print(f'formatted {len(results)} frames'
              + (f' -> {args.out}' if args.out else ''))
        return None
    t0 = time.perf_counter()
    report = ds.evaluate(results, metric=args.metric)
    print(f'evaluate {time.perf_counter() - t0:.3f} s')
    print(json.dumps({k: float(v) for k, v in report.items()}, indent=2))
    return report


if __name__ == '__main__':
    main()
