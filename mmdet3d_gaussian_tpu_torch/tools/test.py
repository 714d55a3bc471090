"""Inference and evaluation CLI of the port (``tools/test.py``
counterpart).

    python -m mmdet3d_gaussian_tpu_torch.tools.test CONFIG CKPT \
        [--metric kitti|cowa|waymo|nds|iou3d_err] [--bf16] [--device cpu]
        [--format-only --out r.pkl] [--show-dir DIR --show-score-thr T]

Loads a config and a ``ckpt_{step}.pt`` (its weights), predicts over the
val split on the card (``--device`` names another device; under torchrun,
``tools/dist_test.sh``, on rank 0 alone), turns the
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
                   help='write each frame\'s points and detections as '
                        '.obj files here')
    p.add_argument('--show-score-thr', type=float, default=0.3)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help='torch device (default cuda)')
    return p.parse_args(argv)


def show_frames(show_dir: str, score_thr: float):
    """``predict_split``'s ``on_batch`` for ``--show-dir``: each frame's
    live points and its valid detections scoring at least ``score_thr`` as
    ``.obj`` files under ``show_dir/frame{i:06d}``, for the dataset's
    frames (not the last batch's padding)."""
    import numpy as np
    from ..core.visualizer import show_result

    def on_batch(batch, outputs, first, count):
        boxes, scores, _, valid = outputs
        for i in range(count):
            sel = valid[i] & (scores[i] >= score_thr)
            pts = np.asarray(batch['points'][i])[
                np.asarray(batch['points_mask'][i])]
            show_result(pts, None, boxes[i][sel][:, :7], show_dir,
                        f'frame{first + i:06d}')
    return on_batch


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    import os
    if int(os.environ.get('RANK', 0)) > 0:
        # under torchrun (tools/dist_test.sh) rank 0 predicts and
        # evaluates on its card; the other ranks have nothing to do
        print(f'rank {os.environ["RANK"]}: the test CLI runs on rank 0')
        return None
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
    ds, results = predict_split(
        det, cfg, 'val', on_batch=show_frames(args.show_dir,
                                              args.show_score_thr)
        if args.show_dir else None)
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
