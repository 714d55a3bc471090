"""Export a trained detector's predict as a serving bundle (the port's
``tools/export.py``; see ``engine/export.py``).

    python -m mmdet3d_gaussian_tpu_torch.tools.export CONFIG [CHECKPOINT] \
        --out-dir DIR [--device cuda|cpu] [--bf16] [--cfg-options k=v ...]

Builds the detector the config names (``tools/common.py::build_detector``,
seeded init), restores ``CHECKPOINT``'s weights if given, takes the first
batch of the config's val split (train if it has none) as the shape
contract, and writes ``predict.pt2`` and ``meta.json``.  The program runs
on the device it was exported on (``cuda`` unless ``--device`` names
another); a server loads it with ``engine.export.load_exported``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Export a 3D detector predict '
                                            '(PyTorch)')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-dir', required=True)
    p.add_argument('--device', default=None,
                   help='torch device (default cuda)')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute (compute_dtype)')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    from ..engine.export import export_predict
    from ..engine.loop import build_dataloader, load_checkpoint, to_device
    from .common import build_detector, load_config

    cfg = load_config(args.config, args.cfg_options)
    det = build_detector(cfg, args.device, model_overrides=dict(
        compute_dtype='bfloat16') if args.bf16 else None)
    if args.checkpoint:
        det.trunk.load_state_dict(load_checkpoint(args.checkpoint)
                                  ['state_dict'], strict=True)
    split = 'val' if cfg.get('data', {}).get('val') else 'train'
    ds, make_iter = build_dataloader(cfg, split)
    batches = make_iter(0)
    first = next(batches)
    batches.close()
    path = export_predict(det, to_device(first, det.device), args.out_dir,
                          classes=getattr(ds, 'CLASSES', ()))
    print('exported ->', path)
    return path


if __name__ == '__main__':
    main()
