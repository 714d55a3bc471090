"""Dump a config's train pipeline output (points and GT boxes) as ``.obj``
files for a visual check (the port's counterpart of the JAX package's
``tools/misc/browse_dataset.py``; file dump instead of open3d).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.browse_dataset CONFIG \
        [--out-dir DIR] [--num 5] [--cfg-options k=v ...]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('--out-dir', default='work_dirs/browse')
    p.add_argument('--num', type=int, default=5)
    p.add_argument('--cfg-options', nargs='+', default=[])
    args = p.parse_args(argv)
    from ... import datasets  # noqa: F401  (registers the datasets)
    from ...core.visualizer import show_result
    from ...registry import DATASETS
    from ..common import load_config

    cfg = load_config(args.config, args.cfg_options)
    ds = DATASETS.build(dict(cfg.data['train']))
    paths = []
    for i in range(min(args.num, len(ds))):
        item = ds[i]
        if item is None:
            continue
        pts = item['points'][item['points_mask']]
        gts = item['gt_bboxes'][item['gt_valid']]
        paths.append(show_result(pts, gts, None, args.out_dir,
                                 f'frame{i:04d}'))
        print('wrote', paths[-1])
    return paths


if __name__ == '__main__':
    main()
