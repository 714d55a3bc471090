"""Traffic mixes: ``traffic/<name>.json`` holds the parameters of one mix
(its loop, its generator and their sizes); :func:`load` reads it, and
:func:`make_pool` draws the mix's pool of distinct batches from a seed
with the generator module that the file names, ``traffic/<generator>.py``
(its ``make_batch(params, rng, sizes)``, and its ``MIXES`` where it has
any).  A new shape of traffic is a new mix file and, where no generator
draws it, a new generator module."""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict[str, Any]:
    """The parameters of traffic mix ``name`` (``traffic/<name>.json``)."""
    path = HERE / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no traffic mix {name!r} ({path})')
    return json.loads(path.read_text())


def generator(name: str):
    """The generator module ``traffic/<name>.py``."""
    return importlib.import_module(f'{__name__}.{name}')


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any non-negative int) and a stream
    id, so that each batch of the pool has its own independent draw."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def frame_sizes(traffic: Dict[str, Any], seed: int) -> List[Dict[str, Any]]:
    """The sizes of every frame of the pool: each range of the mix's
    ``spread`` spread evenly over the pool's frames (whole numbers where
    both ends are), and the generator's ``MIXES`` cycled, each list
    shuffled by the seed.  Every seed gets the same sizes in another
    order, so the seed changes the data and not the amount of work."""
    n = traffic['pool'] * traffic['frames']
    rng = rng_for(seed, 2 ** 20)
    out = [dict() for _ in range(n)]
    for key, (lo, hi) in traffic.get('spread', {}).items():
        vals = np.linspace(lo, hi, n)
        whole = isinstance(lo, int) and isinstance(hi, int)
        for frame, v in zip(out, rng.permutation(vals)):
            frame[key] = int(round(v)) if whole else float(v)
    mixes = getattr(generator(traffic['generator']), 'MIXES', None)
    if mixes:
        order = rng.permutation(n)
        for i, frame in zip(order, out):
            frame['mix'] = mixes[i % len(mixes)]
    return out


def make_pool(traffic: Dict[str, Any],
              seed: int) -> List[Dict[str, np.ndarray]]:
    """``traffic['pool']`` distinct batches from ``seed``, each a dict of
    numpy arrays (points (B, N, C) f32, points_mask (B, N) bool, gt_bboxes
    (B, G, D) f32, gt_labels (B, G) int32, gt_valid (B, G) bool), with the
    sizes of :func:`frame_sizes`."""
    make = generator(traffic['generator']).make_batch
    sizes = frame_sizes(traffic, seed)
    b = traffic['frames']
    return [make(traffic, rng_for(seed, i), sizes[i * b:(i + 1) * b])
            for i in range(traffic['pool'])]
