"""The model families the configurations name (``"family"`` in a
configuration file): each module builds the program (the port's detector)
and the reference of a configuration, drives both the same way, and
counts a forward pass's FLOPs (``forward_flops(cfg, b, points_per_frame)``,
read by ``flops.step``)."""
from __future__ import annotations

import importlib


def get(name: str):
    return importlib.import_module(f'{__name__}.{name}')
