"""The loops the traffic files name (``"loop"``): ``train`` (train steps
back to back, one trainer) and ``predict`` (a closed loop, one client).
Each runs one cell once: set-up, the measured window, the traced
sub-window when asked, then the comparison with the reference."""
from __future__ import annotations

import importlib


def get(name: str):
    return importlib.import_module(f'{__name__}.{name}')
