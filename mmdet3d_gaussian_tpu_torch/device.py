"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present: the port never falls back to the CPU by itself.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'on the CPU')
    return dev
