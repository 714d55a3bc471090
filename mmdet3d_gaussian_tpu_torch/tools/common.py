"""What the train and test CLIs share: config loading with
``--cfg-options`` and the detector a config builds."""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

from ..utils.config import Config


def load_config(path: str, cfg_options: Sequence[str] = ()) -> Config:
    """``Config.fromfile`` with ``key=value`` overrides (values parsed as
    JSON where they are JSON, else kept as strings)."""
    cfg = Config.fromfile(path)
    if cfg_options:
        opts = {}
        for kv in cfg_options:
            k, v = kv.split('=', 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            opts[k] = v
        cfg.merge_from_dict(opts)
    return cfg


def build_detector(cfg, device: Optional[str], seed: int = 0,
                   model_overrides: Optional[Dict] = None):
    """The config's ``model`` and ``head`` dicts -> a
    ``CenterPointDetector`` (``head_type='center'``) or else a
    ``PointPillarsDetector``, on ``device`` (``cuda`` unless given).
    PV-RCNN models raise until they are ported."""
    from ..engine.detector import CenterPointDetector, PointPillarsDetector
    mcfg = dict(cfg.get('model') or {})
    mtype = mcfg.pop('type', None)
    if mtype == 'PVRCNN':
        raise NotImplementedError('PV-RCNN is not ported yet (ROADMAP '
                                  'section 1, item 5)')
    mcfg.update(model_overrides or {})
    cls = (CenterPointDetector if mcfg.get('head_type') == 'center'
           else PointPillarsDetector)
    return cls(model_cfg=mcfg, head_cfg=cfg.get('head'), device=device,
               seed=seed)
