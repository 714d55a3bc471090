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
                   model_overrides: Optional[Dict] = None, group=None):
    """The config's ``model`` and ``head`` dicts -> a ``PVRCNNDetector``
    (``type='PVRCNN'``, ``head`` its RPN head; f32 only, so a
    ``compute_dtype`` override is dropped), a ``CenterPointDetector``
    (``head_type='center'``) or else a ``PointPillarsDetector``, on
    ``device`` (``cuda`` unless given), data parallel over ``group`` (a
    ``parallel.mesh.Group``) if given."""
    from ..engine.detector import CenterPointDetector, PointPillarsDetector
    mcfg = dict(cfg.get('model') or {})
    mtype = mcfg.pop('type', None)
    mcfg.update(model_overrides or {})
    if mtype == 'PVRCNN':
        from ..engine.pvrcnn import PVRCNNDetector
        mcfg.pop('compute_dtype', None)
        return PVRCNNDetector(model_cfg=mcfg, rpn_head_cfg=cfg.get('head'),
                              device=device, seed=seed, group=group)
    cls = (CenterPointDetector if mcfg.get('head_type') == 'center'
           else PointPillarsDetector)
    return cls(model_cfg=mcfg, head_cfg=cfg.get('head'), device=device,
               seed=seed, group=group)
