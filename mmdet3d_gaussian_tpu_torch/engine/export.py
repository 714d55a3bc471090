"""Serving export: the detector's predict as a ``torch.export`` program.

Port of ``mmdet3d_gaussian_tpu/engine/export.py``.  The artifact is an
exported program (``torch.export.export(..., strict=False)``) of a small
module that runs the trunk in eval mode and the head's decode, with the
trained weights and the anchors inside the program.  The port's kernels on
that path are registered ops (:mod:`..ops.library`), so the program calls
the hand-written CUDA kernels on the card and their plain versions on the
CPU, whichever device it was exported for.  A server loads it with
:func:`load_exported`, which imports torch and the op registrations only:
no model code, no config.

Bundle layout (a directory):
    predict.pt2   ``torch.export.save`` of the program (weights inside)
    meta.json     classes, device, the batch's shape contract, the
                  outputs, the torch version, the registered ops the
                  program calls and the TF32 switches it runs under
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..ops.library import ops_in_graph

__all__ = ['PredictModule', 'export_predict', 'load_exported']

PROGRAM = 'predict.pt2'
META = 'meta.json'


class PredictModule(nn.Module):
    """``det``'s predict as a module for ``torch.export``: its ``serve``
    (the trunk, then the head's decode; PV-RCNN's two stages and the
    refined boxes' NMS) with the trunk in eval mode and the anchors a
    buffer.  ``forward(batch)`` takes the batch dict (the entries the
    detector reads; others are ignored) and returns (boxes (B, M, 7+),
    scores (B, M), labels (B, M) int32, valid (B, M) bool), as
    ``det.predict``."""

    def __init__(self, det):
        super().__init__()
        self.det = det
        self.trunk = det.trunk
        anchors = getattr(det, 'anchors', None)
        if anchors is not None:
            self.register_buffer('anchors', anchors)
        else:
            self.anchors = None
        self.eval()

    def forward(self, batch: Dict[str, torch.Tensor]):
        return self.det.serve(batch, anchors=self.anchors)


def _spec(batch: Dict[str, torch.Tensor]) -> Dict[str, list]:
    return {k: [list(v.shape), str(v.dtype).replace('torch.', '')]
            for k, v in batch.items()}


def _tf32() -> Dict[str, bool]:
    """Whether f32 matmuls and cuDNN convolutions may round to TF32."""
    return dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def _math_mode(tf32: Optional[Dict[str, bool]]):
    """Run the body with the TF32 switches of ``tf32`` (None: as they
    are), then restore them."""
    if tf32 is None:
        yield
        return
    before = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = tf32['matmul']
    torch.backends.cudnn.allow_tf32 = tf32['cudnn']
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before['matmul']
        torch.backends.cudnn.allow_tf32 = before['cudnn']


def export_predict(det, example_batch: Dict[str, torch.Tensor],
                   out_dir: str, classes=(),
                   device: Optional[Union[str, torch.device]] = None) -> str:
    """Export ``det``'s predict on ``example_batch`` into ``out_dir``.

    Args:
        det: a detector engine (``PointPillarsDetector``,
            ``CenterPointDetector``, ``MVXDetector``, ``PVRCNNDetector``).
        example_batch: dict of tensors fixing the shape contract (entries
            that are not tensors must be removed by the caller); moved to
            the detector's device.
        out_dir: bundle directory (created).
        classes: class names for the meta.
        device: must be None or the detector's device (the program runs
            where its weights live).
    Returns the bundle path.
    """
    if device is not None and torch.device(device) != det.device:
        raise ValueError(f'the detector lives on {det.device}; build it on '
                         f'{device} to export for that device')
    batch = {k: v.to(det.device) for k, v in example_batch.items()}
    module = PredictModule(det)
    with torch.no_grad():
        program = torch.export.export(module, (batch,), strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    meta: Dict[str, Any] = dict(
        classes=list(classes),
        device=str(det.device),
        batch_spec=_spec(batch),
        outputs='boxes (B,K,7+), scores (B,K), labels (B,K), valid (B,K)',
        torch_version=torch.__version__,
        ops=ops_in_graph(program.graph),
        tf32=_tf32(),
    )
    with open(os.path.join(out_dir, META), 'w') as f:
        json.dump(meta, f, indent=1)
    return out_dir


class _Loaded:
    """Callable over a loaded bundle: ``served(batch)`` -> the predict's
    outputs (no autograd), under the TF32 switches the export ran with
    (``meta['tf32']``: an f32 program exported with TF32 off computes its
    convolutions in f32 whatever the server's defaults are); ``.meta``
    the bundle's meta, ``.program`` the ``ExportedProgram``."""

    def __init__(self, program, meta):
        self.program = program
        self.meta = meta
        self._module = program.module()

    def __call__(self, batch: Dict[str, torch.Tensor]):
        with torch.inference_mode(), _math_mode(self.meta.get('tf32')):
            return self._module(batch)


def load_exported(bundle_dir: str) -> _Loaded:
    """Load a bundle written by :func:`export_predict`.  This module
    imports the port's op registrations (the program calls them) and
    nothing of the model code or config."""
    program = torch.export.load(os.path.join(bundle_dir, PROGRAM))
    meta = {}
    path = os.path.join(bundle_dir, META)
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
    return _Loaded(program, meta)
