"""The predict path's kernels as registered PyTorch ops.

Importing this module registers them (each is defined beside its wrapper,
under the namespace ``mmdet3d_torch``): K1's reduce and mapback forms
(:mod:`.segment`), the K2 and K7 splats (:mod:`.voxelize`), K5
(:mod:`.rotated_iou`) and K6, pack and sweep as one op (:mod:`.nms`).
Each has a CPU implementation (the plain version), a CUDA one (the hand
kernel through ``_cuda.launch``, which counts the launch) and a fake one
(shape and dtype only, for tracing); the public wrappers call them, so
eager code and an exported program take one path.  K1's winner form, K3
and K4 run on the train path only and stay plain functions.
"""
from __future__ import annotations

from typing import List

import torch

from . import nms, rotated_iou, segment, voxelize  # noqa: F401  (registers)
from ._cuda import OP_NAMESPACE

# the registered ops; each is named as the kernel (``_cuda.KERNELS`` key)
# its CUDA implementation launches
OPS = ('segment_reduce', 'segment_reduce_mapback', 'bev_splat',
       'bev_splat_pairs', 'rotated_iou', 'nms_sweep')


def op(name: str) -> torch._ops.OpOverload:
    """The registered op ``name`` (one of :data:`OPS`)."""
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default


def ops_in_graph(graph: torch.fx.Graph) -> List[str]:
    """Sorted qualified names (``mmdet3d_torch::bev_splat``) of the port's
    ops that ``graph``'s nodes call."""
    found = set()
    for node in graph.nodes:
        target = node.target
        if node.op == 'call_function' and isinstance(
                target, torch._ops.OpOverload) \
                and target.namespace == OP_NAMESPACE:
            found.add(target._schema.name)
    return sorted(found)
