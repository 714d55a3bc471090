"""The weights of a cell, made from the seed on the device in a few large
calls: every convolution and linear weight lecun-normal (a normal draw
over the square root of its fan-in, flax's default and the port's
``init_weights``), BatchNorm identity (scale 1, shift 0, running mean 0,
variance 1), biases 0 except those the configuration's ``init`` names.

Names and shapes come from the reference model of the configuration
(``portbench/reference``), whose parameters follow the mmdet3d
state_dict; the program loads the same dict by name (strictly), so the
two sides start from identical weights."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _fan_in(m: nn.Module, w: torch.Tensor) -> int:
    if isinstance(m, nn.ConvTranspose2d):      # (in, out, k, k)
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def make(model: nn.Module, init: Dict, seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``'s names, drawn from ``seed`` on
    ``device``: one normal draw for all the weights, then fills."""
    mats = [(name, m) for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    total = sum(m.weight.numel() for _, m in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, m in mats:
        n = m.weight.numel()
        out[f'{name}.weight'] = (draw[at:at + n].view(m.weight.shape)
                                 / math.sqrt(_fan_in(m, m.weight)))
        at += n
        if m.bias is not None:
            out[f'{name}.bias'] = torch.zeros(m.bias.shape, device=device)
    for key, t in model.state_dict().items():
        if key in out:
            continue
        leaf = key.rsplit('.', 1)[-1]
        fill = {'weight': 1.0, 'running_var': 1.0}.get(leaf, 0.0)
        out[key] = torch.full(t.shape, fill, dtype=t.dtype, device=device)
    prior = init.get('anchor_cls_bias_prior')
    if prior is not None and 'bbox_head.conv_cls.bias' in out:
        out['bbox_head.conv_cls.bias'].fill_(-math.log((1 - prior) / prior))
    if 'heatmap_bias' in init:
        for key in out:
            if key.endswith('heatmap.1.bias'):
                out[key].fill_(float(init['heatmap_bias']))
    return out
