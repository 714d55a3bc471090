"""AdamW of the configs (optax's chain): clip the gradients by their
global norm when it reaches ``grad_clip``, Adam moments with a cyclic
beta1, bias corrections counted from 1, decoupled weight decay on every
parameter, the one-cycle learning rate counted from 0."""
from __future__ import annotations

import math
from typing import Dict

import torch


def cyclic(base: float, total: int, ratio, up: float = 0.4):
    """mmcv's one-cycle policy: cosine from base to base * ratio[0] over
    the first ``up`` of the cycle, then cosine down to base * ratio[1]."""
    up_steps = int(total * up)

    def anneal(start, end, frac):
        return end + 0.5 * (start - end) * (1 + math.cos(math.pi * frac))

    def at(step: int) -> float:
        s = step % max(1, total)
        if s < up_steps:
            return anneal(base, base * ratio[0], s / max(up_steps, 1))
        return anneal(base * ratio[0], base * ratio[1],
                      (s - up_steps) / max(total - up_steps, 1))
    return at


class AdamW:
    def __init__(self, train_cfg: Dict):
        opt = train_cfg['optimizer']
        total = int(train_cfg['total_steps'])
        up = train_cfg['lr_config'].get('step_ratio_up', 0.4)
        self.lr = cyclic(opt['lr'], total, train_cfg['lr_config'][
            'target_ratio'], up)
        self.b1 = cyclic(opt['betas'][0], total,
                         train_cfg['momentum_config']['target_ratio'], up)
        self.b2 = opt['betas'][1]
        self.wd = opt['weight_decay']
        self.clip = train_cfg['grad_clip']
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def clipped(self, grads: Dict[str, torch.Tensor]):
        """The gradients as the update takes them (clipped)."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if float(norm) >= self.clip:
            return {k: g / norm * self.clip for k, g in grads.items()}
        return dict(grads)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]):
        """Update ``params`` in place; -> the clipped gradients."""
        g = self.clipped(grads)
        b1, b2 = self.b1(self.count), self.b2
        t = self.count + 1
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        lr = self.lr(self.count)
        for k, p in params.items():
            m = (1 - b1) * g[k] + b1 * self.mu.get(k, torch.zeros_like(p))
            v = (1 - b2) * g[k] * g[k] + b2 * self.nu.get(
                k, torch.zeros_like(p))
            self.mu[k], self.nu[k] = m, v
            p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8)
                          + self.wd * p))
        self.count = t
        return g
