"""AdamW optimizer, train state and train step.

Port of ``mmdet3d_gaussian_tpu/parallel/train_state.py`` (``make_optimizer``
without the ``warmup`` masks and the flat-optimizer switch,
``make_train_step``, ``init_state``).  The JAX optimizer is the optax chain

    clip_by_global_norm(grad_clip) -> scale_by_adam(b1, b2, eps=1e-8)
    -> add_decayed_weights(weight_decay) -> scale_by_learning_rate(lr)

and :class:`AdamW` writes it out step by step with optax's arithmetic:
clipping scales by ``max_norm / ||g||`` only when ``||g|| >= max_norm`` (no
epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), the moments are
``(1 - b) g^k + b m``, the bias corrections use the update count starting
at 1, weight decay applies to every parameter, and the learning rate is the
schedule at the count starting at 0.  Parameters, gradients and moments are
dicts keyed by the model's parameter names.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.schedules import cyclic_schedule

Tensors = Dict[str, torch.Tensor]
EPS = 1e-8          # scale_by_adam's eps (eps_root 0)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a 0-d tensor on the tensors' device."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class OptState(NamedTuple):
    count: int        # updates applied so far
    mu: Tensors       # first moments
    nu: Tensors       # second moments


class AdamW:
    """The optax chain above.  ``lr_schedule`` and ``b1_schedule`` map the
    update count (0 for the first update) to a float; ``b1_schedule``
    replaces the constant b1 (cyclic momentum, optax ``inject_hyperparams``
    around ``scale_by_adam``)."""

    def __init__(self, lr_schedule: Callable[[int], float],
                 betas=(0.95, 0.99), weight_decay: float = 0.01,
                 grad_clip: float = 10.0,
                 b1_schedule: Optional[Callable[[int], float]] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.b1_schedule = b1_schedule
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip)

    def init(self, params: Tensors) -> OptState:
        zeros = {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for k, p in params.items()}
        return OptState(0, zeros, {k: torch.zeros_like(z)
                                   for k, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors,
               g_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Tensors, OptState]:
        """-> (updates to add to the parameters, new state).  ``g_norm``:
        the gradients' global norm, if the caller has it already."""
        b1 = (self.b1_schedule(state.count) if self.b1_schedule is not None
              else self.b1)
        b2 = self.b2
        count = state.count + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        step = -self.lr_schedule(state.count)
        if g_norm is None:
            g_norm = global_norm(grads.values())
        keep = g_norm < self.grad_clip
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            m = (1.0 - b1) * g + b1 * state.mu[k]
            v = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            u = (m / c1) / (torch.sqrt(v / c2) + EPS)
            updates[k] = step * (u + self.weight_decay * params[k])
            mu[k], nu[k] = m, v
        return updates, OptState(count, mu, nu)


def make_optimizer(base_lr: float, total_steps: int, betas=(0.95, 0.99),
                   weight_decay: float = 0.01, grad_clip: float = 10.0,
                   target_ratio=(10.0, 1e-4), step_ratio_up: float = 0.4,
                   momentum_target_ratio=None) -> AdamW:
    """AdamW with the cyclic one-cycle learning rate and, with
    ``momentum_target_ratio``, cyclic b1 over the same cycle."""
    lr = cyclic_schedule(base_lr, total_steps, target_ratio,
                         step_ratio_up=step_ratio_up)
    b1_sched = None
    if momentum_target_ratio is not None:
        b1_sched = cyclic_schedule(betas[0], total_steps,
                                   momentum_target_ratio,
                                   step_ratio_up=step_ratio_up)
    return AdamW(lr, betas=betas, weight_decay=weight_decay,
                 grad_clip=grad_clip, b1_schedule=b1_sched)


class TrainState(NamedTuple):
    step: int
    params: Tensors        # the model's parameters, updated in place
    batch_stats: Tensors   # its buffers (BatchNorm running statistics)
    opt_state: OptState


def init_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params,
                      batch_stats=dict(model.named_buffers()),
                      opt_state=optimizer.init(params))


def make_train_step(apply_fn: Callable, loss_fn: Callable,
                    optimizer: AdamW) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``apply_fn(batch) -> outputs`` runs the model that owns
    ``state.params`` in training mode (its BatchNorms update
    ``state.batch_stats`` in place); ``loss_fn(outputs, batch) -> (total,
    loss dict)``.  Metrics: each loss term, ``loss`` and ``grad_norm`` (of
    the unclipped gradients), as 0-d tensors on the device."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Tensors]:
        total, losses = loss_fn(apply_fn(batch), batch)
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        raw = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for k, p, g in zip(names, leaves, raw)}
        g_norm = global_norm(grads.values())
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params, g_norm)
        with torch.no_grad():
            for k in names:
                state.params[k].add_(updates[k])
        metrics = {k: torch.as_tensor(v).detach() for k, v in losses.items()}
        metrics['loss'] = total.detach()
        metrics['grad_norm'] = g_norm
        return state._replace(step=state.step + 1,
                              opt_state=opt_state), metrics

    return step
