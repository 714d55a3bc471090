"""AdamW optimizer, train state and train step.

Port of ``mmdet3d_gaussian_tpu/parallel/train_state.py`` (``make_optimizer``
with its ``warmup`` masks and ``lr_schedule``, ``make_lr_schedule_from_cfg``,
``make_optimizer_from_cfg``, ``make_train_step``, ``init_state``; not the
flat-optimizer switch, a measured negative on the TPU).  The JAX optimizer
is the optax chain

    clip_by_global_norm(grad_clip) -> scale_by_adam(b1, b2, eps=1e-8)
    -> add_decayed_weights(weight_decay) -> scale_by_learning_rate(lr)
    [-> masked scale_by_schedule(weight warmup), masked
       scale_by_schedule(bias warmup)]

and :class:`AdamW` writes it out step by step with optax's arithmetic:
clipping scales by ``max_norm / ||g||`` only when ``||g|| >= max_norm`` (no
epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), the moments are
``(1 - b) g^k + b m``, the bias corrections use the update count starting
at 1, weight decay applies to every parameter, and the learning rate is the
schedule at the count starting at 0; with ``warmup`` the weights' and the
biases' updates are then scaled by their multipliers at that count.
Parameters, gradients and moments are dicts keyed by the model's parameter
names.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, FrozenSet, Iterable, NamedTuple,
                    Optional, Tuple)

import torch
from torch import nn

from ..core.schedules import (cyclic_schedule, detailed_linear_warmup,
                              step_schedule)
from ..engine.profiling import span

Tensors = Dict[str, torch.Tensor]
EPS = 1e-8          # scale_by_adam's eps (eps_root 0)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a 0-d tensor on the tensors' device."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def is_bias(name: str) -> bool:
    """Whether the warmup treats parameter ``name`` as a bias: JAX's
    ``_is_bias`` takes a leaf whose last tree key is ``bias`` (every conv,
    linear and BatchNorm bias, not BatchNorm's ``scale``), and
    ``weights.py`` maps exactly those leaves to names ending in ``.bias``."""
    return name.rsplit('.', 1)[-1] == 'bias'


class OptState(NamedTuple):
    count: int        # updates applied so far
    mu: Tensors       # first moments
    nu: Tensors       # second moments


class AdamW:
    """The optax chain above.  ``lr_schedule`` and ``b1_schedule`` map the
    update count (0 for the first update) to a float; ``b1_schedule``
    replaces the constant b1 (cyclic momentum, optax ``inject_hyperparams``
    around ``scale_by_adam``); ``warmup_mults`` = (weight multiplier, bias
    multiplier) schedules (:func:`is_bias` picks the biases)."""

    def __init__(self, lr_schedule: Callable[[int], float],
                 betas=(0.95, 0.99), weight_decay: float = 0.01,
                 grad_clip: float = 10.0,
                 b1_schedule: Optional[Callable[[int], float]] = None,
                 warmup_mults: Optional[Tuple[Callable[[int], float],
                                              Callable[[int], float]]] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.b1_schedule = b1_schedule
        self.warmup_mults = warmup_mults
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
        mults = None
        if self.warmup_mults is not None:
            mults = tuple(f(state.count) for f in self.warmup_mults)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            m = (1.0 - b1) * g + b1 * state.mu[k]
            v = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            u = (m / c1) / (torch.sqrt(v / c2) + EPS)
            updates[k] = step * (u + self.weight_decay * params[k])
            if mults is not None:
                updates[k] = updates[k] * mults[is_bias(k)]
            mu[k], nu[k] = m, v
        return updates, OptState(count, mu, nu)


def make_optimizer(base_lr: float, total_steps: int, betas=(0.95, 0.99),
                   weight_decay: float = 0.01, grad_clip: float = 10.0,
                   target_ratio=(10.0, 1e-4), step_ratio_up: float = 0.4,
                   momentum_target_ratio=None,
                   warmup: Optional[Dict[str, Any]] = None,
                   lr_schedule: Optional[Callable[[int], float]] = None
                   ) -> AdamW:
    """AdamW with ``lr_schedule`` or else the cyclic one-cycle learning
    rate; with ``momentum_target_ratio``, cyclic b1 over the same cycle;
    with ``warmup`` (the keywords of
    :func:`~mmdet3d_gaussian_tpu_torch.core.schedules.detailed_linear_warmup`),
    the weight and bias multipliers (its momentum multiplier is built and
    left unused, as in the JAX package)."""
    lr = lr_schedule or cyclic_schedule(base_lr, total_steps, target_ratio,
                                        step_ratio_up=step_ratio_up)
    b1_sched = None
    if momentum_target_ratio is not None:
        b1_sched = cyclic_schedule(betas[0], total_steps,
                                   momentum_target_ratio,
                                   step_ratio_up=step_ratio_up)
    mults = None
    if warmup is not None:
        w_mult, b_mult, _ = detailed_linear_warmup(**warmup)
        mults = (w_mult, b_mult)
    return AdamW(lr, betas=betas, weight_decay=weight_decay,
                 grad_clip=grad_clip, b1_schedule=b1_sched,
                 warmup_mults=mults)


def make_lr_schedule_from_cfg(cfg, total_steps: int,
                              steps_per_epoch: Optional[int] = None
                              ) -> Optional[Callable[[int], float]]:
    """Non-cyclic learning-rate policies from ``lr_config`` (None -> the
    cyclic default).  ``policy='step'`` (``schedule_2x.py``): decay by
    ``gamma`` at the epoch milestones ``step`` (in steps through
    ``steps_per_epoch``), with ``warmup='linear'`` over ``warmup_iters``
    from ``warmup_ratio`` x the schedule."""
    opt_cfg = dict(cfg.get('optimizer', {}))
    lr_cfg = dict(cfg.get('lr_config', {}))
    if lr_cfg.get('policy') != 'step':
        return None
    base_lr = float(opt_cfg.get('lr', 1e-3))
    spe = steps_per_epoch or max(
        1, total_steps // int(cfg.get('max_epochs', 1) or 1))
    milestones = [int(m * spe) for m in lr_cfg.get('step', [])]
    base_sched = step_schedule(base_lr, milestones,
                               float(lr_cfg.get('gamma', 0.1)))
    wi = int(lr_cfg.get('warmup_iters', 0))
    wr = float(lr_cfg.get('warmup_ratio', 1.0))
    if lr_cfg.get('warmup') == 'linear' and wi > 0:
        def warmed(step: int) -> float:
            frac = min(step / wi, 1.0)
            return base_sched(step) * (wr + (1.0 - wr) * frac)
        return warmed
    return base_sched


def make_optimizer_from_cfg(cfg, total_steps: int,
                            steps_per_epoch: Optional[int] = None) -> AdamW:
    """The optimizer a config trains with: ``optimizer`` (lr, betas,
    weight_decay), ``grad_clip``, ``lr_config`` (``'cyclic'``, the default,
    or ``'step'``: :func:`make_lr_schedule_from_cfg`), ``momentum_config``
    (cyclic b1) and ``warmup``."""
    opt_cfg = dict(cfg.get('optimizer', {}))
    lr_cfg = dict(cfg.get('lr_config', {}))
    mom_cfg = cfg.get('momentum_config')
    return make_optimizer(
        lr_schedule=make_lr_schedule_from_cfg(cfg, total_steps,
                                              steps_per_epoch),
        base_lr=float(opt_cfg.get('lr', 1e-3)),
        total_steps=total_steps,
        betas=tuple(opt_cfg.get('betas', (0.95, 0.99))),
        weight_decay=float(opt_cfg.get('weight_decay', 0.01)),
        grad_clip=float(cfg.get('grad_clip', 10.0)),
        target_ratio=tuple(lr_cfg.get('target_ratio', (10.0, 1e-4))),
        step_ratio_up=float(lr_cfg.get('step_ratio_up', 0.4)),
        momentum_target_ratio=(tuple(mom_cfg['target_ratio'])
                               if mom_cfg else None),
        warmup=cfg.get('warmup'))


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


def reduce_gradients(grads: Tensors, group=None,
                     replicas: Optional[Tuple[Any, FrozenSet[str]]] = None
                     ) -> Tensors:
    """This rank's gradients -> their sums over ``group`` (a
    ``parallel.mesh.Group``; None: as they are), by one ``all_reduce`` of
    a flat buffer.

    ``replicas`` (point sharding: ``(points group, names)``): the ranks of
    the points group run the named parameters (the trunk after the pillar
    merge) as replicas of one another, on the same canvas of the same
    samples, while the others (the encoder's) see each rank's own point
    slice.  A replicated gradient is the data group's sum: the points
    group's first rank gives it to the sum over ``group`` (the world) and
    the others give 0, so the one all-reduce that sums the encoder's
    partial gradients over the world sums these over the data group.
    With at most two data ranks, the two nonzero terms and exact zeros
    make that the data group's all-reduce bit for bit
    (``tests/test_torch_sharded_model.py`` checks it on a 2 x 2 grid); and
    every rank gets the first replica's sum, where cuDNN's backward need
    not repeat a replica's sums bitwise."""
    from .mesh import all_reduce_sum
    if replicas is not None and replicas[0].rank != 0:
        grads = {k: torch.zeros_like(g) if k in replicas[1] else g
                 for k, g in grads.items()}
    if group is None:
        return grads
    return dict(zip(grads, all_reduce_sum(list(grads.values()), group)))


def make_train_step(apply_fn: Callable, loss_fn: Callable,
                    optimizer: AdamW, group=None,
                    replicas: Optional[Tuple[Any, FrozenSet[str]]] = None
                    ) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``apply_fn(batch) -> outputs`` runs the model that owns
    ``state.params`` in training mode (its BatchNorms update
    ``state.batch_stats`` in place); ``loss_fn(outputs, batch) -> (total,
    loss dict)``.  Metrics: each loss term, ``loss`` and ``grad_norm`` (of
    the unclipped gradients), as 0-d tensors on the device.

    ``group`` (a ``parallel.mesh.Group``; the JAX step's ``axis_name``):
    the batch is this rank's rows of a global batch and ``loss_fn`` gives
    this rank's share of the global loss (its normalizers global), so the
    gradients are summed over the ranks, in one ``all_reduce`` of a flat
    buffer, before the norm, the clipping and AdamW; the metrics are
    summed over the ranks in another.  Every rank then applies the same
    update.

    ``replicas`` (point sharding: ``(points group, names)``): see
    :func:`reduce_gradients`; the loss terms are replicas too and are
    summed over ``group`` from the first rank of each points group."""
    from .mesh import all_reduce_sum
    counts = replicas is None or replicas[0].rank == 0

    def step(state: TrainState, batch) -> Tuple[TrainState, Tensors]:
        with span('forward'):
            outputs = apply_fn(batch)
        total, losses = loss_fn(outputs, batch)
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        with span('backward'):
            raw = torch.autograd.grad(total, leaves, allow_unused=True)
        with span('optimizer'):
            grads = reduce_gradients(
                {k: torch.zeros_like(p) if g is None else g
                 for k, p, g in zip(names, leaves, raw)}, group, replicas)
            g_norm = global_norm(grads.values())
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, g_norm)
            with torch.no_grad():
                for k in names:
                    state.params[k].add_(updates[k])
        metrics = {k: torch.as_tensor(v, device=total.device).detach()
                   for k, v in losses.items()}
        metrics['loss'] = total.detach()
        if group is not None:
            values = [v.reshape(()) if counts else torch.zeros_like(v)
                      for v in metrics.values()]
            metrics = dict(zip(metrics, all_reduce_sum(values, group)))
        metrics['grad_norm'] = g_norm
        return state._replace(step=state.step + 1,
                              opt_state=opt_state), metrics

    return step
