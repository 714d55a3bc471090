"""A training cell's comparison.  Set-up drives the program's own train
step through its first steps on distinct batches; the reference follows
the same steps from the same weights.  Compared, each against its limit:

* ``loss_gap``: the relative gap of the first step's loss (the later
  steps' losses move by Adam's round-off: an update is of degree 0 in
  each gradient element, so an element whose gradient is near zero moves
  by up to the learning rate either way, and the second and third steps'
  losses of sound runs read gaps of 1e-4 to 3e-3, as far as the
  control's);
* ``grad_gap``: the first gradient as the optimizer took it (clipped),
  the program's worked out from its AdamW state after one step (the first
  moment over 1 - beta1); by the worst leaf, the gap between the two
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``grad_median_gap``: the same gap of the median leaf (the worst leaf of
  sound runs is a small one, the pillar encoder's linear layer or
  BatchNorm or SECOND's first BatchNorm, 64 to 640 elements, and reads
  gaps to 2e-3, within a third of the control's; the median leaf is
  steady from seed to seed and under a tenth of the control's);
* ``delta_gap``: the same of each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from ..reference.layers import precision, set_lowp
from ..reference.optim import AdamW, cyclic

SKIP_BELOW = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float()))
            for k, v in tensors.items()}


def first_gradient(state, cfg: Dict) -> Dict[str, float]:
    """Leaf norms of the gradient the program's AdamW took at its first
    update, from its first moment after one step."""
    t = cfg['train']
    total = int(t['total_steps'])
    b1 = cyclic(t['optimizer']['betas'][0], total,
                t['momentum_config']['target_ratio'],
                t['lr_config'].get('step_ratio_up', 0.4))(0)
    return {k: v / (1.0 - b1) for k, v in norms(state.opt_state.mu).items()}


def changes(params: Dict[str, torch.Tensor],
            start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return norms({k: p.detach() - start[k] for k, p in params.items()})


def checked_steps(step, det, state, batches: List[Dict], cfg: Dict,
                  start: Dict[str, torch.Tensor]):
    """Drive the program's own step, ``step(det, batch, state)``, through
    ``batches``, one step each: -> (state, readings): each step's loss,
    the first gradient as its AdamW took it, and each leaf's change over
    the steps from ``start``."""
    prog = dict(losses=[])
    for i, batch in enumerate(batches):
        state, m = step(det, batch, state)
        prog['losses'].append(float(m['loss']))
        if i == 0:
            prog['grad'] = first_gradient(state, cfg)
    prog['delta'] = changes(state.params, start)
    return state, prog


def reference(family, cfg: Dict, weights: Dict[str, torch.Tensor],
              batches: List[Dict], device, lowp: bool = False) -> Dict:
    """The reference's readings over ``batches``, one step each, f32 (or
    the control's lower precision: TF32 on the card, its rounding on the
    CPU)."""
    model = family.reference(cfg, device)
    model.load_state_dict(weights, strict=True)
    set_lowp(model, lowp and device.type == 'cpu')
    params = dict(model.named_parameters())
    opt = AdamW(cfg['train'])
    anchors = family.reference_anchors(model, device)
    losses, g1 = [], None
    with precision(lowp and device.type == 'cuda'):
        for batch in batches:
            loss = family.reference_loss(model, batch, anchors)
            raw = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), raw)}
            clipped = opt.step(params, grads)
            losses.append(float(loss.detach()))
            if g1 is None:
                g1 = norms(clipped)
    return dict(losses=losses, grad=g1,
                delta=changes(params, weights))


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = abs(prog['losses'][0] - ref['losses'][0]) \
        / max(abs(ref['losses'][0]), 1e-30)
    keys = list(ref['grad'])
    med_g = statistics.median(ref['grad'][k] for k in keys)
    g = [abs(prog['grad'][k] - ref['grad'][k])
         / max(ref['grad'][k], med_g, 1e-30) for k in keys]
    moved = [k for k in keys if ref['grad'][k] >= SKIP_BELOW * med_g]
    med_d = statistics.median(ref['delta'][k] for k in moved)
    delta_gap = max(abs(prog['delta'][k] - ref['delta'][k])
                    / max(ref['delta'][k], med_d, 1e-30) for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=max(g),
                grad_median_gap=statistics.median(g), delta_gap=delta_gap)


def details(prog: Dict, ref: Dict) -> Dict:
    """Where the gaps sit: each step's loss gap, the three worst leaves of
    the gradient and of the change, the median leaf's gaps."""
    keys = list(ref['grad'])
    med_g = statistics.median(ref['grad'][k] for k in keys)
    moved = [k for k in keys if ref['grad'][k] >= SKIP_BELOW * med_g]
    med_d = statistics.median(ref['delta'][k] for k in moved)
    g = {k: abs(prog['grad'][k] - ref['grad'][k])
         / max(ref['grad'][k], med_g, 1e-30) for k in keys}
    d = {k: abs(prog['delta'][k] - ref['delta'][k])
         / max(ref['delta'][k], med_d, 1e-30) for k in moved}
    worst = lambda x: sorted(x.items(), key=lambda kv: -kv[1])[:3]  # noqa
    return dict(
        loss_gaps=[abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog['losses'], ref['losses'])],
        grad_worst=worst(g), delta_worst=worst(d),
        grad_median=statistics.median(g.values()),
        delta_median=statistics.median(d.values()))


def left_out(ref: Dict) -> List[str]:
    """The leaves that ``delta_gap`` leaves out."""
    med_g = statistics.median(ref['grad'].values())
    return [k for k, v in ref['grad'].items() if v < SKIP_BELOW * med_g]
