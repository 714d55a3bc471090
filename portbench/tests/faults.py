"""Faults planted under the timed path, for the tests that see
``correct`` come out false: each wraps the program's step (train) or
predict as the loops call it, ``fn(det, batch[, state])``."""
from __future__ import annotations

import torch


def _half(batch):
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def unchanged_state(step):
    """A train step that returns its state unchanged (the parameters put
    back, the old optimizer state returned)."""
    def f(det, batch, state):
        keep = {k: p.detach().clone() for k, p in state.params.items()}
        _new, metrics = step(det, batch, state)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(keep[k])
        return state, metrics
    return f


def half_batch_train(step):
    """A train step on half of the batch, the mean taken over the rest."""
    def f(det, batch, state):
        return step(det, _half(batch), state)
    return f


def half_batch_predict(predict):
    """A predict of the first half of the frames; the rest answered with
    nothing kept."""
    def f(det, batch):
        boxes, scores, labels, valid = predict(det, _half(batch))
        b = batch['points'].shape[0]

        def pad(t):
            out = t.new_zeros((b,) + tuple(t.shape[1:]))
            out[:t.shape[0]] = t
            return out
        return pad(boxes), pad(scores), pad(labels), pad(valid)
    return f


def altered_answer(predict):
    """A predict whose first box of the first frame is moved by a metre
    where it is produced."""
    def f(det, batch):
        boxes, scores, labels, valid = predict(det, batch)
        boxes = boxes.clone()
        boxes[0, 0, 0] += 1.0
        return boxes, scores, labels, valid
    return f


def no_exchange(step):
    """A data-parallel train step whose ranks exchange nothing: every
    all-reduce left out, so each rank's BatchNorm statistics, loss
    normalizers, gradients and logged loss are its own rows' alone."""
    import torch.distributed as dist

    def f(det, batch, state):
        real = dist.all_reduce
        dist.all_reduce = lambda *args, **kw: None
        try:
            return step(det, batch, state)
        finally:
            dist.all_reduce = real
    return f


def rank_killed(step):
    """A train step that kills its own process on rank 1 at its fifth
    call (after the checked steps, in the warm steps)."""
    import os
    import signal
    import torch.distributed as dist
    calls = [0]

    def f(det, batch, state):
        calls[0] += 1
        if calls[0] == 5 and dist.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        return step(det, batch, state)
    return f
