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
