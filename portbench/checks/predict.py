"""A serving cell's comparison: every answer the window gave, against
the reference's answer to the same request.

Per frame, the program's kept boxes P (valid rows: centre, size, yaw,
velocity, score, label) and the reference's: its kept boxes R and the
candidates C that its NMS saw (each task's best cells, decoded).  The
distance of two boxes of one label is the largest gap of a component
over max(1, |reference value|), yaw gaps taken modulo 2 pi, the less of
the box as it is and as the same rectangle a quarter turn on (yaw +- pi/2,
dx and dy swapped): decode snaps the regressed yaw to the direction
branch's quarter, and where the two lie half a quarter apart rounding
picks either of the two equal rectangles.

* ``box_gap``: the largest distance from a box of P to the nearest
  candidate of C of its label: every answered box is a box the reference
  decodes, to rounding (a box altered where it is produced is not);
* ``score_gap``: the largest gap between the kept scores of P and of R,
  each sorted (a frame's rows that are not kept count 0): what NMS and
  the final selection kept, and every frame answered.  Two boxes whose
  scores tie to rounding at a selection's cut can swap between the two
  sets, which moves the sorted scores by no more than the rounding.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np

DX, DY, YAW = 3, 4, 6


def _dist_raw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a[:, None, :] - b[None, :, :])
    yaw = d[..., YAW] % (2 * math.pi)
    d[..., YAW] = np.minimum(yaw, 2 * math.pi - yaw)
    return (d / np.maximum(1.0, np.abs(b))[None]).max(-1)


def _quarter_turn(a: np.ndarray, sign: float) -> np.ndarray:
    out = a.copy()
    out[:, [DX, DY]] = a[:, [DY, DX]]
    out[:, YAW] += sign * math.pi / 2
    return out


def _dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, D) x (m, D) rows of box components + score -> (n, m)."""
    return np.minimum.reduce([_dist_raw(a, b),
                              _dist_raw(_quarter_turn(a, 1.0), b),
                              _dist_raw(_quarter_turn(a, -1.0), b)])


def _rows(boxes, scores, labels, valid):
    v = valid.astype(bool)
    return np.c_[boxes[v], scores[v]].astype(np.float64), labels[v]


def _nearest(a, la, b, lb) -> np.ndarray:
    """Distance of each row of a to the nearest row of b with its label
    (inf where b has none)."""
    out = np.full(len(a), np.inf)
    for lab in np.unique(la):
        ia, ib = la == lab, lb == lab
        if ib.any():
            out[ia] = _dist(a[ia], b[ib]).min(1)
    return out


def _kept_scores(scores, valid, m):
    s = np.sort(np.where(valid.astype(bool), scores, 0.0))[::-1]
    return np.pad(s.astype(np.float64), (0, m - len(s)))


def frame_numbers(prog, ref_final, ref_cands) -> Tuple[float, float]:
    """One frame's (box gap, score gap); each argument is (boxes, scores,
    labels, valid) of that frame as numpy arrays (candidates flattened
    over tasks)."""
    p, lp = _rows(*prog)
    cand, lc = _rows(*ref_cands)
    gap = float(_nearest(p, lp, cand, lc).max()) if len(p) else 0.0
    m = max(len(prog[1]), len(ref_final[1]))
    score = float(np.abs(_kept_scores(prog[1], prog[3], m)
                         - _kept_scores(ref_final[1], ref_final[3], m)).max())
    return gap, score


def numbers(answers: List[Tuple[int, Tuple]], refs: Dict[int, Tuple]
            ) -> Dict[str, float]:
    """answers: (pool index, (boxes, scores, labels, valid) numpy) of every
    request of the window; refs: pool index -> the reference's (final,
    candidates) numpy tuples.  Equal answers are compared once."""
    seen, out = {}, dict(box_gap=0.0, score_gap=0.0)
    for idx, ans in answers:
        h = hashlib.sha1(b''.join(np.ascontiguousarray(a).tobytes()
                                  for a in ans)).hexdigest()
        key = (idx, h)
        if key not in seen:
            final, cands = refs[idx]
            per = []
            for f in range(ans[0].shape[0]):
                per.append(frame_numbers(
                    tuple(a[f] for a in ans), tuple(a[f] for a in final),
                    tuple(a[f].reshape(-1, *a.shape[3:]) if a.ndim > 3
                          else a[f].reshape(-1) for a in cands)))
            seen[key] = [max(x) for x in zip(*per)]
        for name, v in zip(out, seen[key]):
            out[name] = max(out[name], float(v))
    return out
