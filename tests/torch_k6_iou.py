"""IoU matrices for the tests of K6 (the NMS suppression sweep), numpy from
a seed, shared by the CPU tests and the ``gpu`` tests, and a plain-Python
emulation of the kernel's blocked word sweep.

:func:`adversarial` gives (P, K, K) f32 matrices and (P, K) valid masks:
values at f32(thr) and one ulp either side of it; NaN, +-inf and -0.0;
every IoU above the threshold (row 0 suppresses all); none above; the chain
``iou[i, i+1] > thr`` alone, which keeps every other row; and invalid rows
whose IoU with every later row is above the threshold.

:func:`blocked_word_sweep` computes the keep mask the way
``csrc/nms_sweep.cu`` does: the strict upper triangle packed into 64-bit
words (bit j - 64 w of word w) in the kernel's triangular layout, the alive words resolved one
64-row diagonal block at a time, staged as many blocks as fit in a given
number of words.  It is a test helper; the package never imports it.
"""
import numpy as np

# the KITTI, Waymo and PV-RCNN nms_thr of configs/
THRESHOLDS = (0.01, 0.25, 0.8)
CASES = ('ties', 'specials', 'all_above', 'none_above', 'chain',
         'invalid_suppressors')


def _f32(x):
    return np.float32(x)


def adversarial(case, k, thr, seed=0, p=2):
    """(iou (p, k, k) f32, valid (p, k) bool) of one of :data:`CASES`."""
    rng = np.random.RandomState(seed)
    t = _f32(thr)
    up = np.nextafter(t, _f32(np.inf))
    down = np.nextafter(t, _f32(-np.inf))
    valid = rng.rand(p, k) > 0.1
    if case == 'ties':
        iou = rng.choice(np.array([t, up, down, _f32(0.0), _f32(1.0)],
                                  np.float32), (p, k, k),
                         p=[0.3, 0.1, 0.3, 0.2, 0.1])
    elif case == 'specials':
        iou = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, up,
                                   down], np.float32), (p, k, k),
                         p=[0.2, 0.05, 0.1, 0.2, 0.15, 0.05, 0.25])
    elif case == 'all_above':
        iou = np.full((p, k, k), up, np.float32)
        valid[:, 0] = True
    elif case == 'none_above':
        iou = np.full((p, k, k), t, np.float32)
        iou[:, ::2] = down
    elif case == 'chain':
        iou = np.zeros((p, k, k), np.float32)
        i = np.arange(k - 1)
        iou[:, i, i + 1] = up
        valid[:] = True
    elif case == 'invalid_suppressors':
        iou = np.where(rng.rand(p, k, k) < 0.02, up, down).astype(np.float32)
        bad = rng.rand(p, k) < 0.3
        iou[bad] = up                   # every later row above threshold
        valid &= ~bad
        if k > 1:
            valid[:, 1] = True
            valid[:, 0] = False
            iou[:, 0] = up
    else:
        raise ValueError(case)
    return iou.astype(np.float32), valid


def _pack_rows(iou, thr):
    """(K, W) uint64: bit (j - 64 w) of word w of row i set iff j > i and
    iou[i, j] > f32(thr)."""
    k = iou.shape[0]
    w = -(-k // 64)
    bits = (iou > _f32(thr)) & np.triu(np.ones((k, k), bool), 1)
    pad = np.zeros((k, 64 * w), bool)
    pad[:, :k] = bits
    return np.packbits(pad, axis=1, bitorder='little').view('<u8')


def _triangle(rows):
    """The kernel's workspace layout of one problem: row block b keeps
    words b .. W-1 of its 64 rows (rows past K are zero)."""
    k, w = rows.shape
    out = np.zeros(32 * w * (w + 1), np.uint64)
    off = 0
    for b in range(w):
        blk = np.zeros((64, w - b), np.uint64)
        n = min(64, k - 64 * b)
        blk[:n] = rows[64 * b:64 * b + n, b:]
        out[off:off + blk.size] = blk.reshape(-1)
        off += blk.size
    return out


def blocked_word_sweep(iou, valid, thr, cap_words=None):
    """Keep mask (P, K) bool of the blocked word sweep (module docstring).
    ``cap_words`` bounds a stage (default: the whole triangle); at least
    one row block, 64 W words, must fit."""
    p, k = valid.shape
    keep = np.zeros((p, k), bool)
    if k == 0:
        return keep
    w = -(-k // 64)
    cap = 32 * w * (w + 1) if cap_words is None else cap_words
    assert cap >= 64 * w
    for n in range(p):
        tri = _triangle(_pack_rows(iou[n], thr))
        vb = np.zeros(64 * w, bool)
        vb[:k] = valid[n]
        alive = [int(x) for x in
                 np.packbits(vb, bitorder='little').view('<u8')]
        off, b0 = 0, 0
        while b0 < w:
            b1, size = b0, 0
            while b1 < w and size + 64 * (w - b1) <= cap:
                size += 64 * (w - b1)
                b1 += 1
            stage = [int(x) for x in tri[off:off + size]]
            base = 0
            for b in range(b0, b1):
                stride = w - b
                a = alive[b]
                for r in range(63):          # the owner lane's walk
                    if (a >> r) & 1:
                        a &= ~stage[base + r * stride]
                alive[b] = a
                for r in range(64):          # the kept rows' later words
                    if (a >> r) & 1:
                        for wd in range(b + 1, w):
                            alive[wd] &= ~stage[base + r * stride + wd - b]
                base += 64 * stride
            off += size
            b0 = b1
        bits = np.array(alive, dtype=np.uint64).view(np.uint8)
        keep[n] = np.unpackbits(bits, bitorder='little')[:k].astype(bool)
    return keep
