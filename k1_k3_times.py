#!/usr/bin/env python3
"""K1 (sorted-segment reduce, mapback, winner) and K3 (the fused anchor GD
loss, forward and backward) on one CUDA card, cold and warm, against
another checkout's port.

    python3 k1_k3_times.py [--other CHECKOUT]

The inputs are those ``chip_smoke.py`` captures: K1's reduce and mapback
from one full-width f32 predict, K1's winner form and K3 from one f32 and
one bf16 dense-target train step (the chip_smoke model, seed and batch),
and K3 once more on the f32 step's inputs with every weight 0 (its time
without the weighted anchors' terms).
Each input is held to the plain version (max and mask exact, sums within
1e-4, the loss within 1e-5 relative, d(pred) within 5e-6 + 1e-4 |plain|),
then timed: device ms (torch.profiler), median of ``ROUNDS`` rounds of
``ITERS`` calls, cold (the inputs rotated over copies that total over
twice the L2: ``chip_smoke.cold_ms``) and warm (the same inputs again),
beside the bound and the empty-kernel launch floor.

``--other`` imports the port of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory) as a second
package and times its kernels on the same inputs in the same process, in
turns (this, other, other, this, ...), so that both meet the same card and
clocks.  Where the other checkout's winner form returns a ``(V, C)`` int32
table of winning rows (``segment_argmax``), its time is printed alone and
with the per-row mask its scatter rebuilt from the table
(``scatter._winner_rows``).  The run exits 1 if this checkout's K1 reduce,
K1 winner, K3 forward or K3 backward is slower than the other's on any
input, cold or warm, or its K1 mapback slower by more than the rounds'
spread.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS, ITERS = 5, 50
# forms this checkout redesigned: each must beat the other checkout's
REDESIGNED = ('K1 reduce', 'K1 winner', 'K3 forward', 'K3 backward')


def load_port(root: str, name: str):
    """{'segment', 'gd_loss', 'scatter'}: those ops modules of the port in
    checkout ``root``, imported as package ``name`` (its kernels build under
    that checkout's ``build/``)."""
    pkg = os.path.join(root, 'mmdet3d_gaussian_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f'{name}.ops.{m}')
            for m in ('segment', 'gd_loss', 'scatter')}


def forms(port):
    """{form: fn(args) -> outputs} of one port; the winner form as
    (max, per-row mask) where the port returns a winner table."""
    seg, gd = port['segment'], port['gd_loss']
    out = {
        'K1 reduce': lambda a: seg.segment_reduce(*a),
        'K1 mapback': lambda a: seg.segment_reduce_mapback(*a),
        'K3 forward': lambda a: gd.gd_loss_fwd(*a),
        'K3 backward': lambda a: gd.gd_loss_bwd(*a),
    }
    if hasattr(seg, 'segment_max_winner'):
        out['K1 winner'] = lambda a: seg.segment_max_winner(*a)
    else:
        rows = port['scatter']._winner_rows

        def table(a):
            data, _ids, starts, counts = a
            return seg.segment_argmax(data, starts, counts)

        def with_mask(a):
            best, winner = table(a)
            return best, rows(winner, a[1])
        out['K1 winner'] = table
        out['K1 winner + mask'] = with_mask
    return out


def capture():
    """[(input name, form, args)] from the chip_smoke model: an f32
    predict, an f32 and a bf16 dense-target train step."""
    import chip_smoke as cs
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    batch = synthetic_batch(cs.BATCH, cs.POINTS, 16, seed=cs.SEEDS[0],
                            device='cuda')
    det = PointPillarsDetector(cs.F32_MODEL, device='cuda', seed=0)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    with torch.inference_mode():
        pred = cs.capture_inputs(det, batch, cs.PREDICT_LAUNCHES)
    out = [('f32 predict', 'K1 reduce', tuple(pred['segment_reduce'])),
           ('f32 predict', 'K1 mapback',
            tuple(pred['segment_reduce_mapback']))]
    del det, pred
    for tag, model, launches in (
            ('f32 dense step', cs.F32_MODEL,
             {**cs.TRAIN_LAUNCHES, **cs.DENSE_LAUNCHES}),
            ('bf16 dense step', cs.BF16_MODEL, cs.DENSE_BF16_LAUNCHES)):
        ddet = PointPillarsDetector(model, dict(pos_cap=0), device='cuda',
                                    seed=0)
        state = ddet.init_train(cs.LR, total_steps=100)
        state, _ = ddet.train_step(batch, state)          # warm-up
        seen, _ = cs.capture_train_inputs(ddet, batch, state, launches)
        for form, key in (('K1 winner', 'segment_max_winner'),
                          ('K3 forward', 'gd_loss_fwd'),
                          ('K3 backward', 'gd_loss_bwd')):
            out.append((tag, form, tuple(seen[key][0])))
        if tag.startswith('f32'):
            # the same with every weight 0: K3 without its weighted anchors
            for form, key, at in (('K3 forward', 'gd_loss_fwd', 2),
                                  ('K3 backward', 'gd_loss_bwd', 3)):
                args = list(seen[key][0])
                args[at] = torch.zeros_like(args[at])
                out.append((tag + ', w = 0', form, tuple(args)))
        del ddet, state, seen
        torch.cuda.empty_cache()
    return out


def agree(form, got, args, mods):
    """Raise unless ``got`` (the form's outputs) agrees with the plain
    version of this checkout."""
    import chip_smoke as cs
    seg, gd = mods['segment'], mods['gd_loss']
    if form == 'K1 reduce':
        cs.check(torch.equal(got, seg.segment_reduce_plain(*args)),
                 'K1 reduce disagrees')
    elif form == 'K1 mapback':
        want = seg.segment_reduce_mapback_plain(*args)
        cs.check(float((got - want).abs().max()) <= 1e-4,
                 'K1 mapback disagrees')
    elif form.startswith('K1 winner'):
        want, want_m = seg.segment_max_winner_plain(*args)
        cs.check(torch.equal(got[0], want), 'K1 winner max disagrees')
        if got[1].dtype == torch.bool:
            cs.check(torch.equal(got[1], want_m), 'K1 winner mask disagrees')
    elif form == 'K3 forward':
        want = float(gd.anchor_gd_loss_plain(*args))
        cs.check(abs(float(got) - want) <= 1e-5 * abs(want),
                 'K3 forward disagrees')
    else:
        want = gd.gd_loss_bwd_plain(*args)
        cs.check(bool(((got - want).abs() <= 5e-6 + 1e-4 * want.abs())
                      .all()), 'K3 backward disagrees')


def work(form, args):
    import chip_smoke as cs
    if form.startswith('K1'):
        data = args[0]
        if form == 'K1 reduce':
            return cs.k1_work('reduce', data, None, *args[1:3])
        return cs.k1_work('mapback' if form == 'K1 mapback' else 'winner',
                          data, *args[1:4])
    pred2, w_a = (args[0], args[2]) if form == 'K3 forward' \
        else (args[1], args[3])
    return cs.k3_work(pred2, w_a)[0]['fwd' if form == 'K3 forward'
                                      else 'bwd']


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('k1_k3_times: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmdet3d_gaussian_tpu_torch.ops import gd_loss, scatter, segment
    this = dict(segment=segment, gd_loss=gd_loss, scatter=scatter)
    versions = {'this': forms(this)}
    if args.other:
        versions['other'] = forms(load_port(os.path.abspath(args.other),
                                            'port_other'))
    card = cs.card_line()
    floor = cs.launch_floor()
    print(f'empty-kernel launch floor {floor:.4f} ms [{card}]')
    out = dict(card=card, other=args.other, floor_ms=floor, rows=[])
    failures = []
    captured = capture()
    with torch.no_grad():   # the step's box map requires grad
        for tag, form, fargs in captured:
            # the other checkout's winner form also with its mask rebuilt
            names = [(v, f) for v in versions for f in versions[v]
                     if f == form
                     or (form == 'K1 winner' and f.startswith(form))]
            for v, f in names:
                agree(f, versions[v][f](fargs), fargs, this)
            times = {(v, f): {'warm': [], 'cold': []} for v, f in names}
            for r in range(ROUNDS):
                for v, f in (names if r % 2 == 0 else names[::-1]):
                    fn = versions[v][f]
                    times[(v, f)]['warm'].append(cs.device_ms(
                        lambda: fn(fargs), ITERS))
                    times[(v, f)]['cold'].append(cs.cold_ms(
                        lambda *a: fn(a), fargs, ITERS)[0])
            b_ms, b_by = cs.bound(*work(form, fargs))
            row = dict(input=tag, form=form, bound_ms=b_ms, bound_by=b_by)
            for (v, f), t in times.items():
                key = v if f == form else f'{v} ({f})'
                row[key] = {k: dict(median=statistics.median(x), min=min(x),
                                    max=max(x)) for k, x in t.items()}
            out['rows'].append(row)
            text = '; '.join(
                f'{key} cold {row[key]["cold"]["median"]:.4f} warm '
                f'{row[key]["warm"]["median"]:.4f}'
                for key in row if isinstance(row[key], dict))
            print(f'{form} on the {tag}: {text} ms; bound {b_ms:.4f} ms '
                  f'({b_by}); device ms, median of {ROUNDS} rounds of {ITERS} '
                  f'calls [{card}]')
            if 'other' not in row:
                continue
            for k in ('cold', 'warm'):
                new, old = row['this'][k], row['other'][k]
                spread = max(new['max'] - new['min'], old['max'] - old['min'])
                if form in REDESIGNED and new['median'] >= old['median']:
                    failures.append(f'{form} on the {tag}, {k}: this '
                                    f'{new["median"]:.4f} >= other '
                                    f'{old["median"]:.4f} ms')
                if form == 'K1 mapback' and \
                        new['median'] > old['median'] + spread:
                    failures.append(f'{form} on the {tag}, {k}: this '
                                    f'{new["median"]:.4f} > other '
                                    f'{old["median"]:.4f} + spread '
                                    f'{spread:.4f}')
    out['failures'] = failures
    print(json.dumps(out))
    for f in failures:
        print(f'k1_k3_times: slower than the other checkout: {f}',
              file=sys.stderr)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
