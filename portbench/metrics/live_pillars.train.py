"""The program's `pillars.live` counter a train step: the batch's
non-empty pillars before capacity (the Scatter's `num_live`), from half
(a) of `portbench/spans.py`."""
from portbench.spans import live_pillars


def read(ctx):
    return live_pillars(ctx, 'train')
