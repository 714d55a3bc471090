"""The pillar layers' own device ms a train step: what the program's
`voxelize`, `encoder` and `canvas` spans launched outside their children
(hard voxelize, the pillar encoder, K2), from the span pass of
`portbench/spans.py`."""
from portbench.spans import PILLARS, self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'train', PILLARS)
