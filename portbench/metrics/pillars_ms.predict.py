"""The pillar layers' own device ms a request: what the program's
`voxelize`, `encoder` and `canvas` spans launched outside their children
(the dynamic scatter, K1, K7), from the span pass of
`portbench/spans.py`."""
from portbench.spans import PILLARS, self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'predict', PILLARS)
