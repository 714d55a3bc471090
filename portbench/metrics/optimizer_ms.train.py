"""Device ms a train step launched inside the program's `optimizer` span
(the gradient norm, clipping, AdamW and the parameters' in-place adds),
from `portbench/spans.py`."""
from portbench.spans import self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'train', ['optimizer'])
