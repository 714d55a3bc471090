"""Device ms a train step launched inside the program's `targets` span
(the anchor head's target assignment), from `portbench/spans.py`."""
from portbench.spans import self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'train', ['targets'])
