"""Device ms a train step launched inside the program's `loss` span (the
head's losses, K3 where the targets are dense), from
`portbench/spans.py`."""
from portbench.spans import self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'train', ['loss'])
