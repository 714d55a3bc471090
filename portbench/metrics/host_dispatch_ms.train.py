"""Host ms a train step spends inside the program's `train_step` span,
recorder on and no profiler (half (a) of `portbench/spans.py`): the
host's enqueueing, and its waits on the card at each sync."""
from portbench.spans import host_dispatch_ms


def read(ctx):
    return host_dispatch_ms(ctx, 'train')
