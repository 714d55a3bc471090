"""The share of a request's time in the untraced window in which nothing ran
on the card: 1 - the device's busy time a request in the trace (kernels,
copies and fills) over the request's time in the window."""
from portbench.metrics.common import idle


def read(ctx):
    return idle(ctx, 'predict')
