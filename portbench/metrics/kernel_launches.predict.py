"""Device kernels launched a request,
counted in the trace (copies and fills apart); the port's own launch
counter (`ops/_cuda.LAUNCHES`) goes on an earlier line beside it."""
from portbench.metrics.common import launches


def read(ctx):
    return launches(ctx, 'predict')
