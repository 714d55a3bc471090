"""The whole train step's share of the H100's f32 peak (67
TFLOP/s): its model FLOPs (`portbench/flops.py`) over its time in the
untraced window of the same run."""
from portbench.metrics.common import mfu


def read(ctx):
    return mfu(ctx, 'train')
