"""The hand kernels' share of their roofline: the summed least time (the
larger of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s, counted from each
call's inputs at its op's entry by `portbench/work.py`) over the summed
device time of their kernels."""
from portbench.metrics.common import roofline


def read(ctx):
    return roofline(ctx, 'train')
