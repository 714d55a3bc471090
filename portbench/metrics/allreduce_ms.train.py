"""Device ms a train step of the all-reduces themselves (the gradients',
the BatchNorms', the loss normalizers' and the logged losses'), on
several ranks: each collective's NCCL kernel on the rank that reached it
last, which waits for no other rank, so the wait for the slowest rank
(the ranks' skew, which their profilers stretch) is left out.  Nothing
to read on one card."""
from portbench.metrics.common import collective_ms


def read(ctx):
    return collective_ms(ctx, 'train')
