"""Synchronizing CUDA runtime calls a train step makes inside the
program's spans (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, blocking `cudaMemcpy`), from the profiled half of
`portbench/spans.py`; the log's span table names each one's span."""
from portbench.spans import host_syncs


def read(ctx):
    return host_syncs(ctx, 'train')
