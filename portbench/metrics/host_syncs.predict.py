"""Synchronizing CUDA runtime calls a request makes inside the program's
spans (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, blocking `cudaMemcpy`), from the profiled half of
`portbench/spans.py`; the answer's copies to the host are outside them."""
from portbench.spans import host_syncs


def read(ctx):
    return host_syncs(ctx, 'predict')
