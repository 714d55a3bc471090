"""Device ms a request of the convolution and GEMM kernels
(cuDNN, cuBLAS, CUTLASS), by name."""
from portbench.metrics.common import matching_ms

PATTERNS = ('xmma', 'cutlass', 'cudnn', 'implicit_convolve',
            'implicit_gemm', 'sgemm', 'gemm', 'winograd', 'fft', 'dgrad',
            'wgrad', 'convolve', 'conv2d', 'cublas')


def read(ctx):
    return matching_ms(ctx, 'predict', PATTERNS)
