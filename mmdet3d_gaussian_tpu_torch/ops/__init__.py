"""Tensor ops of the port; the kernel-backed ones dispatch on the tensors'
device (CUDA kernel on the card, plain PyTorch on the CPU)."""
