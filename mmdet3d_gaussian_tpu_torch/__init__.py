"""PyTorch / CUDA port of mmdet3d_gaussian_tpu (NVIDIA Hopper).

Layout mirrors the JAX package: ``ops`` (scatter, K1 segment reduce, K2 BEV
splat, K5 rotated IoU, K6 NMS sweep, with their CUDA sources in ``csrc``),
``models``, ``core``, ``engine`` and ``weights``.  It imports neither JAX
nor the JAX package.
"""
