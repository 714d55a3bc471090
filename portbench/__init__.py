"""The benchmark of the PyTorch/CUDA port (``mmdet3d_gaussian_tpu_torch``).

One command runs one cell once::

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under ``configs/``, ``traffic/`` and
``metrics/``, found by the name that ``BENCHMARK.json`` gives it (see
``README.md``).  Nothing here imports JAX or the JAX package.
"""
