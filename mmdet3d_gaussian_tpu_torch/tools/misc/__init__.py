"""Profiling, benchmarking and visualization scripts of the port, run with
``python -m mmdet3d_gaussian_tpu_torch.tools.misc.<name>``."""
