"""The plain reference of each configuration: PyTorch operations in f32,
no kernel, written from the published architectures and the configs'
semantics.  It imports nothing of the port (nor JAX); it takes the weights
that the benchmark makes (``portbench/weights.py``) by name, and the
inputs that the benchmark hands to both sides."""
