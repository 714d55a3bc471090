"""KITTI data converters of the port (numpy; no JAX)."""
