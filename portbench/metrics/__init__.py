"""Per-layer metrics: ``metrics/<name>.py`` reads the metric ``name`` of
``BENCHMARK.json`` from the traced sub-window's context (its device
kernels, the recorded hand-kernel calls, the untraced window's step
time, the step's FLOPs) with ``read(ctx)``, and returns None when it
finds nothing to read; the harness then leaves the metric out."""
