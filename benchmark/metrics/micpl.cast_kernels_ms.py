"""Device ms a correction spends in the cast's hand kernels, K3 and K1
(the profiler's trace)."""

from benchmark.trace import kernels_ms_per_unit


def read(m):
    return kernels_ms_per_unit(m, ("K3", "K1")) if m.unit == "correction" else None
