"""Device ms an MCL cycle spends in the cast's hand kernels: K3 and K1 on
the bins, K5 on the BVH (the profiler's trace)."""

from benchmark.trace import kernels_ms_per_unit


def read(m):
    return kernels_ms_per_unit(m, ("K3", "K1", "K5")) if m.unit == "cycle" else None
