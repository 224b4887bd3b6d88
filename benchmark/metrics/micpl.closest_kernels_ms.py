"""Device ms a correction spends in the closest-point query's hand kernels,
K7 (the candidate cull) and K6b (the candidate-bin loop) (the profiler's
trace)."""

from benchmark.trace import kernels_ms_per_unit


def read(m):
    return kernels_ms_per_unit(m, ("K7", "K6b")) if m.unit == "correction" else None
