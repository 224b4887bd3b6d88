"""Device ms an MCL cycle spends in the cast's hand kernels (K3 and K1,
K5), as ``mcl.cast_kernels_ms``, in the cells that judge the cycle by its
tail (``cycle_ms_p95``)."""

from benchmark.trace import kernels_ms_per_unit


def read(m):
    return kernels_ms_per_unit(m, ("K3", "K1", "K5")) if m.unit == "cycle" else None
