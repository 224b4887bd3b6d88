"""Median host time of ``MCLNode.resample`` (ms), as ``mcl.resample_ms``,
in the cells that judge the cycle by its tail (``cycle_ms_p95``)."""

from benchmark.trace import span_median_ms


def read(m):
    return span_median_ms(m, "bench.resample") if m.unit == "cycle" else None
