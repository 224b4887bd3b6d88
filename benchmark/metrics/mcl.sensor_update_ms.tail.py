"""Median host time of ``MCLNode.sensor_update`` (ms), as
``mcl.sensor_update_ms``, in the cells that judge the cycle by its tail
(``cycle_ms_p95``)."""

from benchmark.trace import span_median_ms


def read(m):
    return span_median_ms(m, "bench.sensor_update") if m.unit == "cycle" else None
