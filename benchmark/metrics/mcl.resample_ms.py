"""Median host time of ``MCLNode.resample`` (ms); the node's stage timer
waits for the device at its end."""

from benchmark.trace import span_median_ms


def read(m):
    return span_median_ms(m, "bench.resample") if m.unit == "cycle" else None
