"""Median host time of the node's ingest of a scan and its odometry (ms):
``on_odometry`` and ``on_scan``, the benchmark's span around them."""

from benchmark.trace import span_median_ms


def read(m):
    return span_median_ms(m, "bench.ingest") if m.unit == "correction" else None
