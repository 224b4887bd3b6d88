"""95th percentile of all corrections' times in the window (ms)."""

from benchmark.trace import percentile


def read(m):
    if m.unit != "correction" or not m.unit_seconds:
        return None
    return 1e3 * percentile(m.unit_seconds, 95)
