"""Device ms a correction spends in operations that are not hand kernels:
the torch operations of the correspondence payload, the reduction and the
solve, and copies (the profiler's trace)."""


def read(m):
    t = m.trace
    if m.unit != "correction" or t is None or not t.units:
        return None
    return 1e3 * t.other_seconds() / t.units
