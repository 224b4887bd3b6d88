"""Share of the traced part of an MCL window with nothing on the device
(%), as ``mcl.idle_pct``, in the cells that judge the cycle by its tail
(``cycle_ms_p95``)."""

from benchmark.trace import idle_pct


def read(m):
    return idle_pct(m) if m.unit == "cycle" else None
