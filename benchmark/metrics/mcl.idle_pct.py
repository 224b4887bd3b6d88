"""Share of the traced part of an MCL window with nothing on the device (%)."""

from benchmark.trace import idle_pct


def read(m):
    return idle_pct(m) if m.unit == "cycle" else None
