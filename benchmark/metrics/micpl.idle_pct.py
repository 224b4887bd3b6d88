"""Share of the traced part of a MICP-L window with nothing on the device (%)."""

from benchmark.trace import idle_pct


def read(m):
    return idle_pct(m) if m.unit == "correction" else None
