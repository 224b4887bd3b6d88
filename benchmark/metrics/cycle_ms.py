"""The window's seconds over the MCL cycles completed in it (ms)."""


def read(m):
    if m.unit != "cycle" or not m.unit_seconds:
        return None
    return 1e3 * m.window_s / len(m.unit_seconds)
