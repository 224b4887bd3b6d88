"""Corrections completed over the window's seconds."""


def read(m):
    if m.unit != "correction" or not m.unit_seconds:
        return None
    return len(m.unit_seconds) / m.window_s
