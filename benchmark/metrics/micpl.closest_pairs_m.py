"""Query-bin pairs the closest-point cull's lists hand K6b a correction, in
millions: the program's ``rmcl.closest.pairs`` counter (sum over query
blocks of the list's length x the block's queries, counted on the device)
over the window's corrections, in a traced run (absent where the program
counts none)."""


def read(m):
    xs = m.spans.get("rmcl.closest.pairs")
    if m.unit != "correction" or not xs or not m.unit_seconds:
        return None
    return sum(xs) / len(m.unit_seconds) / 1e6
