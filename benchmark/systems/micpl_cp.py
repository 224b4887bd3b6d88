"""Drive the MICP-L node with closest-point correspondences: the loop, the
timing and the check of ``benchmark/systems/micpl.py`` (the reference's
correction takes the sensor's ``CP`` type from the configuration), and the
configuration's guarantee that no cull budget truncates a query block.

A traced run turns the program's spans and counters on for the window
(``rmcl.closest.*`` among them) and copies the counters into the
benchmark's spans; untraced runs measure the program as it runs by default.
"""

from __future__ import annotations

import contextlib

from benchmark.systems import micpl
from benchmark.systems.micpl import UNIT, Outcome, Prepared, prepare, readings, release  # noqa: F401


class _ProgramTracing:
    """The window's context with the program's spans and counters on over
    the window alone (the warm-up before it stays untraced)."""

    def __init__(self, window):
        self.window = window
        self.path = window.path

    @contextlib.contextmanager
    def __call__(self, slice_s: float):
        from rmcl_tpu_torch.utils import timing

        timing.set_tracing(True)
        try:
            with self.window(slice_s) as in_trace:
                yield in_trace
        finally:
            timing.set_tracing(False)  # keeps the counters for reading


def run(p: Prepared, seed: int, seconds: float, spans, traced) -> Outcome:
    """:func:`benchmark.systems.micpl.run`; traced, with the program's
    counters over the window's corrections added to ``spans``."""
    from rmcl_tpu_torch.utils import timing

    if getattr(traced, "path", None) is None:
        return micpl.run(p, seed, seconds, spans, traced)
    outcome = micpl.run(p, seed, seconds, spans, _ProgramTracing(traced))
    for name, value in timing.counters().items():
        spans.times[name].append(float(value))
    return outcome


def guarantees(p: Prepared, outcome: Outcome):
    """Query blocks that a cull budget truncated, over every correction of
    the window: the configuration promises every point's nearest surface
    point over the whole map, and a truncated block's list can miss it. The
    program's own count (``MICPStats.truncated_blocks``, K7's ``sat``
    flags), read after the window. A program that does not count them
    reports nothing, and the run is then not correct."""
    import torch

    counts = [getattr(r.stats, "truncated_blocks", None) for r in outcome.records]
    if not counts or any(c is None for c in counts):
        return {}
    return {"truncated_blocks": int(torch.stack(counts).sum())}
