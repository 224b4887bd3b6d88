"""Timing and profiling: the MEASURE_TIMES equivalent, the program's spans
and counters, and trace capture.

Counterpart of ``rmcl_tpu.utils.timing``. On the card, PyTorch returns
before the device finishes, so every timed region ends in :func:`sync`
(``torch.cuda.synchronize()`` on the devices of the tensors it is given)
and its time is the device's: :class:`StageTimer`'s stages, the
:class:`StopWatch`'s segments and :func:`timeit_device` (CUDA events on the
card). :func:`device_trace` records a ``torch.profiler`` trace.

Spans and counters (one process-wide switch, :func:`set_tracing`): the
correction and the MCL cycle open :func:`span` at their layers' bounds
(names ``rmcl.<layer>.<part>``) and count work with :func:`count` (host
integers) and :func:`count_device` (device tensors, never read back on the
way). Off, the default, a span is one shared no-op object and a count
returns at once: no profiler range, clock read, allocation, device
operation or sync. On, each span is a ``torch.profiler.record_function``
range, so a running profiler places it on the device's time line, and its
host-clock time goes into the process-wide :class:`StageTimer`,
:func:`store`; :func:`counters` reads the counts back once. Turning the
switch on empties the store and the counters.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

_TRACING = False


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, a dataclass of
    tensors or a list, tuple or dict of them)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif hasattr(tree, "__dataclass_fields__"):
        tree = [getattr(tree, f) for f in tree.__dataclass_fields__]
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in tree))
    return set()


def sync(tree):
    """Wait for the device work that produced ``tree`` and return it:
    ``torch.cuda.synchronize`` on each CUDA device its tensors lie on (CPU
    work is done when it returns). Every timed region ends here."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


class StopWatch:
    """rmagine-style stopwatch: ``sw(); ...; elapsed = sw()`` (seconds of
    host clock; :func:`sync` what the segment produced before reading)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def __call__(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt


class StageTimer:
    """Named-stage accumulator: totals, counts, the longest and an EMA by
    name. Pass ``block_on`` (what the stage produced, or a callable
    returning it) to time device work: the stage then ends in :func:`sync`
    of it. With tracing on, a stage is the span ``<prefix><name>`` and its
    sync the child span ``<prefix><name>.wait``. The process-wide
    :func:`store` of the spans is one of these."""

    def __init__(self, ema_alpha: float = 0.1, prefix: str = "rmcl."):
        self.alpha = ema_alpha
        self.prefix = prefix
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.max: Dict[str, float] = defaultdict(float)

    def add(self, name: str, dt: float) -> None:
        """Account ``dt`` seconds to ``name``."""
        self.total[name] += dt
        self.count[name] += 1
        self.max[name] = max(self.max[name], dt)
        self.ema[name] = (dt if name not in self.ema
                          else (1 - self.alpha) * self.ema[name] + self.alpha * dt)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with span(self.prefix + name) if _TRACING else _NO_SPAN:
            try:
                yield
            finally:
                with span(self.prefix + name + ".wait") if _TRACING else _NO_SPAN:
                    sync(block_on() if callable(block_on) else block_on)
                self.add(name, time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        c = self.count.get(name, 0)
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name:30s} mean {self.mean(name)*1e3:8.2f} ms  "
                f"ema {self.ema.get(name, 0)*1e3:8.2f} ms  n={self.count[name]}"
            )
        return "\n".join(lines)


class _NoSpan:
    """The span while tracing is off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Span:
    """A traced span: a profiler range, and its host time into the store."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _STORE.add(self.name, dt)
        return False


_NO_SPAN = _NoSpan()
_STORE = StageTimer()
_COUNTS: Dict[str, int] = defaultdict(int)
_DEVICE_COUNTS: Dict[str, torch.Tensor] = {}


def set_tracing(on: bool) -> None:
    """Turn the program's spans and counters on or off, process-wide.
    Turning them on empties the store and the counters; off keeps both for
    reading."""
    global _TRACING, _STORE
    if on:
        _STORE = StageTimer()
        _COUNTS.clear()
        _DEVICE_COUNTS.clear()
    _TRACING = bool(on)


def tracing() -> bool:
    return _TRACING


def span(name: str):
    """A context for the program's span ``name`` (a constant string); the
    shared no-op object while tracing is off."""
    return _Span(name) if _TRACING else _NO_SPAN


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` (tracing on)."""
    if _TRACING:
        _COUNTS[name] += int(n)


def count_device(name: str, tensor: torch.Tensor, weight: int = 1) -> None:
    """Add ``weight`` times the sum of ``tensor`` to the counter ``name``
    (tracing on): on the tensor's device, read back only by
    :func:`counters`."""
    if not _TRACING:
        return
    dtype = torch.float64 if tensor.is_floating_point() else torch.int64
    total = torch.sum(tensor, dtype=dtype) * weight
    if name in _DEVICE_COUNTS:
        _DEVICE_COUNTS[name].add_(total)
    else:
        _DEVICE_COUNTS[name] = total


def store() -> StageTimer:
    """The spans recorded since tracing was last turned on (host seconds)."""
    return _STORE


def counters() -> Dict[str, float]:
    """Every counter since tracing was last turned on; reads the device
    counters back (one sync each)."""
    out: Dict[str, float] = dict(_COUNTS)
    for name, acc in _DEVICE_COUNTS.items():
        out[name] = out.get(name, 0) + acc.item()
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (the host, and the card when there
    is one) around a block; written to ``log_dir`` as a Chrome trace."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def timeit_device(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best of ``iters`` runs of ``fn(*args)`` after ``warmup``, in seconds:
    by CUDA events when its output lies on the card, else by the host clock
    after :func:`sync`."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    devs = _cuda_devices(sync(out))
    best = float("inf")
    for _ in range(iters):
        if devs:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            sync(fn(*args))
            best = min(best, time.perf_counter() - t0)
    return best
