"""Timing and profiling: the MEASURE_TIMES equivalent and trace capture.

Counterpart of ``rmcl_tpu.utils.timing``. On the card, PyTorch returns
before the device finishes, so every timed region ends in :func:`sync`
(``torch.cuda.synchronize()`` on the devices of the tensors it is given)
and its time is the device's: :class:`StageTimer`'s stages, the
:class:`StopWatch`'s segments and :func:`timeit_device` (CUDA events on the
card). :func:`device_trace` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


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
    """Named-stage accumulator with an EMA and totals. Pass ``block_on``
    (what the stage produced, or a callable returning it) to time device
    work: the stage then ends in :func:`sync` of it."""

    def __init__(self, ema_alpha: float = 0.1):
        self.alpha = ema_alpha
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(block_on() if callable(block_on) else block_on)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.ema[name] = (dt if name not in self.ema
                              else (1 - self.alpha) * self.ema[name] + self.alpha * dt)

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
