"""Spans from the benchmark's own calls, and the reduction of a profiler
trace to what the per-layer metrics read.

Spans are host-clock intervals around the calls into the program. In a
traced slice each span is also a ``record_function`` range, so the trace
places it on the device's time line, where it names the idle gaps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# the program's hand kernels by their CUDA function names (csrc/*.cu)
HAND_KERNELS = {
    "intersect_bins_kernel": "K1",
    "intersect_groups_kernel": "K2g",
    "cull_kernel": "K3",
    "factored_tile_kernel": "K4",
    "factored_ray_kernel": "K4",
    "traverse_bvh_kernel": "K5",
    "closest_bvh_kernel": "K6",
    "closest_bvh_split_kernel": "K6",
    "closest_bins_kernel": "K6b",
    "cull_boxes_kernel": "K7",
}

# where the program counts each hand kernel's launches: (module, function)
LAUNCH_COUNTERS = {
    "K1": ("rmcl_tpu_torch.ops.raycast_cuda", "intersect_bins"),
    "K2g": ("rmcl_tpu_torch.ops.raycast_cuda", "intersect_groups"),
    "K3": ("rmcl_tpu_torch.ops.cull_cuda", ("cull_rays", "cull_factored", "cull_blocks")),
    "K4": ("rmcl_tpu_torch.ops.raycast_cuda", "intersect_factored"),
    "K5": ("rmcl_tpu_torch.ops.traverse_cuda", "traverse_rays"),
    "K6": ("rmcl_tpu_torch.ops.closest_cuda", "closest_bvh"),
    "K6b": ("rmcl_tpu_torch.ops.closest_cuda", "closest_bins"),
    "K7": ("rmcl_tpu_torch.ops.closest_cuda", "cp_candidates"),
}


def hand_kernel(name: str) -> Optional[str]:
    """The hand kernel a device operation's name belongs to, or None."""
    for fn, k in HAND_KERNELS.items():
        if fn + "(" in name or fn + "<" in name or name == fn:
            return k
    return None


def launch_counts() -> Dict[str, int]:
    """The program's own launch counters, by hand kernel."""
    import importlib

    out = {}
    for k, (mod, fns) in LAUNCH_COUNTERS.items():
        m = importlib.import_module(mod)
        fns = fns if isinstance(fns, tuple) else (fns,)
        out[k] = sum(int(getattr(getattr(m, f), "launches", 0)) for f in fns)
    return out


class Spans:
    """Named host-clock intervals, and a ``record_function`` range for each
    while a profiler runs."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.times[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class DeviceTrace:
    """A traced slice reduced: device seconds by operation name, hand-kernel
    launches by kernel, busy and window seconds, the longest idle gaps by
    the host span open at their start, and the count of the units (the
    corrections or cycles) that the slice held."""

    op_seconds: Dict[str, float]
    kernel_launches: Dict[str, int]
    busy_s: float
    window_s: float
    gaps: List[tuple]
    units: int
    complete: bool = True

    def hand_seconds(self, kernels) -> float:
        return sum(s for n, s in self.op_seconds.items() if hand_kernel(n) in kernels)

    def other_seconds(self) -> float:
        """Device seconds of every operation that is not a hand kernel."""
        return sum(s for n, s in self.op_seconds.items() if hand_kernel(n) is None)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": self.gaps[:10]}


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def kernels_ms_per_unit(m, kernels) -> Optional[float]:
    """Device ms a unit of the traced slice spent in the hand kernels
    ``kernels``; None without a complete trace or where none launched."""
    t = m.trace
    if t is None or not t.complete or not t.units:
        return None
    if not any(t.kernel_launches.get(k, 0) for k in kernels):
        return None
    return 1e3 * t.hand_seconds(kernels) / t.units


def idle_pct(m) -> Optional[float]:
    """Share of the traced slice in which no operation ran on the device."""
    t = m.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def span_median_ms(m, name: str) -> Optional[float]:
    import statistics

    xs = m.spans.get(name)
    return 1e3 * statistics.median(xs) if xs else None


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_chrome_trace(path: str, units: int) -> DeviceTrace:
    """Reduce a Chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    op_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for t0, t1, name in dev:
        op_s[name] += (t1 - t0) * 1e-6
        k = hand_kernel(name)
        if k:
            launches[k] += 1
    marks = [s for s in spans if s[2] == "bench.window"]
    if marks:
        w0, w1 = marks[0][0], marks[0][1]
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        w0 = w1 = 0.0
    busy, gaps, cursor = 0.0, [], w0
    for t0, t1, _ in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= cursor:
            continue
        if t0 > cursor:
            gaps.append((cursor, t0))
        busy += t1 - max(t0, cursor)
        cursor = t1
    if w1 > cursor:
        gaps.append((cursor, w1))
    inner = [s for s in spans if s[2] != "bench.window"]
    labelled = defaultdict(float)
    for g0, g1 in gaps:
        open_ = [s for s in inner if s[0] <= g0 < s[1]]
        label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "bench.between_calls"
        labelled[label] += (g1 - g0) * 1e-6
    top = sorted(labelled.items(), key=lambda kv: -kv[1])
    return DeviceTrace(dict(op_s), dict(launches), busy * 1e-6, (w1 - w0) * 1e-6,
                       [[n, s] for n, s in top], units)
