"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m benchmark.run``) from the root of a checkout.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration's file, ``benchmark/traffic/<traffic>.json``, the system that
drives the configuration's node (``benchmark/systems/<system>.py``), the
cell's limits (``benchmark/limits/<cell>.json``) and each metric's reader
(``benchmark/metrics/<metric>.py``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and a
breakdown of the traced part of the window.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:  # run as a script: the checkout's root holds both packages
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "rmcl_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Measurement:
    """What the metric readers read. ``unit`` is the cell's unit of work
    ("correction" or "cycle"), ``unit_seconds`` each one's time in the
    window, ``spans`` host-clock spans by name (seconds), ``trace`` the
    traced slice (None without ``--trace 1``, or where the trace lost hand
    kernels' launches)."""

    unit: str
    unit_seconds: List[float]
    window_s: float
    setup_s: float
    spans: Dict[str, List[float]]
    trace: Optional[object]


class Window:
    """The measured window's context: marks its start and, traced, profiles
    its first ``slice_s`` seconds (spans become profiler ranges), counts the
    hand kernels' launches over that slice and writes its trace."""

    def __init__(self, spans, trace_path: Optional[Path]):
        self.spans = spans
        self.path = trace_path
        self.start = None
        self.launches = None

    @contextlib.contextmanager
    def __call__(self, slice_s: float):
        import torch

        from benchmark import trace

        if self.path is None:
            self.start = time.perf_counter()
            yield lambda: 0
            return
        from torch.profiler import ProfilerActivity, profile

        before = trace.launch_counts()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        self.spans.tracing = True
        mark = torch.profiler.record_function("bench.window")
        mark.__enter__()
        state = {"on": True}
        self.start = time.perf_counter()

        def stop():
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            mark.__exit__(None, None, None)
            self.spans.tracing = False
            after = trace.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            prof.stop()
            state["on"] = False

        def in_trace() -> int:
            if not state["on"]:
                return 0
            if time.perf_counter() - self.start >= slice_s:
                stop()
            return 1

        try:
            yield in_trace
        finally:
            if state["on"]:
                stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             edit=None, control: bool = False, root: Path = ROOT) -> dict:
    """One run of a cell; returns the result (the line's object). ``edit``
    (tests) changes the loaded configuration and traffic in place;
    ``control`` adds, under "control", the readings of the reference with
    TF32 matrix products put in the program's place."""
    import torch

    from benchmark import trace as tr_
    from benchmark import traffic as traffic_mod

    bench = load_benchmark(root)
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    traffic = traffic_mod.load("traffic", cell["traffic"], root / "benchmark")
    limits = traffic_mod.load("limits", workload, root / "benchmark")
    if edit is not None:
        edit(cfg, traffic)
    system = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    dev = torch.device(device)
    spans = tr_.Spans()
    prepared = system.prepare(cfg, traffic, dev, spans)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trace_path = HERE / "cache" / "traces" / f"trace-{os.getpid()}.json" if trace else None
    window = Window(spans, trace_path)
    outcome = system.run(prepared, seed, seconds, spans, window)
    setup_s = window.start - PROCESS_START
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        device_info["memory_peak_bytes"] = 0
    # the configuration's guarantees, read from the program's state while
    # it is still there (after the peak, so they do not raise it)
    guarantees = getattr(system, "guarantees", lambda *a: {})(prepared, outcome)
    device_trace = None
    if trace:
        device_trace = tr_.reduce_chrome_trace(str(trace_path), outcome.trace_units)
        trace_path.unlink()
        device_info["busy_s"] = device_trace.busy_s
        device_info["window_s"] = device_trace.window_s
        counted = window.launches or {}
        lines = [f"{k} {device_trace.kernel_launches.get(k, 0)}/{n}"
                 for k, n in sorted(counted.items()) if n]
        print("trace launches (in the trace / counted by the program): " + ", ".join(lines),
              file=sys.stderr)
        if any(device_trace.kernel_launches.get(k, 0) != n for k, n in counted.items()):
            print("trace lost hand-kernel launches: its kernel metrics are left out",
                  file=sys.stderr)
            device_trace.complete = False
        else:
            device_trace.complete = True
    system.release(prepared)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = dict(system.readings(prepared, outcome, seed), **guarantees)
    if control:
        from benchmark.reference.se3 import TF32

        control_checks = system.readings(prepared, outcome, seed, control=TF32)
    setup = {k: round(sum(v), 3) for k, v in spans.times.items() if k.startswith("setup.")}
    print(f"setup spans (s): {setup}; window {outcome.window_s:.3f} s; check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(checks[k] <= limits[k] for k in limits) and set(checks) == set(limits)
    m = Measurement(system.UNIT, outcome.unit_seconds, outcome.window_s, setup_s,
                    dict(spans.times), device_trace)
    e2e, layer = cell_metrics(bench, workload)
    metrics = {}
    for entry in (layer if trace else e2e):
        value = reader(entry["name"], root / "benchmark")(m)
        if value is None and not trace:
            raise RuntimeError(f"{workload} does not report {entry['name']}")
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": bool(correct), "attempted": len(outcome.unit_seconds),
              "failed": int(getattr(outcome, "failed", 0)), "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = device_trace.breakdown()
    if control:
        result["control"] = control_checks
    result["checks"] = {k: {"value": checks[k], "limit": limits.get(k)} for k in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = find(load_benchmark()["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # one process on two fixed cores, one intra-op thread: the node's host
    # path sets the pace of the MICP-L cells, and a process that migrates
    # between cores runs it up to a fifth slower in some runs than in others
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cpus[-2:]))
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
