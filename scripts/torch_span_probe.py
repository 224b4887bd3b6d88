"""One benchmark cell with the program's spans and counters on: where the
device waits, by the program's own spans.

    python -m scripts.torch_span_probe --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--out FILE]

On the card, from the repo root. The cell runs as ``benchmark/run.py`` runs
it, with ``rmcl_tpu_torch.utils.timing``'s tracing switched on for the
traced slice (``--trace 1``), or for the whole window (``--trace 0``: the
end-to-end metrics with tracing on, to set beside a plain run for its
cost). The result line is the benchmark's, with "program" added: with
``--trace 1``, the traced slice's idle gaps by the innermost ``bench.*`` or
``rmcl.*`` span open at their start, and the CUDA runtime's synchronising
calls and kernel launches by the innermost span open at theirs; in both
modes the program's span store (host ms a unit: total, count, longest), its
counters a unit, and the readings that the per-layer metrics below would
take (None where nothing of the program's was recorded).

The probe stands in for the benchmark until ``benchmark/run.py`` and
``benchmark/trace.py`` read the program's spans and counters themselves;
it and its tests (``benchmark/tests/test_span_probe.py``) go then.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402
from benchmark import trace as bench_trace  # noqa: E402

# the CUDA runtime's calls that wait for the device: explicit syncs, and a
# synchronous copy (a copy to or from pageable host memory, as ``.cpu()``,
# ``float()`` of a device tensor or a tensor made from a Python value, is a
# ``cudaMemcpyAsync`` followed by ``cudaStreamSynchronize``)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
# the benchmark's reduction, as imported (``run_probe`` swaps the harness's)
_reduce_chrome_trace = bench_trace.reduce_chrome_trace


def is_sync(name: str) -> bool:
    return name in SYNC_CALLS


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES)


@dataclasses.dataclass
class ProgramTrace:
    """A traced slice by the program's spans: idle seconds by the innermost
    span open at a gap's start, and runtime syncs and kernel launches by the
    innermost span open at each call's start ("bench.between_calls" where
    none is open); ``program_spans``, how many ``rmcl.*`` ranges it holds."""

    gaps: List[list]
    syncs: Dict[str, int]
    launches: Dict[str, int]
    program_spans: int

    def in_program(self, counts: Dict[str, int]) -> int:
        return sum(n for k, n in counts.items() if k.startswith("rmcl."))


def _innermost(spans, t: float, default: str = "bench.between_calls") -> str:
    open_ = [s for s in spans if s[0] <= t < s[1]]
    return min(open_, key=lambda s: s[1] - s[0])[2] if open_ else default


def reduce_program_trace(path: str, units: int = 1) -> ProgramTrace:
    """Reduce a Chrome trace written by ``torch.profiler`` by the
    ``bench.*`` and ``rmcl.*`` ranges in it. The gaps are the benchmark's
    own reduction (``benchmark.trace.reduce_chrome_trace``, which reads
    ``bench.*`` ranges alone) run on a copy of the trace in which the
    ``rmcl.*`` ranges carry a ``bench.`` prefix; the syncs and launches by
    span are the probe's, counted inside the ``bench.window`` range."""
    with open(path) as f:
        trace = json.load(f)
    spans, calls = [], []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e["name"]
        t0 = float(e["ts"])
        if cat == "user_annotation" and name.startswith(("bench.", "rmcl.")):
            spans.append((t0, t0 + float(e.get("dur", 0.0)), name))
            if name.startswith("rmcl."):
                e["name"] = "bench." + name
        elif cat.startswith("cuda_") and (is_sync(name) or is_launch(name)):  # CUDA API calls
            calls.append((t0, name))
    relabelled = Path(str(path) + ".program.json")
    relabelled.write_text(json.dumps(trace))
    try:
        gaps = _reduce_chrome_trace(str(relabelled), units).gaps
    finally:
        relabelled.unlink()
    gaps = [[n[len("bench."):] if n.startswith("bench.rmcl.") else n, s] for n, s in gaps]
    marks = [s for s in spans if s[2] == "bench.window"]
    w0, w1 = (marks[0][0], marks[0][1]) if marks else (float("-inf"), float("inf"))
    inner = [s for s in spans if s[2] != "bench.window"]
    syncs: Dict[str, int] = defaultdict(int)
    launches: Dict[str, int] = defaultdict(int)
    for t, name in calls:
        if w0 <= t < w1:
            (syncs if is_sync(name) else launches)[_innermost(inner, t)] += 1
    n_program = sum(1 for s in inner if s[2].startswith("rmcl."))
    return ProgramTrace(gaps, dict(syncs), dict(launches), n_program)


def _per_unit(x, units: int, scale: float = 1.0) -> Optional[float]:
    return None if x is None or not units else scale * x / units


def metrics(unit: str, units: int, store, counters: Dict[str, float],
            program: Optional[ProgramTrace]) -> Dict[str, Optional[float]]:
    """The per-layer readings a unit (a correction or a cycle) of the slice:
    host ms in spans of the program's store, a counter, and runtime syncs
    and launches inside ``rmcl.*`` spans. None where the program recorded
    nothing: no store (a program without tracing), no such span or
    counter, or no ``rmcl.*`` range in the trace."""
    total = dict(store.total) if store is not None else {}
    waits = [v for k, v in total.items() if k.startswith("rmcl.mcl.") and k.endswith(".wait")]
    seen = program is not None and program.program_spans > 0
    syncs = program.in_program(program.syncs) if seen else None
    launches = program.in_program(program.launches) if seen else None
    pairs = counters.get("rmcl.cast.pairs")
    if unit == "correction":
        return {
            "micpl.correspond_host_ms": _per_unit(total.get("rmcl.micp.correspond"), units, 1e3),
            "micpl.optimize_host_ms": _per_unit(total.get("rmcl.micp.optimize"), units, 1e3),
            "micpl.syncs": _per_unit(syncs, units),
            "micpl.launches": _per_unit(launches, units),
        }
    return {
        "mcl.cast_pairs_m": _per_unit(pairs, units, 1e-6),
        "mcl.syncs.tail": _per_unit(syncs, units),
        "mcl.launches.tail": _per_unit(launches, units),
        "mcl.stage_wait_ms.tail": _per_unit(sum(waits) if waits else None, units, 1e3),
    }


def _program_timing():
    """The program's timing module, or None where it has no tracing switch."""
    from rmcl_tpu_torch.utils import timing

    return timing if hasattr(timing, "set_tracing") else None


class ProgramWindow(bench_run.Window):
    """The benchmark's window with the program's tracing on over the traced
    slice (over the whole window when nothing is traced)."""

    @contextlib.contextmanager
    def __call__(self, slice_s: float):
        timing = _program_timing()
        if timing is None:
            with super().__call__(slice_s) as in_trace:
                yield in_trace
            return
        timing.set_tracing(True)
        try:
            with super().__call__(slice_s) as in_trace:
                def in_slice() -> int:
                    k = in_trace()
                    if self.launches is not None:  # the traced slice has ended
                        timing.set_tracing(False)
                    return k

                yield in_slice
        finally:
            timing.set_tracing(False)


def cell_unit(workload: str, root: Path = ROOT) -> str:
    """The cell's unit of work ("correction" or "cycle"): its system's."""
    import importlib

    bench = bench_run.load_benchmark(root)
    cell = bench_run.find(bench["workloads"], workload, "workload")
    conf = bench_run.find(bench["configs"], cell["config"], "config")
    with open(root / conf["file"]) as f:
        system = json.load(f)["system"]
    return importlib.import_module(f"benchmark.systems.{system}").UNIT


def run_probe(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
              edit=None, root: Path = ROOT) -> dict:
    """``benchmark.run.run_cell`` with the program's tracing on; the result
    with "program" added (module docstring)."""
    reduced = []

    def reduce(path, units):
        reduced.append((reduce_program_trace(path, units), units))
        return _reduce_chrome_trace(path, units)

    with mock.patch.object(bench_run, "Window", ProgramWindow), \
            mock.patch.object(bench_trace, "reduce_chrome_trace", reduce):
        result = bench_run.run_cell(workload, seed, seconds, trace, device=device, edit=edit,
                                    root=root)
    timing = _program_timing()
    store = timing.store() if timing is not None else None
    counters = timing.counters() if timing is not None else {}
    program, units = reduced[0] if reduced else (None, result["attempted"])
    out = {"units": units,
           "metrics": metrics(cell_unit(workload, root), units, store, counters, program)}
    if store is not None:
        out["spans_ms"] = {k: [1e3 * store.total[k] / max(units, 1), store.count[k],
                               1e3 * store.max[k]] for k in sorted(store.total)}
        out["counters"] = {k: v / max(units, 1) for k, v in sorted(counters.items())}
    if program is not None:
        out["idle_gaps"] = program.gaps
        out["syncs"] = dict(sorted(program.syncs.items(), key=lambda kv: -kv[1]))
        out["launches"] = dict(sorted(program.launches.items(), key=lambda kv: -kv[1]))
    result["program"] = out
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None, help="also append the line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_span_probe: needs a CUDA card", file=sys.stderr)
        return 2
    # as benchmark/run.py: one process on two fixed cores, one thread
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cpus[-2:]))
    torch.set_num_threads(1)
    result = run_probe(args.workload, args.seed, args.seconds, bool(args.trace))
    line = json.dumps(dict(result, workload=args.workload, seed=args.seed, trace=args.trace))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
