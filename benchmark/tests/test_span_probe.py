"""The span probe (``scripts/torch_span_probe.py``) on the CPU: its
reduction of a profiler trace by the program's spans, and a cut-down cell
run through it. Goes with the probe once the benchmark reads the program's
spans itself."""

from __future__ import annotations

import json

from benchmark import run
from benchmark import trace
from benchmark.tests.conftest import shrink
from scripts import torch_span_probe as probe


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace(tmp_path, program=True):
    """A synthetic Chrome trace: a window of 100 us with one correction
    (bench.step) whose program spans nest three deep, device work in five
    pieces, and runtime syncs and launches."""
    ev = [_x("bench.window", "user_annotation", 0, 100),
          _x("bench.ingest", "user_annotation", 0, 10),
          _x("bench.step", "user_annotation", 10, 80),
          _x("bench.readback", "user_annotation", 90, 10),
          _x("cull_kernel<128, 1>(float const*)", "kernel", 8, 2.5),
          _x("intersect_bins_kernel(float const*)", "kernel", 20, 10),
          _x("void at::native::reduce_kernel<512>", "kernel", 50, 5),
          _x("void at::native::reduce_kernel<512>", "kernel", 66, 1),
          _x("Memcpy DtoH", "gpu_memcpy", 95, 2),
          _x("cudaLaunchKernel", "cuda_runtime", 18, 1),
          _x("cudaLaunchKernel", "cuda_runtime", 45, 1),
          _x("cuLaunchKernel", "cuda_runtime", 60, 1),
          _x("cudaStreamSynchronize", "cuda_runtime", 70, 5),
          _x("cudaMemcpyAsync", "cuda_runtime", 93, 1),
          _x("cudaStreamSynchronize", "cuda_runtime", 94, 4),
          _x("cudaStreamSynchronize", "cuda_runtime", 150, 4)]  # after the window
    if program:
        ev += [_x("rmcl.micp.step", "user_annotation", 11, 78),
               _x("rmcl.micp.correspond", "user_annotation", 12, 30),
               _x("rmcl.cast.intersect", "user_annotation", 15, 10),
               _x("rmcl.micp.optimize", "user_annotation", 42, 46),
               _x("rmcl.micp.solve", "user_annotation", 65, 20)]
    path = tmp_path / ("p.json" if program else "b.json")
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_reduction_names_gaps_syncs_and_launches_by_the_innermost_span(tmp_path):
    t = probe.reduce_program_trace(_trace(tmp_path))
    # gaps [0, 8], [10.5, 20], [30, 50], [55, 66], [67, 95], [97, 100], each
    # by the innermost span open at its start
    gaps = {n: round(s * 1e6, 6) for n, s in t.gaps}
    assert gaps == {"bench.ingest": 8.0, "bench.step": 9.5, "rmcl.micp.correspond": 20.0,
                    "rmcl.micp.optimize": 11.0, "rmcl.micp.solve": 28.0, "bench.readback": 3.0}
    assert [n for n, _ in t.gaps][0] == "rmcl.micp.solve"  # longest first
    assert t.syncs == {"rmcl.micp.solve": 1, "bench.readback": 1}
    assert t.launches == {"rmcl.cast.intersect": 1, "rmcl.micp.optimize": 2}
    assert t.program_spans == 5 and t.in_program(t.syncs) == 1
    m = probe.metrics("correction", 1, None, {}, t)
    assert m["micpl.syncs"] == 1 and m["micpl.launches"] == 3
    assert m["micpl.correspond_host_ms"] is None  # no store
    assert sorted(p.name for p in tmp_path.iterdir()) == ["p.json"]  # the copy is gone


def test_reduction_without_program_spans_keeps_the_benchmark_figures(tmp_path):
    path = _trace(tmp_path, program=False)
    t = probe.reduce_program_trace(path)
    base = trace.reduce_chrome_trace(path, 1)
    assert t.gaps == base.gaps and t.program_spans == 0
    with_program = trace.reduce_chrome_trace(_trace(tmp_path), 1)
    for f in ("busy_s", "window_s", "op_seconds", "gaps", "kernel_launches", "units"):
        assert getattr(with_program, f) == getattr(base, f), f
    for unit in ("correction", "cycle"):
        assert all(v is None for v in probe.metrics(unit, 1, None, {}, t).values())


def test_probe_reads_the_program_in_a_cpu_run_of_a_cell():
    """The cut-down MICP-L cell on the CPU through the probe, traced: the
    program's spans are read, and the cell's own result is whole."""
    from rmcl_tpu_torch.utils import timing

    cell = "micpl-rc-bins"
    r = probe.run_probe(cell, 2**31 + 5, 1.0, True, device="cpu", edit=shrink)
    assert r["correct"] and r["attempted"] > 0 and "breakdown" in r
    p = r["program"]
    assert p["units"] > 0 and p["metrics"]["micpl.correspond_host_ms"] > 0
    assert p["metrics"]["micpl.optimize_host_ms"] > 0
    assert p["metrics"]["micpl.syncs"] == 0  # no card: no runtime calls
    # the configuration's 5 iterations a correction
    assert p["spans_ms"]["rmcl.micp.iteration"][1] == 5 * p["units"]
    assert len(p["idle_gaps"]) == 1  # no device events: the window is one gap
    assert set(r["metrics"]) <= {m["name"] for m in run.cell_metrics(
        run.load_benchmark(), cell)[1]}
    assert not timing.tracing()
