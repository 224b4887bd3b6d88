"""The harness finds everything by name, and BENCHMARK.json keeps to the
benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT, shrink

BENCH = run.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        conf = run.find(BENCH["configs"], cell["config"], "config")
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert (ROOT / "benchmark" / "systems" / f"{cfg['system']}.py").is_file()
        assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{cell['name']}.json").is_file()
        e2e, layer = run.cell_metrics(BENCH, cell["name"])
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and layer
        for m in e2e + layer:
            assert callable(run.reader(m["name"], ROOT / "benchmark"))


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and len(BENCH["command"]) <= 32
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    cfg_names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A new traffic file, limits file and BENCHMARK.json entry in a copy:
    the harness runs the new cell without an edit to any existing file."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = dict(bench["workloads"][0], name="micpl-rc-bins-5hz", traffic="loop-5hz-rc")
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if bench["workloads"][0]["name"] in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "benchmark/traffic/loop-10hz-rc.json").read_text())
    traffic["scan_rate_hz"] = 5.0
    (tmp_path / "benchmark/traffic/loop-5hz-rc.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "benchmark/limits/micpl-rc-bins.json",
                tmp_path / "benchmark/limits/micpl-rc-bins-5hz.json")
    r = run.run_cell("micpl-rc-bins-5hz", 3, 1.0, False, device="cpu", edit=shrink,
                     root=tmp_path)
    assert r["correct"] and r["attempted"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    cell = BENCH["workloads"][0]["name"]
    r = run.run_cell(cell, 2**31 + 11, 1.0, trace, device="cpu", edit=shrink)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    e2e, layer = run.cell_metrics(BENCH, cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    json.loads(json.dumps(r))


def test_no_result_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
