"""The closest-point MICP-L cell (``micpl-cp-bins``) on the CPU at a small
size: a sound run passes, its result line carries its metrics, and each
fault it can have fails the check held against it: the JAX node's
closest-point query (its budgets the ray audit's, its last query block
padded with origin queries), a closest-point gate of 5 cm (2 cm on the
small map) where the configuration states 0.5 m, and the control (the reference in TF32 put in
the program's place). On the card the same faults run at the cell's size
and print their readings (``-s``): the limits sit between them and the sound
runs'::

    python -m pytest benchmark/tests/test_bench_micpl_cp.py -m cuda -s -o addopts=
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import shrink

CELL = "micpl-cp-bins"


def _run(seconds=2.0, edit=shrink, trace=False, control=False, seed=2**31 + 5):
    return run.run_cell(CELL, seed, seconds, trace, device="cpu", edit=edit, control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_pass_and_report(trace):
    r = _run(trace=trace)
    assert r["correct"] and r["attempted"] >= 6, r["checks"]
    assert r["checks"]["truncated_blocks"]["value"] == 0
    e2e, layer = run.cell_metrics(run.load_benchmark(), CELL)
    if trace:
        # the CPU trace has no device time: the kernels' reader stays silent
        assert {"micpl.closest_pairs_m", "micpl.ingest_ms", "micpl.idle_pct",
                "setup.map_build_s"} <= set(r["metrics"])
        assert set(r["metrics"]) <= {m["name"] for m in layer}
        assert r["metrics"]["micpl.closest_pairs_m"]["value"] > 0
    else:
        assert set(r["metrics"]) == {m["name"] for m in e2e}


def jax_cp_query(monkeypatch, full):
    """The JAX node's closest-point query: budgets from the ray audit
    alone (its one pair; on the small map, where the ray audit keeps the
    configured 24/96 and nothing truncates, one entry a level) and the last
    query block padded with origin queries, whose box then reaches the
    map's corner."""
    from rmcl_tpu_torch.micp import node
    from rmcl_tpu_torch.ops import closest_point

    def origin_padding(q, max_d2, block_size=128):
        n_pad = (-q.shape[0]) % block_size
        q = torch.cat([q, q.new_zeros((n_pad, 3))])
        max_d2 = torch.cat([max_d2, max_d2.new_zeros((n_pad,))])
        return q.reshape(-1, block_size, 3), max_d2.reshape(-1, block_size)

    def ray_audit(self, sensor_data):
        if full:  # the JAX node audits every sensor's rays, CP ones included
            self._check_budgets(sensor_data)
        else:
            self.micp_config = dataclasses.replace(self.micp_config, c_super=1, c_bin=1)

    monkeypatch.setattr(closest_point, "query_blocks", origin_padding)
    monkeypatch.setattr(node.MICPLocalization, "_check_cp_budgets", ray_audit)


def narrow_gate(monkeypatch, full):
    """The program's closest-point query gated at 5 cm where the
    configuration, and so the reference, states 0.5 m; on the small map 2
    cm: there a tracked pose's points lie within 5 cm of the surface once
    the start is taken up, and a 5 cm gate changes no correction after the
    window's first few (the check draws its corrections from the whole
    window)."""
    from rmcl_tpu_torch.micp import pipeline

    real, gate = pipeline.find_cpc, 0.05 if full else 0.02
    monkeypatch.setattr(pipeline, "find_cpc",
                        lambda bvh, points, mask, tsm, max_dist, **k:
                        real(bvh, points, mask, tsm, gate, **k))


# each fault and the checks held against it (any one of them fails)
FAULTS = {"jax_cp_query": (jax_cp_query, ("truncated_blocks",)),
          "narrow_gate": (narrow_gate, ("match_gap", "pose_gap_m"))}


def _fault_run(name, monkeypatch, full=False, seed=2**31 + 5):
    fault, checks = FAULTS[name]
    fault(monkeypatch, full)
    r = run.run_cell(CELL, seed, 5.0, False) if full else _run(seed=seed)
    if full:
        print(json.dumps({"fault": name, "seed": seed,
                          "checks": {k: c["value"] for k, c in r["checks"].items()}}))
    assert not r["correct"]
    assert any(r["checks"][c]["value"] > r["checks"][c]["limit"] for c in checks)
    return r


def test_the_jax_cp_query_fails(monkeypatch):
    _fault_run("jax_cp_query", monkeypatch)


def test_a_narrow_gate_fails(monkeypatch):
    _fault_run("narrow_gate", monkeypatch)


def test_the_control_fails():
    r = _run(control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert r["correct"]
    assert any(v > limits[k] for k, v in r["control"].items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_each_fault_fails_on_the_card_at_the_cells_size(name, card, monkeypatch):
    _fault_run(name, monkeypatch, full=True, seed=7000000000 + sorted(FAULTS).index(name))


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size(card):
    for seed in (31, 32):
        r = run.run_cell(CELL, seed, 5.0, False, control=True)
        limits = {k: c["limit"] for k, c in r["checks"].items()}
        print(json.dumps({"control": seed, "program": {k: c["value"] for k, c in
                                                       r["checks"].items()},
                          "tf32": r["control"]}))
        assert r["correct"]
        assert any(v > limits[k] for k, v in r["control"].items() if k in limits)
