"""Each cell's check fails a broken timed path and the control.

The runs skip the look for a card and drive the rest of a run on the CPU at
a small size, with the program's step broken underneath: a step that
returns its state unchanged, half of the batch left out (the mean taken
over the rest), an answer altered where it is produced, an answer altered
only where a correction reuses the scan of the one before, and a cull
budget that truncates. One chip: no exchange between chips to leave out. The control (the reference in TF32
put in the program's place) must fail too."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import shrink

MICPL, MCL = "micpl-rc-bins", "mcl-1m-tracking"


def _correct(cell):
    return run.run_cell(cell, 2**31 + 5, 1.5, False, device="cpu", edit=shrink)["correct"]


def test_sound_runs_pass():
    assert _correct(MICPL) and _correct(MCL)


def _micpl_fault(kind):
    from rmcl_tpu_torch.micp import node, pipeline
    from rmcl_tpu_torch.math.se3 import Transform

    def broken(accel, sensors, tom, tbo, progress, config):
        if kind == "half":
            sensors = [dataclasses.replace(s, mask=s.mask & (torch.arange(len(s.mask)) % 2 == 0))
                       for s in sensors]
        tom_new, stats = pipeline.correct_once(accel, sensors, tom, tbo, progress, config=config)
        if kind == "unchanged":
            return tom, stats
        if kind == "altered":
            return Transform(rot=tom_new.rot, trans=tom_new.trans + 0.01), stats
        return tom_new, stats
    return node, broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_micpl_check_fails_a_broken_step(kind, monkeypatch):
    node, broken = _micpl_fault(kind)
    monkeypatch.setattr(node, "correct_once", broken)
    assert not _correct(MICPL)


def test_micpl_check_fails_when_only_repeat_corrections_are_wrong(monkeypatch):
    """Right on each scan's first correction, 1 mm off on the others (as
    state reused across the corrections of one scan could be)."""
    from rmcl_tpu_torch.micp import node
    from rmcl_tpu_torch.math.se3 import Transform

    real_scan, real_correct = node.MICPLocalization.on_scan, node.correct_once
    fresh = {"scan": False}

    def on_scan(self, *a, **k):
        fresh["scan"] = True
        return real_scan(self, *a, **k)

    def broken(*a, **k):
        tom, stats = real_correct(*a, **k)
        if fresh["scan"]:
            fresh["scan"] = False
            return tom, stats
        return Transform(rot=tom.rot, trans=tom.trans + 1e-3), stats

    monkeypatch.setattr(node.MICPLocalization, "on_scan", on_scan)
    monkeypatch.setattr(node, "correct_once", broken)
    r = run.run_cell(MICPL, 2**31 + 5, 3.0, False, device="cpu", edit=shrink)
    assert r["attempted"] > 12 and not r["correct"]


def test_mcl_check_fails_a_truncating_budget(monkeypatch):
    """Budgets that truncate, with the node's audit kept from raising them:
    the guarantee's count reads above its limit of 0."""
    from rmcl_tpu_torch.mcl.node import MCLNode

    def edit(cfg, traffic):
        shrink(cfg, traffic)
        cfg["node"]["sensor_update"].update(engine="binned", c_super=1, c_bin=1, c_mid=0,
                                            c_hyper=0)

    monkeypatch.setattr(MCLNode, "_check_budgets", lambda self, *a: None)
    r = run.run_cell(MCL, 2**31 + 5, 1.5, False, device="cpu", edit=edit)
    assert r["checks"]["truncated_blocks"]["value"] > 0 and not r["correct"]


@pytest.mark.parametrize("kind", ["sensor_unchanged", "resample_unchanged", "half", "altered"])
def test_mcl_check_fails_a_broken_stage(kind, monkeypatch):
    from rmcl_tpu_torch.mcl import node, sensor_update
    from rmcl_tpu_torch.math.se3 import Transform

    real_update, real_estimate = sensor_update.sensor_update, node.estimate_stats
    if kind == "sensor_unchanged":
        monkeypatch.setattr(node, "sensor_update", lambda accel, cloud, *a, **k: cloud)
    elif kind == "resample_unchanged":
        monkeypatch.setitem(node._RESAMPLERS, "gladiator", lambda cloud, *a, **k: cloud)
    elif kind == "half":
        def half(accel, cloud, *a, **k):
            new = real_update(accel, cloud, *a, **k)
            n = cloud.capacity // 2
            lik = dataclasses.replace(new.likelihood, **{
                f: torch.cat([getattr(new.likelihood, f)[:n], getattr(cloud.likelihood, f)[n:]])
                for f in ("mean", "sigma", "n_meas")})
            return dataclasses.replace(new, likelihood=lik)
        monkeypatch.setattr(node, "sensor_update", half)
    else:
        def altered(cloud, **k):
            s = real_estimate(cloud, **k)
            return dataclasses.replace(s, pose=Transform(rot=s.pose.rot, trans=s.pose.trans + 0.01))
        monkeypatch.setattr(node, "estimate_stats", altered)
    assert not _correct(MCL)


@pytest.mark.parametrize("cell", [MICPL, MCL])
def test_the_control_fails(cell):
    r = run.run_cell(cell, 2**31 + 9, 1.5, False, device="cpu", edit=shrink, control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert r["correct"]
    assert any(v > limits[k] for k, v in r["control"].items())


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size(card):
    """The control at the cell's own size (``control.py`` runs it over
    many seeds on the chip)."""
    for seed in (11, 12, 13):
        r = run.run_cell(MICPL, seed, 5.0, False, control=True)
        limits = {k: c["limit"] for k, c in r["checks"].items()}
        assert r["correct"]
        assert any(v > limits[k] for k, v in r["control"].items())
