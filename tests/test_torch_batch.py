"""The batch corrector (``rmcl_tpu_torch.micp.batch.BatchCorrector``) on the
CPU against the benchmark's plain reference (``benchmark/reference/sweep.py``:
every ray against every face, float64 Umeyama) at a small size: a 19,800-face
50 m sphere and 32 poses x VLP-16 at 90 wide. Also: a kept cull casts what a
fresh one casts, the re-cull rule, that a truncating budget is counted, and
that ``rmcl_tpu_torch.bench`` runs the corrector and reads its settings."""

import functools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import sweep as ref
from rmcl_tpu_torch.bench import SweepBench, settings_from_env
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.mesh import make_sphere
from rmcl_tpu_torch.micp.batch import BatchCorrector
from rmcl_tpu_torch.micp.tracking import needs_recull
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.utils import timing

torch.set_num_threads(2)

MODEL = SphericalModel.vlp16(width=90)
POSES = 32
OFFSET = (0.0, 0.0, 0.2)
# corrected positions: float32 means of ~1,440 points ~50 m from the origin
# round at ~4e-6 m (the reference sums in float64); measured 2.4e-6 m
TRANS_TOL = 2e-5
# increment rotations: the float32 cross-covariance against float64's;
# measured 7e-8 rad
ROT_TOL = 1e-6
# dataset points: K4's float32 ranges of ~50 m against Moller-Trumbore's,
# a few ulp (3.8e-6 m at 50 m) apart; measured 1.5e-5 m
POINT_TOL = 5e-5
CELLS = 1 << 23  # the plain caster's pairs a step (its memory)


@functools.lru_cache(maxsize=None)
def _world():
    mesh = make_sphere(100, 100, radius=50.0)
    bins = build_bins(mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16, device="cpu")
    truth = np.random.default_rng(0).uniform(-5, 5, size=(POSES, 3)).astype(np.float32)
    tri = torch.from_numpy(mesh.vertices[mesh.faces])
    return bins, truth, tri


def _corrector(**kw):
    bins, truth, _ = _world()
    kw = dict(dict(sub_blocks=8), **kw)
    return BatchCorrector(bins, MODEL, truth, **kw)


def _dataset(bc):
    truth = torch.from_numpy(_world()[1])
    points, _, hit = bc.cast(truth)
    return points - truth[:, None], hit


def _start(seed=1):
    truth = _world()[1]
    j = np.random.default_rng(seed).uniform(-0.02, 0.02, size=truth.shape).astype(np.float32)
    return torch.from_numpy(truth + np.float32(OFFSET) + j)


def test_dataset_matches_the_plain_caster():
    bc = _corrector()
    points, mask = _dataset(bc)
    truth = torch.from_numpy(_world()[1])
    dirs = MODEL.rays("cpu")[1]
    want, _, hit = ref.cast_poses(_world()[2], truth[:6], dirs, float(MODEL.range.min),
                                  float(MODEL.range.max), cells_per_chunk=CELLS)
    assert torch.equal(mask[:6], hit) and bool(hit.all())
    got = points[:6].double() + truth[:6, None].double()
    assert float(torch.linalg.norm(got - want, dim=-1).max()) < POINT_TOL


def test_corrections_match_the_plain_reference():
    """Three closed-loop steps from the reference's +0.2 m z start: every
    eighth pose's corrected position, increment rotation and pairs against
    the reference's from the same start."""
    bc = _corrector()
    data = _dataset(bc)
    dirs = MODEL.rays("cpu")[1]
    pick = torch.arange(0, POSES, 4)
    trans = _start()
    for _ in range(3):
        step = bc.step(*data, trans)
        want_t, want_r, want_n = ref.correct(
            _world()[2], dirs, data[0][pick], data[1][pick], trans[pick], bc.max_dist,
            float(MODEL.range.min), float(MODEL.range.max), cells_per_chunk=CELLS)
        np.testing.assert_allclose(step.trans[pick].double().numpy(), want_t.numpy(), rtol=0,
                                   atol=TRANS_TOL)
        got_r = step.delta.to_matrix()[pick, :3, :3].double()
        angle = torch.arccos(torch.clamp((torch.einsum("nij,nij->n", got_r, want_r) - 1) / 2,
                                         -1.0, 1.0))
        assert float(angle.max()) < ROT_TOL
        assert torch.equal(step.n_meas[pick].double(), want_n)
        assert float(step.n_meas.min()) > 0.99 * MODEL.n_rays
        trans = step.trans
    err = torch.linalg.norm(trans - torch.from_numpy(_world()[1]), dim=1)
    assert float(err.median()) < 0.2  # the iteration contracts


def test_a_kept_cull_casts_what_a_fresh_cull_casts():
    """Steps within the margin reuse the cull and give, bitwise, what the
    correction through a fresh cull gives; a move past the margin culls."""
    bc = _corrector(origin_margin=0.05)
    data = _dataset(bc)
    trans = _start()
    first = bc.step(*data, trans)
    assert first.culls == 1 and int(first.truncated) == 0
    moved = trans + torch.tensor([0.03, -0.02, 0.01])
    kept = bc.step(*data, moved)
    assert kept.culls == 0
    delta, n_meas = bc.correct(*data, moved)  # a fresh cull, no margin
    assert torch.equal(kept.delta.trans, delta.trans) and torch.equal(kept.delta.rot, delta.rot)
    assert torch.equal(kept.n_meas, n_meas)
    assert torch.equal(kept.trans, delta.apply(moved))
    far = trans.clone()
    far[5, 2] += 0.05  # one pose past the margin along one axis
    assert bc.step(*data, far).culls == 1


def test_a_truncating_budget_is_counted():
    bc = _corrector(c_super=1, c_bin=1, c_hyper=1)
    data = _dataset(bc)
    timing.set_tracing(True)
    try:
        step = bc.step(*data, _start())
        lists, sat = bc.candidates(_start())
        counts = timing.counters()
    finally:
        timing.set_tracing(False)
    assert int(step.truncated) == int(sat.sum()) > 0
    assert counts["rmcl.batch.truncated_blocks"] == int(step.truncated)
    assert counts["rmcl.batch.culls"] == 1
    assert int(lists[1].max()) <= 1


@pytest.mark.parametrize("case", ["still", "axis", "turned", "batch"])
def test_needs_recull(case):
    ref_t = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]])
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    if case == "still":
        assert not bool(needs_recull(ref_t + 0.049, ref_t, 0.05, q0, q0, 0.01))
    elif case == "axis":
        t = ref_t.clone()
        t[1, 2] -= 0.05  # the L-inf move reaches the margin
        assert bool(needs_recull(t, ref_t, 0.05))
        assert not bool(needs_recull(t, ref_t, 0.0501))
    elif case == "turned":
        half = 0.0101 / 2  # a turn of 0.0101 rad about z
        q = torch.tensor([math.cos(half), 0.0, 0.0, math.sin(half)])
        assert bool(needs_recull(ref_t[0], ref_t[0], 0.05, q, q0, 0.01))
        assert not bool(needs_recull(ref_t[0], ref_t[0], 0.05, q, q0, 0.0102))
    else:
        # one of many positions past the margin decides for all
        t = ref_t.repeat(500, 1)
        t[777, 0] += 0.03
        assert bool(needs_recull(t, ref_t.repeat(500, 1), 0.03))


def _bench():
    """``rmcl_tpu_torch.bench``'s workload at this file's size: the same
    sphere, poses and budgets as :func:`_corrector`."""
    bench = SweepBench(n_poses=POSES, width=MODEL.width, sub_blocks=8, device="cpu",
                       mesh=make_sphere(100, 100, radius=50.0))
    assert np.array_equal(bench.trans_true_np, _world()[1])
    assert torch.equal(bench.bins.tri, _world()[0].tri)
    return bench


def _same(a, b):
    return (torch.equal(a[0].rot, b[0].rot) and torch.equal(a[0].trans, b[0].trans)
            and torch.equal(a[1], b[1]))


def test_bench_correction_is_the_correctors():
    """The bench's dataset and corrections, through a reuse cull and
    through a fresh one, are the corrector's, bitwise."""
    bench, bc = _bench(), _corrector()
    data = bench.make_dataset(bench.trans_true)
    want = _dataset(bc)
    assert torch.equal(data[0], want[0]) and torch.equal(data[1], want[1])
    start = _start()
    assert _same(bench.correction(*data, start, bench.candidates(start)),
                 bc.correct(*data, start, bc.candidates(start)[0]))
    assert _same(bench.correction(*data, start), bc.correct(*data, start))


def test_bench_iterate_is_the_correctors_steps():
    bench, bc = _bench(), _corrector()
    data = _dataset(bc)
    trans = _start()
    got = bench.iterate(*data, trans, 3)
    for _ in range(3):
        trans = bc.step(*data, trans).trans
    assert torch.equal(got, trans)


@pytest.mark.parametrize("env", [{"BENCH_ENGINE": "dense"}, {"BENCH_ENGINE": "exact"},
                                 {"BENCH_FUSED": "1"}])
def test_bench_settings_refuse_the_removed_engines(env):
    with pytest.raises(ValueError, match="removed"):
        settings_from_env(env)


def test_bench_settings_read_the_remaining_variables():
    cfg, run = settings_from_env({})
    assert run == dict(iters=3, steps=16)
    assert cfg == dict(faces=1_000_000, n_poses=1000, bin_size=64, c_bin=64, az_tile=8,
                       el_tile=1, poses_per_tile=16, bins_per_super=16, c_mid=0,
                       supers_per_hyper=16, seed=0, block_chunk=512, c_hyper=20,
                       payload="plane", c_super=24, sub_blocks=128, reuse=True, margin=0.03)
    cfg, run = settings_from_env({"BENCH_ENGINE": "factored", "BENCH_FUSED": "0",
                                  "BENCH_FACES": "5000000", "BENCH_POSES": "64",
                                  "BENCH_ITERS": "5", "BENCH_STEPS": "4", "BENCH_REUSE": "0",
                                  "BENCH_PAYLOAD": "index", "BENCH_MARGIN": "0.05"})
    assert run == dict(iters=5, steps=4)
    assert (cfg["faces"], cfg["n_poses"], cfg["reuse"], cfg["payload"], cfg["margin"]) == (
        5_000_000, 64, False, "index", 0.05)
    assert (cfg["c_bin"], cfg["c_hyper"], cfg["c_super"], cfg["sub_blocks"]) == (512, 24, 128, 128)
