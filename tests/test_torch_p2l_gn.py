"""MICP-L's point-to-plane Gauss-Newton loop as one kernel
(``rmcl_tpu_torch/ops/solve_cuda.py``, ``csrc/p2l_gauss_newton.cu``).

On the CPU: the pipeline's dispatch runs the torch loop
(``micp/pipeline.py::_correct_torch``) bitwise, the sharded and Umeyama
paths never reach the wrapper, the wrapper's checks refuse what the kernel
does not take, and the kernel branch's counter and views (the launch
replaced by the torch loop). On the card (marked ``cuda``, skipped without
one): the kernel against the torch loop on the same CUDA tensors. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_p2l_gn.py --noconftest -o addopts= -m cuda -q
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.micp import pipeline as tp
from rmcl_tpu_torch.micp.correspondences import Correspondences, find_cpc, find_rcc
from rmcl_tpu_torch.ops import solve_cuda as sc
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate
from rmcl_tpu_torch.utils import timing

torch.set_num_threads(2)

TRUE_POSE = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
START_POSE = [0.5, -0.3, 1.2, 0.0, 0.0, 0.35]
MODEL = SphericalModel.create(width=180, height=8, phi_min=-0.4, phi_max=0.3, range_max=30.0)
NODE_PAIRS = 14_400  # the node's VLP-16 scan

# kernel against plain version on the card: the same float32 arithmetic a
# pair, the sums in another order and another 6 x 6 elimination
POSE_TOL_M, POSE_TOL_RAD = 1e-5, 1e-6
MATCH_TOL = 1  # a pair at its gate's edge may flip
REL_TOL = 1e-5


# -- CPU: the dispatch, the checks, the counters --------------------------------

@pytest.fixture(scope="module")
def room():
    """The room scene's bins and BVH, and the model's scan at the true
    pose with RC and CP correspondences from the start pose."""
    mm = MeshMap.from_mesh(tm.make_room_scene(n_pillars=4, seed=3), bin_size=32,
                           bins_per_super=8, device="cpu")
    hits = simulate(mm.bvh, MODEL, Transform.from_pose_tuple(TRUE_POSE, device="cpu"))
    return mm, hits.point, hits.hit


def _sensor(points, mask, tsb=None, **cfg):
    return tp.MICPSensorData(model=MODEL, points=points, mask=mask,
                             tsb=tsb or Transform.identity(device="cpu"),
                             config=tp.MICPSensorConfig.create(**cfg))


def _flat(tom, stats):
    return torch.cat([tom.rot, tom.trans] + [getattr(stats, name).reshape(1)
                                             for name in tp.STATISTICS])


def _cpu_case(room, case):
    """(sensors, corrs, config, progress) of a named case on the room."""
    mm, points, mask = room
    est = Transform.from_pose_tuple(START_POSE, device="cpu")
    cfg = tp.MICPConfig()
    rc = _sensor(points, mask, max_dist=0.5)
    if case == "two_sensors_rc_cp":
        tsb = Transform.from_pose_tuple([0.1, 0.0, 0.05, 0.0, 0.0, 0.02], device="cpu")
        cp = _sensor(points, mask, tsb=tsb, max_dist=0.6, adaptive_max_dist_min=0.2,
                     weight=0.5, corr_type="CP")
        sensors = [rc, cp]
    else:
        sensors = [rc]
    corrs = [find_cpc(mm.bins, s.points, s.mask, est @ s.tsb, s.config.max_dist)
             if s.config.corr_type == "CP" else find_rcc(mm.bins, MODEL, est @ s.tsb)
             for s in sensors]
    progress = torch.tensor(0.4)
    if case in ("iterations_0", "iterations_1"):
        cfg = dataclasses.replace(cfg, optimization_iterations=int(case[-1]))
    elif case == "disable_correction":
        cfg = dataclasses.replace(cfg, disable_correction=True)
    elif case == "fixed_gate":
        cfg = dataclasses.replace(cfg, adaptive_max_dist=False)
    elif case == "no_valid_pair":
        sensors = [dataclasses.replace(rc, mask=torch.zeros_like(mask))]
    elif case == "non_finite":
        bad = points.clone()
        bad[3] = float("nan")
        sensors = [dataclasses.replace(rc, points=bad)]
    return sensors, corrs, cfg, progress


CPU_CASES = ["one_sensor", "two_sensors_rc_cp", "iterations_0", "iterations_1",
             "disable_correction", "fixed_gate", "no_valid_pair", "non_finite"]


@pytest.mark.parametrize("case", CPU_CASES)
def test_cpu_dispatch_returns_the_loop_as_it_was(room, case):
    """CPU tensors take the torch loop, bitwise; each case's own outcome."""
    sensors, corrs, cfg, progress = _cpu_case(room, case)
    tom = Transform.from_pose_tuple(START_POSE, device="cpu")
    tbo = Transform.from_pose_tuple([0.02, -0.01, 0.0, 0.0, 0.0, 0.01], device="cpu")
    got = _flat(*tp.correct_from_correspondences(sensors, corrs, tom, tbo, progress, cfg))
    want = _flat(*tp._correct_torch(sensors, corrs, tom, tbo, progress, cfg, None, "rays"))
    assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert float(got[7]) == sum(int(s.points.shape[0]) for s in sensors)
    moved = float(torch.linalg.norm(got[4:7] - tom.trans))
    if case in ("non_finite", "disable_correction", "iterations_0", "no_valid_pair"):
        # the guard kept the old pose, or the increment is the identity
        assert torch.allclose(got[:4], tom.rot) and torch.allclose(got[4:7], tom.trans)
    else:
        assert moved > 0.0
    if case == "no_valid_pair":
        assert float(got[8]) == 0.0 and float(got[9]) == 0.0 and float(got[11]) == 0.0
    elif case not in ("non_finite", "iterations_0"):
        assert 0.0 < float(got[9]) <= float(got[8]) and 0.0 <= float(got[11]) <= 1.0


class _OneRank:
    """A mesh of one rank: every collective is the identity."""

    def psum(self, x, axis):
        return x

    def axis_size(self, axis):
        return 1

    def axis_index(self, axis):
        return 0


@pytest.mark.parametrize("solver,mesh", [("umeyama", None), ("umeyama", _OneRank()),
                                         ("p2l_gn", _OneRank())])
def test_sharded_and_umeyama_never_reach_the_wrapper(room, monkeypatch, solver, mesh):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper was called")

    monkeypatch.setattr(tp, "p2l_gauss_newton", refuse)
    sensors, corrs, cfg, progress = _cpu_case(room, "one_sensor")
    tom = Transform.from_pose_tuple(START_POSE, device="cpu")
    new, stats = tp.correct_from_correspondences(
        sensors, corrs, tom, Transform.identity(device="cpu"), progress,
        dataclasses.replace(cfg, solver=solver), mesh=mesh)
    assert float(stats.valid_matches) > 0.9 * float(stats.valid_measurements)
    assert float(torch.linalg.norm(new.trans - tom.trans)) > 0.05  # it corrected


@pytest.mark.parametrize("kernel_path", [True, False])
def test_fused_counter_counts_each_correction_on_the_kernel_path(room, monkeypatch,
                                                                 kernel_path):
    """The kernel branch (``_correct_fused``, its launch replaced by the
    torch loop on CPU tensors) counts one fused correction a call; the
    dispatch on CPU tensors counts none and opens the iterations' spans."""
    calls = []

    def launch(sensors, corrs, tom, tbo, progress, config):
        calls.append(1)
        return _flat(*tp._correct_torch(sensors, corrs, tom, tbo, progress, config, None, "rays"))

    monkeypatch.setattr(tp, "p2l_gauss_newton", launch)
    correct = tp._correct_fused if kernel_path else tp.correct_from_correspondences
    sensors, corrs, cfg, progress = _cpu_case(room, "one_sensor")
    tom, tbo = Transform.from_pose_tuple(START_POSE, device="cpu"), Transform.identity(device="cpu")
    launches = sc.p2l_gauss_newton.launches
    timing.set_tracing(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                tom, stats = correct(sensors, corrs, tom, tbo, progress, cfg)
                progress = stats.convergence_progress
        counts = timing.counters()
    finally:
        timing.set_tracing(False)
    spans = [e.name for e in prof.events() if e.name.startswith("rmcl.")]
    assert sc.p2l_gauss_newton.launches == launches
    if kernel_path:
        assert counts == {"rmcl.micp.optimize.fused": 3} and len(calls) == 3
        # the pose and the statistics are views of the one output
        ptr = tom.rot.untyped_storage().data_ptr()
        assert all(getattr(stats, name).untyped_storage().data_ptr() == ptr
                   for name in tp.STATISTICS)
    else:
        assert "rmcl.micp.optimize.fused" not in counts and not calls
        assert spans.count("rmcl.micp.iteration") == 3 * cfg.optimization_iterations


def _args(n=10, sensors=1):
    pts = torch.zeros((n, 3))
    s = [_sensor(pts, torch.ones(n, dtype=torch.bool)) for _ in range(sensors)]
    c = [Correspondences(model_points=pts.clone(), model_normals=pts.clone(),
                         found=torch.ones(n, dtype=torch.bool)) for _ in range(sensors)]
    return s, c, Transform.identity(device="cpu"), Transform.identity(device="cpu"), torch.tensor(0.0)


def _bad(case):
    s, c, tom, tbo, prog = _args()
    if case == "points_float64":
        s[0] = dataclasses.replace(s[0], points=s[0].points.double())
    elif case == "mask_uint8":
        s[0] = dataclasses.replace(s[0], mask=s[0].mask.to(torch.uint8))
    elif case == "points_four_columns":
        s[0] = dataclasses.replace(s[0], points=torch.zeros((10, 4)))
    elif case == "found_short":
        c[0] = dataclasses.replace(c[0], found=c[0].found[:9])
    elif case == "tom_rot_three":
        tom = Transform(rot=torch.zeros(3), trans=tom.trans)
    elif case == "progress_vector":
        prog = torch.zeros(1)
    elif case == "points_strided":
        s[0] = dataclasses.replace(s[0], points=torch.zeros((3, 10)).T)
    elif case == "normals_strided":
        c[0] = dataclasses.replace(c[0], model_normals=torch.zeros((10, 6))[:, ::2])
    elif case == "normals_on_another_device":
        c[0] = dataclasses.replace(c[0], model_normals=torch.zeros((10, 3), device="meta"))
    elif case == "sensors_and_corrs_differ":
        c = c + c
    elif case == "too_many_sensors":
        s, c, tom, tbo, prog = _args(sensors=sc.MAX_SENSORS + 1)
    return s, c, tom, tbo, prog


BAD = {"points_float64": TypeError, "mask_uint8": TypeError, "points_four_columns": ValueError,
       "found_short": ValueError, "tom_rot_three": ValueError, "progress_vector": ValueError,
       "points_strided": ValueError, "normals_strided": ValueError,
       "normals_on_another_device": ValueError, "sensors_and_corrs_differ": ValueError,
       "too_many_sensors": ValueError}


@pytest.mark.parametrize("case", sorted(BAD))
def test_checks_refuse_what_the_kernel_does_not_take(case):
    with pytest.raises(BAD[case]):
        sc.check_p2l_args(*_bad(case))


def test_checks_take_the_contract_with_strided_pose_views():
    s, c, tom, tbo, prog = _args(sensors=sc.MAX_SENSORS)
    m = torch.eye(4)
    strided = Transform(rot=torch.tensor([1.0, 0.0, 0.0, 0.0, 9.0])[:4], trans=m[:3, 3])
    assert not strided.trans.is_contiguous()
    sc.check_p2l_args(s, c, strided, tbo, prog)
    sc.check_p2l_args([], [], tom, tbo, prog)


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        sc.p2l_gauss_newton(*_args(), tp.MICPConfig())


def test_kernel_constants_match_the_wrapper():
    src = (_build.CSRC / "p2l_gauss_newton.cu").read_text()
    const = {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(const["kCluster"]) == sc._CLUSTER
    assert int(const["kMaxSensors"]) == sc.MAX_SENSORS
    assert int(const["kOut"]) == sc.OUT_WORDS == 12


def test_unknown_solver_still_raises(room):
    sensors, corrs, cfg, progress = _cpu_case(room, "one_sensor")
    tom = Transform.identity(device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        tp.correct_from_correspondences(sensors, corrs, tom, tom, progress,
                                        dataclasses.replace(cfg, solver="icp"))


# -- the card: the kernel against the torch loop -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _box_sensor(n, seed, dev, tsb_pose=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0), max_dist=0.5,
                adaptive_min=0.15, weight=1.0):
    """n pairs on a 10 x 8 x 3 m box's faces, in a sensor frame that sits
    5 cm and 0.02 rad off the truth, with 3% unmeasured, 3% unmatched and
    5% outliers up to 1 m off their planes (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-5.0, -4.0, 0.0]), np.array([5.0, 4.0, 3.0])
    face = rng.integers(0, 6, n)
    axis, side = face // 2, face % 2
    idx = np.arange(n)
    m = lo + rng.random((n, 3)) * (hi - lo)
    m[idx, axis] = np.where(side == 0, lo[axis], hi[axis])
    normal = np.zeros((n, 3))
    normal[idx, axis] = np.where(side == 0, 1.0, -1.0)
    # measured points: on the same planes elsewhere, seen through the error
    d = m + rng.normal(0.0, 0.3, (n, 3)) * (1.0 - np.abs(normal)) + 0.005 * rng.normal(
        size=(n, 1)) * normal
    out = rng.random(n) < 0.05
    d[out] += rng.uniform(-1.0, 1.0, (out.sum(), 1)) * normal[out]
    c, s = math.cos(0.02), math.sin(0.02)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    d = (d - np.array([0.05, -0.03, 0.02])) @ R
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    mask = torch.tensor(rng.random(n) > 0.03, device=dev)
    found = torch.tensor(rng.random(n) > 0.03, device=dev)
    sensor = tp.MICPSensorData(
        model=MODEL, points=f32(d), mask=mask,
        tsb=Transform.from_pose_tuple(list(tsb_pose), device=dev),
        config=tp.MICPSensorConfig.create(max_dist=max_dist, adaptive_max_dist_min=adaptive_min,
                                          weight=weight))
    return sensor, Correspondences(model_points=f32(m), model_normals=f32(normal), found=found)


def _card_inputs(dev, n=NODE_PAIRS, sensors=1, **cfg):
    pairs = [_box_sensor(n, 11, dev)]
    if sensors == 2:
        pairs.append(_box_sensor(n // 3 + 7, 12, dev, tsb_pose=(0.2, 0.1, 0.3, 0.0, 0.01, 1.6),
                                 max_dist=0.8, adaptive_min=0.1, weight=0.35))
    tom = Transform.from_pose_tuple([1.0, 2.0, 0.3, 0.0, 0.0, 0.7], device=dev)
    tbo = Transform.from_pose_tuple([0.4, -0.2, 0.0, 0.0, 0.0, 0.1], device=dev)
    progress = torch.tensor(0.3, device=dev)
    return ([p[0] for p in pairs], [p[1] for p in pairs], tom, tbo, progress,
            dataclasses.replace(tp.MICPConfig(), **cfg))


def _rot_gap(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return 2.0 * math.asin(min(1.0, float(torch.linalg.norm(
        a[0] * b[1:] - b[0] * a[1:] - torch.linalg.cross(a[1:], b[1:])))))


def _assert_close(got, want):
    got, want = got.cpu(), want.cpu()
    assert float(torch.linalg.norm((got[4:7] - want[4:7]).double())) <= POSE_TOL_M
    assert _rot_gap(got[:4], want[:4]) <= POSE_TOL_RAD
    assert got[7] == want[7] and got[8] == want[8]  # total, valid: exact counts
    assert abs(float(got[9]) - float(want[9])) <= MATCH_TOL
    for k in (10, 11):
        assert abs(float(got[k]) - float(want[k])) <= REL_TOL * abs(float(want[k])), k


def _plain(sensors, corrs, tom, tbo, progress, config):
    """The torch loop's result, packed as the kernel's output."""
    return _flat(*tp._correct_torch(sensors, corrs, tom, tbo, progress, config, None, "rays"))


def _both(*inputs):
    sc.check_p2l_args(*inputs[:5])
    launches = sc.p2l_gauss_newton.launches
    got = sc.p2l_gauss_newton(*inputs)
    want = _plain(*inputs)
    torch.cuda.synchronize()
    assert sc.p2l_gauss_newton.launches == launches + 1
    return got, want


CARD_CASES = {
    "node_shape": dict(),
    "two_sensors": dict(sensors=2),
    "iterations_0": dict(optimization_iterations=0),
    "iterations_1": dict(optimization_iterations=1),
    "fixed_gate": dict(adaptive_max_dist=False),
    "disable_correction": dict(disable_correction=True),
    "not_a_multiple_of_the_threads": dict(n=NODE_PAIRS + 37),
    "three_scans_3x14400": dict(n=3 * NODE_PAIRS),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_kernel_matches_plain_version(card, case):
    inputs = _card_inputs(card, **CARD_CASES[case])
    got, want = _both(*inputs)
    _assert_close(got, want)
    if case == "disable_correction":
        assert torch.equal(got[:7], want[:7])


@pytest.mark.cuda
def test_card_no_valid_pair_solves_the_damped_identity(card):
    sensors, corrs, tom, tbo, progress, cfg = _card_inputs(card)
    sensors = [dataclasses.replace(sensors[0], mask=torch.zeros_like(sensors[0].mask))]
    got, want = _both(sensors, corrs, tom, tbo, progress, cfg)
    _assert_close(got, want)
    assert float(got[9]) == 0.0 and float(got[11]) == 0.0
    assert torch.allclose(got[4:7], (tom @ Transform.identity(device=card)).trans)


def _to_cpu(sensors, corrs, tom, tbo, progress):
    cpu = lambda t: Transform(rot=t.rot.cpu(), trans=t.trans.cpu())  # noqa: E731
    return ([dataclasses.replace(s, points=s.points.cpu(), mask=s.mask.cpu(), tsb=cpu(s.tsb))
             for s in sensors],
            [Correspondences(model_points=c.model_points.cpu(), model_normals=c.model_normals.cpu(),
                             found=c.found.cpu()) for c in corrs], cpu(tom), cpu(tbo), progress.cpu())


@pytest.mark.cuda
def test_card_non_finite_input_keeps_the_old_pose(card):
    """torch.linalg.solve refuses the NaN system on the card, so the torch
    loop runs on the CPU here (LAPACK solves it to NaN)."""
    sensors, corrs, tom, tbo, progress, cfg = _card_inputs(card)
    bad = sensors[0].points.clone()
    bad[5] = float("inf")
    inputs = ([dataclasses.replace(sensors[0], points=bad)], corrs, tom, tbo, progress)
    got = sc.p2l_gauss_newton(*inputs, cfg).cpu()
    want = _plain(*_to_cpu(*inputs), cfg)
    for x in (got, want):
        assert torch.equal(x[:4], tom.rot.cpu()) and torch.equal(x[4:7], tom.trans.cpu())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[7:10], want[7:10])


@pytest.mark.cuda
def test_card_two_launches_agree_bitwise(card):
    inputs = _card_inputs(card, sensors=2)
    first, second = sc.p2l_gauss_newton(*inputs), sc.p2l_gauss_newton(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_card_node_launches_the_kernel_once_a_correction(card):
    mm = MeshMap.from_mesh(tm.make_room_scene(n_pillars=4, seed=3), device=card)
    hits = simulate(mm.bvh, MODEL, Transform.from_pose_tuple(TRUE_POSE, device=card))
    from rmcl_tpu_torch.config.tree import ParamTree
    from rmcl_tpu_torch.micp.node import MICPLocalization

    node = MICPLocalization(mm, ParamTree({
        "engine": "bvh", "sensors": {"lidar": {"correspondences": {"type": "RC"}}}}))
    node.on_odometry(Transform.identity(device=card))
    node.set_static_dataset("lidar", MODEL, hits.point, hits.hit)
    node.set_pose(Transform.from_pose_tuple(START_POSE, device=card))
    launches = sc.p2l_gauss_newton.launches
    timing.set_tracing(True)
    try:
        for _ in range(10):
            node.step()
        counts = timing.counters()
    finally:
        timing.set_tracing(False)
    assert sc.p2l_gauss_newton.launches - launches == 10
    assert counts.get("rmcl.micp.optimize.fused") == 10
    np.testing.assert_allclose(node.tom.trans.cpu().numpy(),
                               (Transform.from_pose_tuple(TRUE_POSE, device=card)
                                @ node.tbo.inverse()).trans.cpu().numpy(), atol=0.01)
