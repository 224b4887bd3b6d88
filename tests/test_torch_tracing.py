"""The port's spans and counters (``rmcl_tpu_torch.utils.timing``) on the
CPU: off, they record nothing and add nothing to a correction; on, the
MICP-L correction, the MCL cycle, the factored cast and the batch
correction open their layers' spans, nested as the layers are, change no
result, and count the ray-bin pairs the cull hands the intersection."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.config.tree import ParamTree
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl import node as mcl_node
from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig
from rmcl_tpu_torch.micp.batch import BatchCorrector
from rmcl_tpu_torch.micp.node import MICPLocalization
from rmcl_tpu_torch.ops.raycast_binned import (block_cull_stats, cast_rays_binned,
                                               cast_rays_binned_factored, factored_candidates)
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate
from rmcl_tpu_torch.utils import timing

torch.set_num_threads(2)

TRUE_POSE = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
START_POSE = [0.5, -0.3, 1.2, 0.0, 0.0, 0.35]
MODEL = SphericalModel.create(width=180, height=8, phi_min=-0.4, phi_max=0.3, range_max=30.0)
ITERATIONS = 5


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts with the process-wide switch off and an empty
    store, and ends with the switch off."""
    timing.set_tracing(True)
    timing.set_tracing(False)
    yield
    timing.set_tracing(False)


@pytest.fixture(scope="module")
def room():
    """The room scene with its bins (the binned engine) and BVH."""
    return MeshMap.from_mesh(tm.make_room_scene(n_pillars=4, seed=3), bin_size=32,
                             bins_per_super=8, device="cpu")


def _points(mm, pose):
    hits = simulate(mm.bvh, MODEL, Transform.from_pose_tuple(pose, device="cpu"))
    return hits.point, hits.hit


def _micp_node(mm):
    node = MICPLocalization(mm, ParamTree({
        "optimization_iterations": ITERATIONS, "engine": "binned",
        "sensors": {"lidar": {"correspondences": {"type": "RC", "max_dist": 0.5}}}}))
    points, mask = _points(mm, TRUE_POSE)
    node.on_odometry(Transform.identity(device="cpu"))
    node.set_static_dataset("lidar", MODEL, points, mask)
    node.set_pose(Transform.from_pose_tuple(START_POSE, device="cpu"))
    node.step()  # the budget audit runs before the first correction
    return node, points, mask


def _annotations(prof):
    """(name, parent span's name) of every ``rmcl.*`` range in a profile."""
    out = []
    for e in prof.events():
        if e.name.startswith("rmcl."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("rmcl."):
                p = p.cpu_parent
            out.append((e.name, p.name if p is not None else None))
    return out


def _ops(prof):
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("aten::"))


def test_tracing_off_records_nothing(room):
    assert not timing.tracing()
    assert timing.span("rmcl.a") is timing.span("rmcl.b")
    timing.count("rmcl.n", 3)
    timing.count_device("rmcl.x", object())  # off: never touched
    node, *_ = _micp_node(room)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        node.step()
    assert not _annotations(prof)
    assert not timing.store().total and timing.counters() == {}


def test_tracing_off_adds_no_operation_to_a_correction(room):
    """A profiled correction with tracing off runs exactly the operations
    of one with tracing on, less those of the one pairs count; and holds
    no range of the program's."""
    node, points, mask = _micp_node(room)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        node.step()
    node.set_static_dataset("lidar", MODEL, points, mask)
    with profile(activities=[ProfilerActivity.CPU]) as warm:
        node.step()  # re-uploads the scan, as the next profiled step
    timing.set_tracing(True)
    node.set_static_dataset("lidar", MODEL, points, mask)
    with profile(activities=[ProfilerActivity.CPU]) as on:
        node.step()
    timing.set_tracing(True)
    cand_count = torch.ones(4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as count:
        timing.count_device("rmcl.cast.pairs", cand_count, 128)
    assert _ops(on) - _ops(warm) == _ops(count)
    assert not _ops(warm) - _ops(on)
    assert not _annotations(off) and not _annotations(warm) and _annotations(on)


def test_micp_step_spans_nest(room):
    node, points, mask = _micp_node(room)
    timing.set_tracing(True)
    node.on_odometry(Transform.identity(device="cpu"))
    node.set_static_dataset("lidar", MODEL, points, mask)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        node.step()
    spans = collections.Counter(_annotations(prof))
    assert spans == {
        ("rmcl.micp.step", None): 1,
        ("rmcl.micp.upload", "rmcl.micp.step"): 1,
        ("rmcl.micp.correspond", "rmcl.micp.step"): 1,
        ("rmcl.cast.rays", "rmcl.micp.correspond"): 2,  # the model's rays, then flat
        ("rmcl.cast.cull", "rmcl.micp.correspond"): 1,
        ("rmcl.cast.intersect", "rmcl.micp.correspond"): 1,
        ("rmcl.cast.payload", "rmcl.micp.correspond"): 2,  # the hits, then the fold
        ("rmcl.micp.optimize", "rmcl.micp.step"): 1,
        ("rmcl.micp.iteration", "rmcl.micp.optimize"): ITERATIONS,
        ("rmcl.micp.solve", "rmcl.micp.iteration"): ITERATIONS,
    }
    st = timing.store()
    assert st.count["rmcl.micp.iteration"] == ITERATIONS and st.count["rmcl.micp.step"] == 1
    assert st.max["rmcl.micp.step"] >= st.total["rmcl.micp.optimize"] > 0
    # the ingest before it, and the audit of a fresh node
    node2 = MICPLocalization(room, ParamTree({"engine": "binned"}))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        node2.on_odometry(Transform.identity(device="cpu"))
        node2.set_static_dataset("lidar", MODEL, points, mask)
        node2.step()
    names = collections.Counter(_annotations(prof))
    assert names[("rmcl.micp.ingest", None)] == 2
    assert names[("rmcl.micp.audit", "rmcl.micp.step")] == 1
    assert names[("rmcl.cast.cull", "rmcl.micp.audit")] >= 1


def _mcl_node(mm, engine="binned"):
    cfg = mcl_node.MCLConfig(
        n_particles=256, seed=4, auto_engine_period=1,
        sensor=SensorUpdateConfig.create(samples=32, dist_sigma=0.3, engine=engine))
    node = mcl_node.MCLNode(mm, cfg)
    node.initial_pose_guess(Transform.from_pose_tuple(TRUE_POSE, device="cpu"),
                            torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4])))
    return node


def _scan(mm, k):
    pose = list(TRUE_POSE)
    pose[0] += 0.05 * k
    return (pose,) + _points(mm, pose)


def _cycle(node, mm, k, scan=None):
    pose, points, mask = scan or _scan(mm, k)
    node.motion_update(Transform.from_pose_tuple(pose, device="cpu"), stamp=0.1 * k)
    node.sensor_update(points, mask, Transform.identity(device="cpu"))
    node.resample()
    return node.estimate()


def test_mcl_cycle_spans_nest(room):
    node = _mcl_node(room, engine="auto")
    for k in range(2):
        _cycle(node, room, k)
    assert node._engine_choice == "binned"
    scan = _scan(room, 2)
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cycle(node, room, 2, scan)
    spans = collections.Counter(_annotations(prof))
    su, stages = "rmcl.mcl.sensor_update", ("rmcl.mcl.motion_update", "rmcl.mcl.resampling")
    want = {(n, None) for n in stages + (su, "rmcl.mcl.upload", "rmcl.mcl.gate",
                                          "rmcl.mcl.estimate")}
    want |= {(n + ".wait", n) for n in stages + (su,)}
    want |= {(n, su) for n in ("rmcl.mcl.beams", "rmcl.mcl.cluster", "rmcl.cast.rays",
                               "rmcl.cast.cull", "rmcl.cast.intersect", "rmcl.cast.payload",
                               "rmcl.mcl.score", "rmcl.mcl.fold")}
    assert set(spans) == want
    assert spans[("rmcl.mcl.sensor_update", None)] == 1
    # the node's own stage timer keeps its keys; the store has the spans
    assert {"motion_update", "sensor_update", "resampling"} <= set(node.timer.total)
    assert {"rmcl.mcl.sensor_update", "rmcl.mcl.sensor_update.wait"} <= set(timing.store().total)
    assert timing.counters()["rmcl.cast.pairs"] > 0


def test_results_are_bitwise_the_same_with_tracing_on(room):
    outs = []
    for on in (False, True):
        timing.set_tracing(on)
        node, points, mask = _micp_node(room)
        stats = [node.step() for _ in range(3)]
        mcl = _mcl_node(room)
        ests = [_cycle(mcl, room, k) for k in range(3)]
        outs.append((node.tom, stats, mcl.cloud, ests))
    (tom0, st0, c0, e0), (tom1, st1, c1, e1) = outs
    assert torch.equal(tom0.rot, tom1.rot) and torch.equal(tom0.trans, tom1.trans)
    for a, b in zip(st0, st1):
        for f in ("total_measurements", "valid_measurements", "valid_matches",
                  "covariance_trace", "convergence_progress"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("rot", "trans"):
        assert torch.equal(getattr(c0.poses, f), getattr(c1.poses, f))
    for f in ("mean", "sigma", "n_meas"):
        assert torch.equal(getattr(c0.likelihood, f), getattr(c1.likelihood, f))
    for a, b in zip(e0, e1):
        assert torch.equal(a.pose.trans, b.pose.trans) and torch.equal(a.pose.rot, b.pose.rot)


@pytest.mark.parametrize("on", [False, True])
def test_stage_timer_keeps_totals_and_opens_its_wait(on):
    timing.set_tracing(on)
    st = timing.StageTimer(prefix="rmcl.t.")
    before = dict(timing.store().total)
    x = torch.ones(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with st.stage("s", block_on=lambda: x):
                x = x * 2
    assert st.count["s"] == 2 and st.total["s"] >= st.max["s"] > 0 and "s" in st.report()
    spans = collections.Counter(_annotations(prof))
    if on:
        assert spans == {("rmcl.t.s", None): 2, ("rmcl.t.s.wait", "rmcl.t.s"): 2}
        assert timing.store().count["rmcl.t.s.wait"] == 2
    else:
        assert not spans and timing.store().total == before


def test_cast_pairs_counts_what_the_cull_hands_the_intersection(room):
    mm = room
    gen = torch.Generator().manual_seed(0)
    o = torch.tensor([0.5, -0.3, 1.0]) + 0.2 * torch.rand((1000, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((1000, 3), generator=gen), dim=-1)
    kw = dict(block_size=64, c_super=6, c_bin=24)
    timing.set_tracing(True)
    cast_rays_binned(mm.bins, o, d, **kw)
    cast_rays_binned(mm.bins, o[:500], d[:500], **kw)
    got = timing.counters()
    timing.set_tracing(False)
    want = sum(int(block_cull_stats(mm.bins, oo, dd, **kw)[0].sum()) * 64
               for oo, dd in ((o, d), (o[:500], d[:500])))
    assert got == {"rmcl.cast.pairs": want} and want > 0
    # turning tracing on again empties the counters and the store
    timing.set_tracing(True)
    assert timing.counters() == {} and not timing.store().total


def test_step_prints_its_mean_every_1000_corrections_only_with_tracing(room, capsys):
    """With tracing on, every 1000th correction prints the mean of the
    ``rmcl.micp.step`` span over the corrections since the last print."""
    node, *_ = _micp_node(room)
    capsys.readouterr()
    node.corrections = 999
    node.step()
    assert capsys.readouterr().out == ""
    timing.set_tracing(True)
    node.corrections = 1999
    node.step()
    assert capsys.readouterr().out.startswith("[micp] 2000 corrections, avg ")
    st = timing.store()
    total, n = st.total["rmcl.micp.step"], st.count["rmcl.micp.step"]
    node.corrections = 2997
    node.step()
    node.step()
    assert capsys.readouterr().out == ""
    node.step()
    mean = (st.total["rmcl.micp.step"] - total) / (st.count["rmcl.micp.step"] - n)
    assert capsys.readouterr().out == (f"[micp] 3000 corrections, avg {mean * 1e3:.2f} ms "
                                       f"over the last 3\n")
    # a correction that is not ready opens no span
    node.tom = None
    assert node.step() is None and st.count["rmcl.micp.step"] == n + 3
    assert not hasattr(node, "_runtime_ema") and not hasattr(node, "_runtime_total")


@pytest.mark.parametrize("handler", ["on_odometry", "set_static_dataset", "on_scan"])
def test_each_ingest_handler_opens_one_ingest_span(room, handler):
    from rmcl_tpu_torch.io import msgs
    from rmcl_tpu_torch.io.conversions import model_to_scan_info

    node = MICPLocalization(room, ParamTree({"engine": "binned"}))
    points, mask = _points(room, TRUE_POSE)
    call = {
        "on_odometry": lambda: node.on_odometry(Transform.identity(device="cpu"), stamp=0.1),
        "set_static_dataset": lambda: node.set_static_dataset("lidar", MODEL, points, mask),
        "on_scan": lambda: node.on_scan("lidar", msgs.ScanStamped(
            msgs.Header(0.0), model_to_scan_info(MODEL),
            msgs.RangeData(points.norm(dim=-1).numpy()))),
    }[handler]
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert _annotations(prof) == [("rmcl.micp.ingest", None)]
    assert timing.store().count["rmcl.micp.ingest"] == 1


def test_counters_add_up_on_and_empty_when_tracing_turns_on():
    timing.set_tracing(True)
    timing.count("rmcl.t.n", 3)
    timing.count("rmcl.t.n", 4)
    timing.count_device("rmcl.t.d", torch.tensor([1, 2, 3], dtype=torch.int32), 10)
    timing.count_device("rmcl.t.d", torch.tensor([5], dtype=torch.int32))
    timing.count_device("rmcl.t.f", torch.tensor([0.25, 0.5]))
    assert timing.counters() == {"rmcl.t.n": 7, "rmcl.t.d": 65, "rmcl.t.f": 0.75}
    timing.set_tracing(False)
    timing.count("rmcl.t.n", 1)  # off: nothing added, the counts kept for reading
    assert timing.counters()["rmcl.t.n"] == 7
    timing.set_tracing(True)
    assert timing.counters() == {}


@pytest.fixture(scope="module")
def sphere():
    """A small sphere's bins and 8 positions inside it, for the factored
    cast and the batch corrector."""
    bins = build_bins(tm.make_sphere(30, 30, radius=20.0), bin_size=32, bins_per_super=8,
                      supers_per_hyper=8, device="cpu")
    gen = torch.Generator().manual_seed(5)
    return bins, (torch.rand((8, 3), generator=gen) - 0.5) * 4.0


def _batch(sphere):
    bins, truth = sphere
    bc = BatchCorrector(bins, SphericalModel.create(width=48, height=8), truth.numpy(),
                        poses_per_tile=4, sub_blocks=8, c_super=8, c_bin=16, c_hyper=4)
    points, _, hit = bc.cast(truth)
    return bc, (points - truth[:, None], hit), truth + torch.tensor([0.0, 0.0, 0.2])


def test_factored_cast_spans_and_pairs(sphere):
    """The standalone cull opens ``rmcl.cast.cull``; a cast opens rays,
    intersect and payload (and the cull where it is given no lists), and
    counts the pairs its lists hand K4."""
    bins, truth = sphere
    bc = BatchCorrector(bins, MODEL, truth.numpy(), sub_blocks=8)
    o_blk, d_blk = bc.sweep.factored_rays(truth, bc.dirs)
    kw = dict(c_super=8, c_bin=16, sub_blocks=8)
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lists = factored_candidates(bins, o_blk, d_blk, origin_margin=0.03, **kw)
        cast_rays_binned_factored(bins, o_blk, d_blk, candidates=lists, **kw)
        cast_rays_binned_factored(bins, o_blk, d_blk, **kw)
    got = timing.counters()
    timing.set_tracing(False)
    spans = collections.Counter(_annotations(prof))
    assert spans == {("rmcl.cast.cull", None): 2, ("rmcl.cast.rays", None): 2,
                     ("rmcl.cast.intersect", None): 2, ("rmcl.cast.payload", None): 2}
    fresh = factored_candidates(bins, o_blk, d_blk, **kw)
    rays = o_blk.shape[1] * d_blk.shape[1]
    want = (int(lists[1].sum()) + int(fresh[1].sum())) * rays
    assert got == {"rmcl.cast.pairs": want} and int(lists[1].sum()) > int(fresh[1].sum()) > 0


def test_batch_step_spans_nest(sphere):
    bc, data, start = _batch(sphere)
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = bc.step(*data, start)
        bc.step(*data, first.trans + 0.001)  # within the margin: the cull is kept
    spans = collections.Counter(_annotations(prof))
    step = "rmcl.batch.step"
    assert spans == {
        (step, None): 2,
        ("rmcl.batch.recull_check", step): 2,
        ("rmcl.cast.cull", step): 1,
        ("rmcl.batch.correspond", step): 2,
        ("rmcl.cast.rays", "rmcl.batch.correspond"): 2,
        ("rmcl.cast.intersect", "rmcl.batch.correspond"): 2,
        ("rmcl.cast.payload", "rmcl.batch.correspond"): 2,
        ("rmcl.batch.epilogue", step): 2,
    }
    counts = timing.counters()
    assert counts["rmcl.batch.culls"] == 1 and counts["rmcl.batch.truncated_blocks"] == 0
    assert counts["rmcl.cast.pairs"] > 0
    st = timing.store()
    assert st.count[step] == 2 and st.total[step] >= st.total["rmcl.batch.correspond"] > 0


def test_batch_step_records_nothing_off_and_is_the_same_on(sphere):
    outs = []
    for on in (False, True):
        timing.set_tracing(on)
        bc, data, start = _batch(sphere)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            steps = [bc.step(*data, start)]
            steps.append(bc.step(*data, steps[0].trans))
        outs.append(steps)
        if not on:
            assert not _annotations(prof)
            assert not timing.store().total and timing.counters() == {}
    for a, b in zip(*outs):
        assert torch.equal(a.trans, b.trans) and torch.equal(a.n_meas, b.n_meas)
        assert torch.equal(a.delta.rot, b.delta.rot) and a.culls == b.culls
