"""The port's MICP-L node against the JAX package's, on the CPU.

Both nodes get the same map (the port's bins and BVH are bitwise the JAX
package's numpy-order ones, which the JAX map is forced onto), the same
numpy-made scans as messages and the same odometry, and run ten steps;
``tom`` must agree after every step at the tolerances
``tests/test_torch_micp.py`` holds ``correct_once`` to. Also the budget
audit, ``set_pose``, the clock-mismatch drop, motion compensation and the
port's own departures from the JAX node (named in each test)."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.config.tree import ParamTree as JPT
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.geom.map import MeshMap as JMap
from rmcl_tpu.io import msgs as jmsgs
from rmcl_tpu.io.conversions import model_to_scan_info
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.micp import node as jnode
from rmcl_tpu.ops.raycast_binned import block_cull_stats as j_block_cull_stats
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu_torch.config.tree import ParamTree as TPT
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.geom.map import MeshMap as TMap
from rmcl_tpu_torch.io import msgs as tmsgs
from rmcl_tpu_torch.math.se3 import Transform as TTransform
from rmcl_tpu_torch.micp import node as tnode
from rmcl_tpu_torch.ops import raycast_binned as trb
from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats as t_block_cull_stats
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical

from torch_cull_expect import block_cones, port_cull_under_jax, restated_cull
from test_torch_micp import CP_POSE_TOL, POSE_TOL, START_POSE, TRUE_POSE, _quat_close

torch.set_num_threads(2)

MODEL_KW = dict(width=180, height=8, phi_min=-0.4, phi_max=0.3, range_max=30.0)
N_STEPS = 10
# de-skew: within 1e-6, relative beyond 1 m (float32 slerps of two
# frameworks round apart by an ulp or two)
DESKEW_TOL = 1e-6
# the first CP correction from 0.2 m off: 3 of the 1,440 measured points
# lie equidistant from two perpendicular faces and take the other face's
# normal in the other package (float32 decides; the points themselves
# agree), which moves that solve by up to 5.03e-4 m on the BVH; every later
# step is held to CP_POSE_TOL
FIRST_CP_TOL = 1e-3


@pytest.fixture(scope="module")
def maps():
    """The room scene as a MeshMap in both packages, each in its default
    bin order (the native one on both sides: bitwise the same bins)."""
    jmap = JMap.from_mesh(jm.make_room_scene(n_pillars=4, seed=3), bin_size=32,
                          bins_per_super=8)
    tmap = TMap.from_mesh(tm.make_room_scene(n_pillars=4, seed=3), bin_size=32,
                          bins_per_super=8, device="cpu")
    return jmap, tmap


def _scans(n=N_STEPS):
    """n scans simulated (JAX, on its BVH) along a short drive, and the
    drifting odometry the node sees: (stamp, true pose tuple, odom tuple,
    ranges, mask)."""
    jb = JMap.from_mesh(jm.make_room_scene(n_pillars=4, seed=3)).bvh
    model = JSpherical.create(**MODEL_KW)
    out = []
    for k in range(n):
        true = list(TRUE_POSE)
        true[0] += 0.02 * k
        true[5] += 0.01 * k
        odom = list(true)
        odom[0] += 0.005 * k  # odometry drifts; Tom must take it up
        odom[5] += 0.002 * k
        hits = j_simulate(jb, model, JTransform.from_pose_tuple(jnp.asarray(true)))
        ranges = np.where(np.asarray(hits.hit), np.asarray(hits.t), 0.0).astype(np.float32)
        out.append((0.1 * k, true, odom, ranges, np.asarray(hits.hit)))
    return out


@pytest.fixture(scope="module")
def scans():
    return _scans()


def _config(engine, corr, extra=None):
    d = {"engine": engine, "initial_pose_guess": START_POSE,
         "sensors": {"lidar": {"correspondences": {"type": corr, "max_dist": 0.5}}}}
    d.update(extra or {})
    return d


def _nodes(maps, config):
    jmap, tmap = maps
    return (jnode.MICPLocalization(jmap, JPT(config)),
            tnode.MICPLocalization(tmap, TPT(config)))


def _feed(jn, tn, scan, info):
    stamp, _, odom, ranges, mask = scan
    jn.on_odometry(JTransform.from_pose_tuple(jnp.asarray(odom)), stamp=stamp)
    tn.on_odometry(TTransform.from_pose_tuple(odom, device="cpu"), stamp=stamp)
    jn.on_scan("lidar", jmsgs.ScanStamped(jmsgs.Header(stamp), info,
                                          jmsgs.RangeData(ranges=ranges, mask=mask)))
    tinfo = tmsgs.ScanInfo(**dataclasses.asdict(info))
    tn.on_scan("lidar", tmsgs.ScanStamped(tmsgs.Header(stamp), tinfo,
                                          tmsgs.RangeData(ranges=ranges, mask=mask)))


@pytest.mark.parametrize("engine,corr", [("binned", "RC"), ("binned", "CP"), ("bvh", "RC"),
                                         ("bvh", "CP")])
def test_node_steps_match_jax(maps, scans, engine, corr):
    jn, tn = _nodes(maps, _config(engine, corr))
    assert tn.engine == jn.engine == engine
    info = model_to_scan_info(JSpherical.create(**MODEL_KW))
    tol = CP_POSE_TOL if corr == "CP" else POSE_TOL
    for k, scan in enumerate(scans):
        _feed(jn, tn, scan, info)
        js, ts = jn.step(), tn.step()
        step_tol = FIRST_CP_TOL if corr == "CP" and k == 0 else tol
        np.testing.assert_allclose(tn.tom.trans.numpy(), np.asarray(jn.tom.trans),
                                   atol=step_tol, rtol=0)
        _quat_close(jn.tom.rot, tn.tom.rot, step_tol)
        assert float(ts.valid_measurements) == float(js.valid_measurements)
    est = tn.pose_base_map().trans.numpy()
    assert np.linalg.norm(est - np.float32(scans[-1][1][:3])) < 0.05
    # the outputs
    jpc, tpc = jn.pose_with_covariance(), tn.pose_with_covariance()
    np.testing.assert_allclose(tpc.pose[:3], jpc.pose[:3], atol=tol)
    np.testing.assert_allclose(tpc.covariance, jpc.covariance, atol=1e-2)
    jst, tst = jn.sensor_stats(), tn.sensor_stats()
    assert (tst.total_measurements, tst.valid_measurements) == (jst.total_measurements,
                                                                jst.valid_measurements)
    assert tn.corrections == jn.corrections == N_STEPS


@pytest.fixture(scope="module")
def building():
    """A small building floor, bins of 16 in supers of 8: the default
    budgets (c_super 24, c_bin 96) saturate a VLP-16-like scan's blocks."""
    kw = dict(rooms_x=2, rooms_y=2, subdiv=6, n_clutter=1, seed=1)
    jmap = JMap.from_mesh(jm.make_building_scene(**kw), bin_size=16, bins_per_super=8)
    tmap = TMap.from_mesh(tm.make_building_scene(**kw), bin_size=16, bins_per_super=8,
                          device="cpu")
    return jmap, tmap


def test_audit_adopts_the_same_budgets(building, capsys, monkeypatch):
    """Both nodes' one-shot audit on the first binned correction: every
    block JAX flags saturated at the configured budgets the port flags too
    (the port's cull also keeps the flat bins JAX's cone-box test drops, so
    a block may fill its budget in the port alone), the port's flags and
    counts are those of the cull restated in numpy (tests/
    torch_cull_expect.py), and the port adopts the
    c_super, c_bin and c_mid that JAX's audit adopts on the port's cull
    (tests/torch_cull_expect.py). Unlike the JAX node, the port's prints its
    package's name in the adoption line."""
    config = {"initial_pose_guess": [3.0, 3.0, 1.2, 0.0, 0.0, 0.3],
              "sensors": {"lidar": {}}}
    jn, tn = _nodes(building, config)
    model_kw = dict(width=360, height=16, range_max=40.0)
    jmodel, tmodel = JSpherical.create(**model_kw), TSpherical.create(**model_kw)
    hits = j_simulate(building[0].bvh, jmodel,
                      JTransform.from_pose_tuple(jnp.asarray([3.1, 3.0, 1.2, 0.0, 0.0, 0.3])))
    points, mask = np.array(hits.point), np.array(hits.hit)
    jn.on_odometry(JTransform.identity())
    tn.on_odometry(TTransform.identity(device="cpu"))
    jn.set_static_dataset("lidar", jmodel, jnp.asarray(points), jnp.asarray(mask))
    tn.set_static_dataset("lidar", tmodel, torch.from_numpy(points), torch.from_numpy(mask))
    # the flags the audits see, at the configured budgets from the start pose
    jo, jd = jmodel.rays()
    tsm = JTransform.from_pose_tuple(jnp.asarray(config["initial_pose_guess"]))
    _, jsat = j_block_cull_stats(building[0].bins, tsm.apply(jo), tsm.rotate(jd), c_super=24,
                                 c_bin=96)
    to, td = tmodel.rays("cpu")
    tsm_t = TTransform.from_pose_tuple(config["initial_pose_guess"], device="cpu")
    t_counts, tsat = t_block_cull_stats(building[1].bins, tsm_t.apply(to), tsm_t.rotate(td),
                                        c_super=24, c_bin=96)
    assert (tsat.numpy() >= np.asarray(jsat)).all()
    # and exactly the flags and counts of the cull restated apart from the port's
    tb = building[1].bins
    blocks = trb._pad_rays(*trb._flat_rays(tsm_t.apply(to), tsm_t.rotate(td), 0.0,
                                           trb.NO_HIT_T)[:4], 128)
    restated = restated_cull(tb, block_cones(tb, *blocks, 4), 24)
    np.testing.assert_array_equal(tsat.numpy(), [w.size > 96 or n > 24 for w, n in restated])
    np.testing.assert_array_equal(t_counts.numpy(), [min(w.size, 96) for w, _ in restated])
    assert 0 < tsat.float().mean() < 1
    port_cull_under_jax(monkeypatch, [(building[0].bins, building[1].bins)])
    jn.step()
    tn.step()
    jc, tc = jn.micp_config, tn.micp_config
    assert (tc.c_super, tc.c_bin, tc.c_mid) == (jc.c_super, jc.c_bin, jc.c_mid)
    assert (tc.c_super, tc.c_bin) != (24, 96)
    out = capsys.readouterr().out
    assert "[rmcl_tpu_torch] MICP binned budgets saturated" in out
    # a node that may not adopt warns and keeps its budgets
    _, tn2 = _nodes(building, dict(config, engine_options={"auto_budget": False}))
    tn2.on_odometry(TTransform.identity(device="cpu"))
    tn2.set_static_dataset("lidar", tmodel, torch.from_numpy(points), torch.from_numpy(mask))
    with pytest.warns(UserWarning, match="budgets saturate"):
        tn2.step()
    assert (tn2.micp_config.c_super, tn2.micp_config.c_bin) == (24, 96)


def test_config_budgets_and_no_c_hyper(maps):
    """The engine_options budgets reach MICPConfig as in the JAX node,
    c_mid included; like the JAX node (node.py:99-107) the port's never
    reads c_hyper from the config."""
    config = _config("binned", "RC", {"engine_options": {"c_super": 12, "c_bin": 48,
                                                         "c_mid": 16, "c_hyper": 4}})
    jn, tn = _nodes(maps, config)
    for f in ("c_super", "c_bin", "c_mid", "c_hyper", "optimization_iterations", "solver",
              "adaptive_max_dist", "disable_correction"):
        assert getattr(tn.micp_config, f) == getattr(jn.micp_config, f), f
    assert tn.micp_config.c_hyper == 0 and tn.micp_config.c_mid == 16
    with pytest.raises(ValueError, match="bins"):
        tnode.MICPLocalization(dataclasses.replace(maps[1], bins=None), TPT({"engine": "binned"}))
    assert tnode.MICPLocalization(dataclasses.replace(maps[1], bins=None)).engine == "bvh"


def test_set_pose_and_the_sensor_mount(maps):
    """set_pose (with pose_guess_offset) and a config tsb mount give the
    JAX node's Tom and sensor mount."""
    config = _config("binned", "RC", {"pose_guess_offset": [0.1, 0.0, 0.0, 0.0, 0.0, 0.05]})
    config["sensors"]["lidar"]["tsb"] = [0.2, 0.0, 0.3, 0.0, 0.0, 0.1]
    jn, tn = _nodes(maps, config)
    assert tn.tom is None and tn.step() is None
    odom = [0.3, 0.1, 0.0, 0.0, 0.0, 0.2]
    jn.on_odometry(JTransform.from_pose_tuple(jnp.asarray(odom)))
    tn.on_odometry(TTransform.from_pose_tuple(odom, device="cpu"))
    np.testing.assert_allclose(tn.tom.trans.numpy(), np.asarray(jn.tom.trans), atol=1e-6)
    pose = [1.0, -0.5, 1.0, 0.0, 0.0, 0.4]
    jn.set_pose(JTransform.from_pose_tuple(jnp.asarray(pose)))
    tn.set_pose(TTransform.from_pose_tuple(pose, device="cpu"))
    np.testing.assert_allclose(tn.tom.trans.numpy(), np.asarray(jn.tom.trans), atol=1e-6)
    _quat_close(jn.tom.rot, tn.tom.rot, 1e-6)
    assert tn.corrections == 0 and float(tn.convergence_progress) == 0.0
    np.testing.assert_allclose(tn.sensors["lidar"].tsb.trans.numpy(),
                               np.asarray(jn.sensors["lidar"].tsb.trans), atol=1e-7)


def test_clock_mismatch_drops_and_delay_warns(maps, scans):
    jn, tn = _nodes(maps, _config("binned", "RC"))
    info = model_to_scan_info(JSpherical.create(**MODEL_KW))
    tinfo = tmsgs.ScanInfo(**dataclasses.asdict(info))
    _, _, odom, ranges, mask = scans[0]
    tn.on_odometry(TTransform.from_pose_tuple(odom, device="cpu"), stamp=100.0)
    msg = lambda stamp: tmsgs.ScanStamped(tmsgs.Header(stamp), tinfo,
                                          tmsgs.RangeData(ranges=ranges, mask=mask))
    with pytest.warns(UserWarning, match="STAMP MISMATCH"):
        tn.on_scan("lidar", msg(100.0 + 2e6))
    assert not tn.sensors["lidar"].has_data()
    with pytest.warns(UserWarning, match="NETWORK DELAY"):
        tn.on_scan("lidar", msg(99.0))
    assert tn.sensors["lidar"].has_data()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tn.on_scan("lidar", msg(100.2))  # within 0.5 s: no warning
    assert tn.sensors["lidar"].stamp == 100.2


def test_motion_compensation_matches_jax(maps, scans):
    """A scan with per-ray stamps after two stamped odometry samples: the
    de-skewed points within 1e-6 m of the JAX node's; a duplicate stamp
    replaces the last sample."""
    config = _config("binned", "RC", {"motion_compensation": True})
    config["sensors"]["lidar"]["tsb"] = [0.1, 0.0, 0.2, 0.0, 0.0, 0.05]
    jn, tn = _nodes(maps, config)
    info = model_to_scan_info(JSpherical.create(**MODEL_KW))
    for stamp, odom in ((1.0, [0.5, -0.3, 0.0, 0.0, 0.0, 0.3]),
                        (1.1, [0.6, -0.28, 0.0, 0.0, 0.0, 0.36]),
                        (1.1004, [0.61, -0.28, 0.0, 0.0, 0.0, 0.37])):  # a duplicate stamp
        jn.on_odometry(JTransform.from_pose_tuple(jnp.asarray(odom)), stamp=stamp)
        tn.on_odometry(TTransform.from_pose_tuple(odom, device="cpu"), stamp=stamp)
    assert len(tn._odom_hist) == 2 and tn._odom_hist[-1][0] == 1.1004
    _, _, _, ranges, mask = scans[0]
    rel = np.linspace(-0.1, 0.0, ranges.shape[0]).astype(np.float32)
    jn.on_scan("lidar", jmsgs.ScanStamped(jmsgs.Header(1.1), info,
                                          jmsgs.RangeData(ranges=ranges, mask=mask,
                                                          stamps=rel)))
    tn.on_scan("lidar", tmsgs.ScanStamped(tmsgs.Header(1.1), tmsgs.ScanInfo(
        **dataclasses.asdict(info)), tmsgs.RangeData(ranges=ranges, mask=mask, stamps=rel)))
    jp_, tp_ = np.asarray(jn.sensors["lidar"].points), tn.sensors["lidar"].points
    np.testing.assert_allclose(tp_, jp_, atol=DESKEW_TOL, rtol=DESKEW_TOL)
    moved = np.linalg.norm(jp_ - np.asarray(JSpherical.create(**MODEL_KW).polar_to_cartesian(
        jnp.asarray(ranges))), axis=1)
    assert moved.max() > 1e-3  # the compensation did move the points


def test_other_ingest_paths_match_jax(maps):
    """Depth, O1Dn and OnDn messages and a static dataset give the JAX
    node's sensor points and masks."""
    jn, tn = _nodes(maps, _config("bvh", "RC"))
    rng = np.random.default_rng(0)
    z = rng.uniform(0.2, 9.0, 12 * 16).astype(np.float32)
    dinfo = dict(width=16, height=12, fx=10.0, fy=10.0, cx=8.0, cy=6.0, range_min=0.3,
                 range_max=8.0)
    dmask = rng.uniform(size=z.shape) > 0.1
    jn.on_depth("cam", jmsgs.DepthStamped(jmsgs.Header(0.0), jmsgs.DepthInfo(**dinfo),
                                          jmsgs.RangeData(ranges=z, mask=dmask)))
    tn.on_depth("cam", tmsgs.DepthStamped(tmsgs.Header(0.0), tmsgs.DepthInfo(**dinfo),
                                          tmsgs.RangeData(ranges=z, mask=dmask)))
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origs = rng.normal(size=(50, 3)).astype(np.float32)
    r = rng.uniform(0.0, 12.0, 50).astype(np.float32)
    o1 = dict(orig=np.array([0.1, 0.2, 0.3], np.float32), dirs=dirs, range_min=0.5,
              range_max=10.0)
    jn.on_o1dn("o1", jmsgs.O1DnStamped(jmsgs.Header(0.0), jmsgs.O1DnInfo(**o1),
                                       jmsgs.RangeData(ranges=r)))
    tn.on_o1dn("o1", tmsgs.O1DnStamped(tmsgs.Header(0.0), tmsgs.O1DnInfo(**o1),
                                       tmsgs.RangeData(ranges=r)))
    on = dict(origs=origs, dirs=dirs, range_min=0.5, range_max=10.0)
    jn.on_ondn("on", jmsgs.OnDnStamped(jmsgs.Header(0.0), jmsgs.OnDnInfo(**on),
                                       jmsgs.RangeData(ranges=r)))
    tn.on_ondn("on", tmsgs.OnDnStamped(tmsgs.Header(0.0), tmsgs.OnDnInfo(**on),
                                       tmsgs.RangeData(ranges=r)))
    jn.set_static_dataset("st", JSpherical.create(**MODEL_KW), jnp.asarray(origs), r > 3)
    tn.set_static_dataset("st", TSpherical.create(**MODEL_KW), torch.from_numpy(origs),
                          torch.from_numpy(r > 3))
    for name in ("cam", "o1", "on", "st"):
        js, ts = jn.sensors[name], tn.sensors[name]
        np.testing.assert_allclose(ts.points, np.asarray(js.points), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ts.mask, np.asarray(js.mask))
        assert ts.outdated and ts.device_data is None
    text = tn.print_setup(color=False)
    assert "Node device: cpu" in text and "- o1" in text


def test_cp_candidates_in_the_node_run_the_plain_version(maps, scans, monkeypatch):
    """On CPU tensors a CP correction on the bins takes K7's plain version
    once per query (the kernel's launch counter stays put)."""
    from rmcl_tpu_torch.ops import closest_cuda, closest_point

    calls = []
    plain = closest_point._cp_candidates
    monkeypatch.setattr(closest_point, "_cp_candidates",
                        lambda *a: calls.append(a[1].shape[0]) or plain(*a))
    _, tn = _nodes(maps, _config("binned", "CP"))
    info = tmsgs.ScanInfo(**dataclasses.asdict(model_to_scan_info(JSpherical.create(**MODEL_KW))))
    stamp, _, odom, ranges, mask = scans[0]
    tn.on_odometry(TTransform.from_pose_tuple(odom, device="cpu"), stamp=stamp)
    tn.on_scan("lidar", tmsgs.ScanStamped(tmsgs.Header(stamp), info,
                                          tmsgs.RangeData(ranges=ranges, mask=mask)))
    launches = closest_cuda.cp_candidates.launches
    tn.step()
    assert calls == [-(-int(ranges.shape[0]) // 128)]
    assert closest_cuda.cp_candidates.launches == launches
