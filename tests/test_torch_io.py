"""The port's messages, conversions, replay log, de-skew, segmentation,
checkpoints, PLY writers and timing utilities against the JAX package's,
on the CPU, on the same numpy-made inputs.

Tolerances: the conversions are host-side numpy in both packages and equal
exactly, but where a sensor model renders points, whose float32 ray
directions (sin, cos) may differ in the last bit between the frameworks:
there 1e-5 m at ranges up to 50 m. De-skew within 1e-6 m, relative beyond
1 m (float32 slerps round apart by an ulp or two)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.io import conversions as jc
from rmcl_tpu.io import msgs as jmsgs
from rmcl_tpu.io.replay import MessageLog as JLog
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.ops.segmentation import segment_scan as j_segment
from rmcl_tpu.sensors.deskew import deskew_points as j_deskew
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu.utils import checkpoint as jck
from rmcl_tpu_torch.bvh.builder import build_bvh as t_build_bvh
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.io import conversions as tc
from rmcl_tpu_torch.io import msgs as tmsgs
from rmcl_tpu_torch.io.replay import MessageLog as TLog
from rmcl_tpu_torch.io.replay import replay
from rmcl_tpu_torch.math.se3 import Transform as TTransform
from rmcl_tpu_torch.ops.segmentation import segment_scan as t_segment
from rmcl_tpu_torch.sensors.deskew import deskew_points as t_deskew
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical
from rmcl_tpu_torch.utils import checkpoint as tck
from rmcl_tpu_torch.utils import timing, viz

torch.set_num_threads(2)

POINT_TOL = 1e-5
# de-skew: within 1e-6, relative beyond 1 m (float32 slerps of the two
# frameworks round apart by an ulp or two)
DESKEW_TOL = 1e-6


def _same(t_obj, j_obj, tol=0.0, path="msg"):
    """Two messages (dataclasses of arrays and scalars) field for field."""
    if dataclasses.is_dataclass(j_obj):
        assert type(t_obj).__name__ == type(j_obj).__name__, path
        for f in dataclasses.fields(j_obj):
            _same(getattr(t_obj, f.name), getattr(j_obj, f.name), tol, f"{path}.{f.name}")
    elif j_obj is None:
        assert t_obj is None, path
    elif isinstance(j_obj, (np.ndarray, jnp.ndarray)):
        t_arr, j_arr = np.asarray(t_obj), np.asarray(j_obj)
        assert t_arr.shape == j_arr.shape and t_arr.dtype == j_arr.dtype, path
        if tol and j_arr.dtype.kind == "f":
            np.testing.assert_allclose(t_arr, j_arr, atol=tol, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(t_arr, j_arr, err_msg=path)
    else:
        assert t_obj == j_obj or (tol and abs(t_obj - j_obj) <= tol), path


def _t(jmsg):
    """A JAX message as the port's (the same class names and fields)."""
    if dataclasses.is_dataclass(jmsg):
        cls = getattr(tmsgs, type(jmsg).__name__)
        return cls(**{f.name: _t(getattr(jmsg, f.name)) for f in dataclasses.fields(jmsg)})
    return jmsg


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_messages_have_the_jax_fields():
    for name in ("Header", "RangeData", "ScanInfo", "DepthInfo", "O1DnInfo", "OnDnInfo",
                 "ScanStamped", "DepthStamped", "O1DnStamped", "OnDnStamped", "PointCloud2",
                 "LaserScan", "LikelihoodStats", "MICPSensorStats", "ParticleStatsMsg",
                 "SetInitialPoseRequest"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jmsgs, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tmsgs, name))]
        assert tf == jf, name
    info = tmsgs.O1DnInfo(orig=np.zeros(3), dirs=np.zeros((12, 3)), range_min=0, range_max=1,
                          width=4)
    assert info.grid() == (4, 3)
    cloud = tmsgs.PointCloud2(tmsgs.Header(), points=np.array([[0, 0, 0], [np.nan, 0, 0]]))
    np.testing.assert_array_equal(cloud.valid_mask(), [True, False])


def test_info_model_conversions_match_jax(rng):
    jmodel = JSpherical.vlp16(width=360)
    info = jc.model_to_scan_info(jmodel)
    _same(tc.model_to_scan_info(tc.scan_info_to_model(_t(info))), info)
    tmodel = tc.scan_info_to_model(_t(info))
    for f in ("theta_min", "theta_inc", "phi_min", "phi_inc", "width", "height"):
        assert getattr(tmodel, f) == float(getattr(jc.scan_info_to_model(info), f)), f
    laser = jmsgs.LaserScan(jmsgs.Header(1.0), angle_min=-1.0, angle_increment=0.01,
                            range_min=0.1, range_max=10.0,
                            ranges=np.arange(200, dtype=np.float32))
    _same(tc.laser_scan_to_scan_info(_t(laser)), jc.laser_scan_to_scan_info(laser))
    _same(tc.laser_scan_to_scan(_t(laser), 10, 10, 2), jc.laser_scan_to_scan(laser, 10, 10, 2))
    dinfo = jmsgs.DepthInfo(width=16, height=12, fx=10.0, fy=11.0, cx=8.0, cy=6.0,
                            range_min=0.3, range_max=8.0)
    jd, td = jc.depth_info_to_model(dinfo), tc.depth_info_to_model(_t(dinfo))
    z = rng.uniform(0.2, 9.0, 16 * 12).astype(np.float32)
    np.testing.assert_allclose(td.depth_to_cartesian(torch.from_numpy(z)).numpy(),
                               np.asarray(jd.depth_to_cartesian(jnp.asarray(z))), atol=1e-6)
    dirs = rng.normal(size=(30, 3)).astype(np.float32)
    o1 = jmsgs.O1DnInfo(orig=np.array([0.1, 0.2, 0.3], np.float32), dirs=dirs, range_min=0.5,
                        range_max=9.0)
    on = jmsgs.OnDnInfo(origs=dirs * 2, dirs=dirs, range_min=0.5, range_max=9.0)
    r = rng.uniform(0, 10, 30).astype(np.float32)
    for jf, tf, i in ((jc.o1dn_info_to_model, tc.o1dn_info_to_model, o1),
                      (jc.ondn_info_to_model, tc.ondn_info_to_model, on)):
        jmod, tmod = jf(i), tf(_t(i), device="cpu")
        assert (tmod.range.min, tmod.range.max) == (float(jmod.range.min), float(jmod.range.max))
        np.testing.assert_array_equal(tmod.polar_to_cartesian(torch.from_numpy(r)).numpy(),
                                      np.asarray(jmod.polar_to_cartesian(jnp.asarray(r))))


def test_scan_and_cloud_conversions_match_jax(rng):
    info = jmsgs.ScanInfo(phi_n=4, theta_n=32, phi_min=-0.2, phi_inc=0.1, theta_min=-np.pi,
                          theta_inc=2 * np.pi / 32, range_min=0.5, range_max=20.0)
    r = rng.uniform(1.0, 30.0, 128).astype(np.float32)
    r[::7] = 0.0
    scan = jmsgs.ScanStamped(jmsgs.Header(1.5), info, jmsgs.RangeData(
        ranges=r, mask=rng.uniform(size=128) > 0.2, intensities=r * 2,
        stamps=np.linspace(0, 0.1, 128).astype(np.float32)))
    jp, jmask = jc.scan_to_points(scan)
    tp, tmask = tc.scan_to_points(_t(scan))
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_allclose(tp, jp, atol=POINT_TOL, rtol=0)
    _same(tc.scan_to_pointcloud(_t(scan)), jc.scan_to_pointcloud(scan), tol=POINT_TOL)
    # a cloud with every channel: to a scan grid (both policies) and to O1Dn
    pts = (rng.normal(size=(300, 3)) * 5).astype(np.float32)
    pts[3] = np.nan
    cloud = jmsgs.PointCloud2(
        jmsgs.Header(2.0), points=pts, normals=rng.normal(size=(300, 3)).astype(np.float32),
        intensities=rng.uniform(size=300).astype(np.float32),
        stamps=np.linspace(0, 0.1, 300).astype(np.float32),
        labels=np.arange(300, dtype=np.int32), colors=rng.uniform(size=(300, 3)).astype(np.float32),
        width=30, height=10)
    sinfo = jc.model_to_scan_info(JSpherical.create(width=90, height=8, range_min=0.5))
    for keep in ("nearest", "last"):
        _same(tc.pointcloud_to_scan(_t(cloud), _t(sinfo), keep=keep),
              jc.pointcloud_to_scan(cloud, sinfo, keep=keep))
    for skip in (1, 2):
        _same(tc.pointcloud_to_o1dn(_t(cloud), width_skip=skip),
              jc.pointcloud_to_o1dn(cloud, width_skip=skip))
    o1 = jc.pointcloud_to_o1dn(cloud)
    kw = dict(range_min=0.2, range_max=8.0, width_skip_begin=1, width_skip_end=2,
              width_increment=3, height_skip_begin=1, height_increment=2)
    _same(tc.filter_o1dn(_t(o1), **kw), jc.filter_o1dn(o1, **kw))
    _same(tc.o1dn_to_pointcloud(_t(o1)), jc.o1dn_to_pointcloud(o1), tol=POINT_TOL)
    empty = jmsgs.PointCloud2(jmsgs.Header(), points=np.zeros((0, 3), np.float32))
    _same(tc.pointcloud_to_o1dn(_t(empty)), jc.pointcloud_to_o1dn(empty))


def _records(rng):
    """One record of every kind the log persists, as (kind, channel, JAX payload)."""
    r = rng.uniform(1, 9, 24).astype(np.float32)
    dirs = rng.normal(size=(24, 3)).astype(np.float32)
    sinfo = jmsgs.ScanInfo(phi_n=2, theta_n=12, phi_min=-0.1, phi_inc=0.1, theta_min=-3.0,
                           theta_inc=0.5, range_min=0.5, range_max=20.0)
    return [
        ("odom", "tf", JTransform.from_pose_tuple(jnp.asarray([1.0, 2.0, 0.5, 0.0, 0.1, 0.3]))),
        ("scan", "lidar", jmsgs.ScanStamped(jmsgs.Header(0.1), sinfo, jmsgs.RangeData(
            ranges=r, mask=r > 2, stamps=np.linspace(0, 0.1, 24).astype(np.float32)))),
        ("depth", "cam", jmsgs.DepthStamped(jmsgs.Header(0.2), jmsgs.DepthInfo(
            6, 4, 5.0, 5.0, 3.0, 2.0, 0.3, 8.0), jmsgs.RangeData(ranges=r, mask=r > 3))),
        ("ondn", "gen", jmsgs.OnDnStamped(jmsgs.Header(0.3), jmsgs.OnDnInfo(
            dirs * 2, dirs, 0.1, 9.0), jmsgs.RangeData(ranges=r, mask=r > 4))),
        ("o1dn", "o1", jmsgs.O1DnStamped(jmsgs.Header(0.4), jmsgs.O1DnInfo(
            np.ones(3, np.float32), dirs, 0.1, 9.0, width=6, height=4), jmsgs.RangeData(
            ranges=r, mask=r > 5, stamps=r / 100, colors=np.ones((24, 4), np.float32)))),
        ("cloud", "lidar", {"points": dirs * r[:, None], "mask": r > 6}),
    ]


def _same_record(t_rec, j_rec):
    assert (t_rec.stamp, t_rec.kind, t_rec.channel) == (j_rec.stamp, j_rec.kind, j_rec.channel)
    if j_rec.kind == "odom":
        np.testing.assert_array_equal(t_rec.payload.rot.numpy(), np.asarray(j_rec.payload.rot))
        np.testing.assert_array_equal(t_rec.payload.trans.numpy(),
                                      np.asarray(j_rec.payload.trans))
    elif j_rec.kind == "cloud":
        for k in ("points", "mask"):
            np.testing.assert_array_equal(np.asarray(t_rec.payload[k]),
                                          np.asarray(j_rec.payload[k]))
    else:
        _same(t_rec.payload, j_rec.payload)


def test_message_log_loads_across_packages(tmp_path, rng):
    """A log written by either package loads in the other, records equal;
    replay pumps them in stamp order."""
    jlog, tlog = JLog(), TLog()
    for k, (kind, channel, payload) in enumerate(_records(rng)):
        stamp = 0.5 - 0.1 * k  # added out of order
        jlog.add(stamp, kind, channel, payload)
        tlog.add(stamp, kind, channel, _t(payload) if kind != "odom" else
                 TTransform.from_pose_tuple([1.0, 2.0, 0.5, 0.0, 0.1, 0.3], device="cpu"))
    jlog.save(str(tmp_path / "j.npz"))
    tlog.save(str(tmp_path / "t.npz"))
    from_j = list(TLog.load(str(tmp_path / "j.npz"), device="cpu"))
    from_t = list(JLog.load(str(tmp_path / "t.npz")))
    j_ref = list(JLog.load(str(tmp_path / "j.npz")))
    assert len(from_j) == len(from_t) == len(j_ref) == 6
    for a, b, c in zip(from_j, from_t, j_ref):
        _same_record(a, c)
        assert (b.stamp, b.kind, b.channel) == (c.stamp, c.kind, c.channel)
        if c.kind == "odom":
            np.testing.assert_allclose(np.asarray(b.payload.trans), np.asarray(c.payload.trans),
                                       atol=1e-6)
        elif c.kind != "cloud":
            _same(b.payload, c.payload)
    seen = []
    n = replay(TLog.load(str(tmp_path / "j.npz"), device="cpu"),
               {k: seen.append for k in ("odom", "scan", "o1dn", "cloud")}, until=0.45)
    assert n == 3 and [r.kind for r in seen] == ["cloud", "o1dn", "scan"]
    bad = TLog()
    bad.add(0.0, "mystery", "x", 1)
    with pytest.raises(ValueError, match="mystery"):
        bad.save(str(tmp_path / "bad.npz"))


def test_deskew_points_match_jax(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 5
    rel = np.linspace(-0.1, 0.02, 500).astype(np.float32)
    tsb = [0.1, 0.0, 0.2, 0.0, 0.0, 0.05]
    a, b = [0.5, -0.3, 0.0, 0.0, 0.0, 0.3], [0.6, -0.28, 0.01, 0.01, 0.0, 0.36]
    for st_a, st_b in ((1.0, 1.1), (1.1, 1.1004)):  # the second pair is degenerate
        j = j_deskew(jnp.asarray(pts), jnp.asarray(rel), jnp.float32(1.1),
                     JTransform.from_pose_tuple(jnp.asarray(tsb)),
                     JTransform.from_pose_tuple(jnp.asarray(a)), jnp.float32(st_a),
                     JTransform.from_pose_tuple(jnp.asarray(b)), jnp.float32(st_b))
        t = t_deskew(torch.from_numpy(pts), torch.from_numpy(rel), 1.1,
                     TTransform.from_pose_tuple(tsb, device="cpu"),
                     TTransform.from_pose_tuple(a, device="cpu"), st_a,
                     TTransform.from_pose_tuple(b, device="cpu"), st_b)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=DESKEW_TOL, rtol=DESKEW_TOL)
    # the degenerate pair is the identity at the reference stamp
    np.testing.assert_allclose(t.numpy(), pts, atol=1e-5)


@pytest.mark.parametrize("mask", [False, True])
def test_segment_scan_matches_jax(mask):
    """An empty room seen from a pose, with an injected obstacle and stale
    beams: the masks equal, the points and plane distances within
    POINT_TOL."""
    pose = [0.0, 0.0, 1.5, 0.0, 0.0, 0.1]
    kw = dict(width=180, height=4, phi_min=-0.05, phi_max=0.05, range_max=30.0)
    jbvh = j_build_bvh(jm.make_room_scene(n_pillars=0, seed=0))
    tbvh = t_build_bvh(tm.make_room_scene(n_pillars=0, seed=0), device="cpu")
    jmodel, tmodel = JSpherical.create(**kw), TSpherical.create(**kw)
    sim = j_simulate(jbvh, jmodel, JTransform.from_pose_tuple(jnp.asarray(pose)))
    ranges = np.where(np.asarray(sim.hit), np.asarray(sim.t), 0.0).astype(np.float32)
    fwd = np.tile(np.abs(np.linspace(-np.pi, np.pi, 180, endpoint=False)) < 0.2, 4)
    ranges = np.where(fwd & (ranges > 2.0), 1.0, ranges)  # a dynamic obstacle
    back = np.tile(np.abs(np.linspace(-np.pi, np.pi, 180, endpoint=False)) > 2.9, 4)
    ranges = np.where(back, ranges + 3.0, ranges).astype(np.float32)  # stale map
    m = (np.arange(ranges.size) % 5 != 0) if mask else None
    j = j_segment(jbvh, jmodel, JTransform.from_pose_tuple(jnp.asarray(pose)),
                  jnp.asarray(ranges), mask_real=None if m is None else jnp.asarray(m))
    t = t_segment(tbvh, tmodel, TTransform.from_pose_tuple(pose, device="cpu"),
                  torch.from_numpy(ranges), mask_real=None if m is None else torch.from_numpy(m))
    for f in ("scan_outlier", "map_outlier"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    for f in ("scan_points", "map_points", "plane_dist"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=POINT_TOL, rtol=0, err_msg=f)
    assert t.scan_outlier.sum() > 0 and t.map_outlier.sum() > 0


def test_micp_checkpoints_load_across_packages(tmp_path):
    tom = [0.1, -0.2, 0.3, 0.01, 0.02, 0.3]
    tbo = [1.0, 2.0, 0.0, 0.0, 0.0, -0.4]
    tck.save_micp_state(str(tmp_path / "t.npz"), TTransform.from_pose_tuple(tom, device="cpu"),
                        TTransform.from_pose_tuple(tbo, device="cpu"), torch.tensor(0.75),
                        extra={"step": 12})
    jck.save_micp_state(str(tmp_path / "j.npz"), JTransform.from_pose_tuple(jnp.asarray(tom)),
                        JTransform.from_pose_tuple(jnp.asarray(tbo)), jnp.float32(0.75),
                        extra={"step": 12})
    for path in ("t.npz", "j.npz"):
        t_tom, t_tbo, t_conv, t_extra = tck.load_micp_state(str(tmp_path / path), device="cpu")
        j_tom, j_tbo, j_conv, j_extra = jck.load_micp_state(str(tmp_path / path))
        for a, b in ((t_tom, j_tom), (t_tbo, j_tbo)):
            np.testing.assert_allclose(a.trans.numpy(), np.asarray(b.trans), atol=1e-6)
            np.testing.assert_allclose(a.rot.numpy(), np.asarray(b.rot), atol=1e-6)
        assert float(t_conv) == float(j_conv) == 0.75
        assert int(t_extra["step"]) == int(j_extra["step"]) == 12


def test_mcl_checkpoint_round_trip(tmp_path):
    """The cloud and the generator's state: a restored generator continues
    the saved stream draw for draw."""
    from rmcl_tpu_torch.mcl.particles import ParticleCloud

    g = torch.Generator().manual_seed(3)
    poses = TTransform.from_pose_tuple(torch.rand((5, 6), generator=g), device="cpu")
    cloud = ParticleCloud.create(5, device="cpu").with_poses(poses)
    cloud = dataclasses.replace(cloud, alive=torch.tensor([1, 1, 0, 1, 0], dtype=torch.bool))
    tck.save_mcl_state(str(tmp_path / "m.npz"), cloud, g, extra={"n": 7})
    expect = torch.rand(4, generator=g)
    back, g2, extra = tck.load_mcl_state(str(tmp_path / "m.npz"), device="cpu")
    torch.testing.assert_close(torch.rand(4, generator=g2), expect, rtol=0, atol=0)
    torch.testing.assert_close(back.poses.trans, cloud.poses.trans, rtol=0, atol=0)
    assert torch.equal(back.alive, cloud.alive) and int(extra["n"]) == 7


def test_sharded_checkpoint_round_trip(tmp_path):
    """tests/test_aux.py:170 on one process (no group: world size 1): a
    cloud restored onto a fresh template equals the saved one."""
    from rmcl_tpu_torch.mcl.particles import ParticleCloud

    cloud = ParticleCloud.create(128, device="cpu")
    cloud = dataclasses.replace(cloud, likelihood=dataclasses.replace(
        cloud.likelihood, mean=torch.linspace(0, 1, 128)))
    path = str(tmp_path / "ckpt")
    tck.save_sharded(path, cloud)
    out = tck.load_sharded(path, ParticleCloud.create(128, device="cpu"))
    torch.testing.assert_close(out.likelihood.mean, cloud.likelihood.mean, rtol=0, atol=0)
    torch.testing.assert_close(out.poses.rot, cloud.poses.rot, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not match"):
        tck.load_sharded(path, ParticleCloud.create(64, device="cpu"))


def test_sharded_checkpoint_on_ranks(tmp_path):
    """Two gloo ranks each save and restore their half of a cloud bit for
    bit; one process (world size 1) refuses that checkpoint."""
    from rmcl_tpu_torch.mcl.particles import ParticleCloud
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel.mesh import launch

    g = torch.Generator().manual_seed(5)
    cloud = ParticleCloud.create(64, device="cpu").with_poses(
        TTransform.from_pose_tuple(torch.rand((64, 6), generator=g), device="cpu"))
    path = str(tmp_path / "ckpt2")
    jobs = [("ckpt", ((2,), ("rays",)), pg.checkpoint_job,
             dict(cloud=pg.to_host(cloud), path=path))]
    runs = launch(pg.run_jobs, 2, "gloo", ("cpu", jobs), timeout=120.0)
    assert all(r["ckpt"]["bitwise"] for r in runs)
    with pytest.raises(ValueError, match="written by 2 ranks"):
        tck.load_sharded(path, ParticleCloud.create(32, device="cpu"))


def test_ply_writers_match_jax(tmp_path, rng):
    """The same channels and the same PLY files as the JAX writers, from
    tensors."""
    from rmcl_tpu.mcl.particles import ParticleCloud as JCloud
    from rmcl_tpu.micp.correspondences import Correspondences as JCorr
    from rmcl_tpu.utils import viz as jviz
    from rmcl_tpu_torch.convert import particles_from_arrays
    from rmcl_tpu_torch.micp.correspondences import Correspondences as TCorr

    n = 20
    arrays = dict(rot=np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
                  trans=rng.normal(size=(n, 3)).astype(np.float32),
                  mean=rng.uniform(size=n).astype(np.float32),
                  sigma=rng.uniform(size=n).astype(np.float32),
                  n_meas=rng.uniform(1, 9, n).astype(np.float32),
                  state_sigma=np.zeros((n, 6), np.float32), alive=rng.uniform(size=n) > 0.3)
    tcloud = particles_from_arrays(arrays, device="cpu")
    from rmcl_tpu.math.gaussian import Gaussian1D as JG1

    jcloud = JCloud(poses=JTransform(rot=jnp.asarray(arrays["rot"]),
                                     trans=jnp.asarray(arrays["trans"])),
                    likelihood=JG1(mean=jnp.asarray(arrays["mean"]),
                                   sigma=jnp.asarray(arrays["sigma"]),
                                   n_meas=jnp.asarray(arrays["n_meas"])),
                    state_sigma=jnp.asarray(arrays["state_sigma"]),
                    alive=jnp.asarray(arrays["alive"]))
    tch, jch = viz.particle_cloud_channels(tcloud), jviz.particle_cloud_channels(jcloud)
    for k in jch:
        np.testing.assert_allclose(tch[k], jch[k], rtol=1e-6, err_msg=k)
    d, m = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    found = rng.uniform(size=n) > 0.4
    outs = {}
    for tag, mod, corr, x in (
            ("t", viz, TCorr(torch.from_numpy(m), torch.from_numpy(nrm), torch.from_numpy(found)),
             torch.from_numpy),
            ("j", jviz, JCorr(jnp.asarray(m), jnp.asarray(nrm), jnp.asarray(found)), jnp.asarray)):
        mod.save_particles_ply(str(tmp_path / f"{tag}_p.ply"), tcloud if tag == "t" else jcloud)
        mod.save_correspondences_ply(str(tmp_path / f"{tag}_c.ply"), x(d), corr)
        mod.save_scan_ply(str(tmp_path / f"{tag}_s.ply"), x(d), x(found))
        outs[tag] = [(tmp_path / f"{tag}_{k}.ply").read_text() for k in "pcs"]
    assert outs["t"][0] == outs["j"][0] and outs["t"][2] == outs["j"][2]
    # the correspondence lines: the projections in float32 may round apart
    tl, jl = outs["t"][1].splitlines(), outs["j"][1].splitlines()
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if a != b:
            np.testing.assert_allclose(np.array(a.split(), float), np.array(b.split(), float),
                                       atol=1e-5)


def test_timing_utilities():
    x = torch.ones(3)
    assert timing.sync({"a": [x, (x,)]}) is not None
    sw = timing.StopWatch()
    assert sw() >= 0.0 and sw() >= 0.0
    best = timing.timeit_device(lambda a: a * 2, x, iters=3)
    assert 0.0 <= best < 1.0
    st = timing.StageTimer()
    with st.stage("s", block_on=lambda: x):
        pass
    assert st.count["s"] == 1 and "s" in st.report()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with timing.device_trace(str(tmp_path / "trace")):
        torch.ones(64) @ torch.ones(64)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
