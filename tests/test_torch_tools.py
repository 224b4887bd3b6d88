"""The port's command-line tools against the JAX package's, on the CPU.

Every CLI runs with ``--device cpu`` on the world and message log of
``tests/test_tools.py`` (a room map written as OBJ, six drifting scans with
clouds); the JAX tool runs on the same files. The JAX map's bins are built
by each package in its default order (the native C++ one on both sides
wherever g++ builds the libraries), so both tools cast on the identical
packing. Also the golden MICP track
(``tests/golden/micp_track.npz``) through the port's pipeline."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.io import msgs as jmsgs
from rmcl_tpu.io.conversions import pointcloud_to_o1dn as j_pointcloud_to_o1dn
from rmcl_tpu.io.replay import MessageLog as JMessageLog
from test_tools import world_and_log  # noqa: F401  (the fixture world and log)

torch.set_num_threads(2)

# track poses: the two tools run the same corrections on the same packing;
# float32 solves in two frameworks round apart by ~1e-6 a step
TRACK_TOL = 1e-4
# the golden track's own tolerance (tests/test_golden.py)
GOLDEN_TOL = 2e-3
GUESS = ["--initial-pose-guess", "0.4", "-0.3", "1.0", "0", "0", "0.3"]


def _tracks(a, b, tol):
    za, zb = np.load(a), np.load(b)
    np.testing.assert_array_equal(za["stamps"], zb["stamps"])
    np.testing.assert_allclose(zb["trans"], za["trans"], atol=tol, rtol=0)
    sign = np.sign(np.sum(za["rot"] * zb["rot"], axis=1, keepdims=True))
    np.testing.assert_allclose(zb["rot"] * sign, za["rot"], atol=tol, rtol=0)
    return zb


@pytest.mark.parametrize("steps", ["1", "3"])
def test_micp_cli_matches_jax(world_and_log, tmp_path, steps):
    from rmcl_tpu.tools.micp_localization import main as j_main
    from rmcl_tpu_torch.tools.micp_localization import main as t_main

    map_path, log_path, true_poses, _ = world_and_log
    args = ["--map", map_path, "--log", log_path, "--steps-per-scan", steps] + GUESS
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert j_main(args + ["--out", j_out]) == 0
    assert t_main(args + ["--out", t_out, "--device", "cpu", "--banner"]) == 0
    z = _tracks(j_out, t_out, TRACK_TOL)
    assert z["trans"].shape == (6, 3)
    if steps == "3":  # as tests/test_tools.py holds the JAX tool
        assert np.linalg.norm(z["trans"][-1] - np.asarray(true_poses[-1].trans)) < 0.05


def test_micp_cli_cp_and_bvh_match_jax(world_and_log, tmp_path):
    """The same CLI with a config: CP correspondences on the bins, then RC
    on the BVH (engine: bvh)."""
    from rmcl_tpu.tools.micp_localization import main as j_main
    from rmcl_tpu_torch.tools.micp_localization import main as t_main

    map_path, log_path, true_poses, _ = world_and_log
    for name, text in (("cp", "sensors:\n  lidar:\n    correspondences:\n      type: CP\n"),
                       ("bvh", "engine: bvh\n")):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(text)
        args = ["--map", map_path, "--log", log_path, "--steps-per-scan", "3",
                "--config", str(cfg)] + GUESS
        j_out, t_out = str(tmp_path / f"j_{name}.npz"), str(tmp_path / f"t_{name}.npz")
        assert j_main(args + ["--out", j_out]) == 0
        assert t_main(args + ["--out", t_out, "--device", "cpu"]) == 0
        z = _tracks(j_out, t_out, TRACK_TOL)
        assert np.linalg.norm(z["trans"][-1] - np.asarray(true_poses[-1].trans)) < 0.05


def test_micp_cli_o1dn_records(world_and_log, tmp_path):
    """O1Dn records, written by the JAX package's log, drive the port's CLI."""
    from rmcl_tpu_torch.tools.micp_localization import main

    map_path, log_path, true_poses, _ = world_and_log
    log = JMessageLog()
    for rec in JMessageLog.load(log_path):
        if rec.kind == "odom":
            log.add(rec.stamp, "odom", rec.channel, rec.payload)
        elif rec.kind == "cloud":
            cloud = jmsgs.PointCloud2(header=jmsgs.Header(stamp=rec.stamp),
                                      points=np.asarray(rec.payload["points"]))
            log.add(rec.stamp, "o1dn", "lidar", j_pointcloud_to_o1dn(cloud))
    path = str(tmp_path / "run_o1dn.npz")
    log.save(path)
    out = str(tmp_path / "track_o1dn.npz")
    assert main(["--map", map_path, "--log", path, "--out", out, "--steps-per-scan", "3",
                 "--device", "cpu"] + GUESS) == 0
    z = np.load(out)
    assert np.linalg.norm(z["trans"][-1] - np.asarray(true_poses[-1].trans)) < 0.05


def test_map_segmentation_cli_matches_jax(world_and_log, tmp_path):
    """Equal outputs, but at a beam whose plane distance sits at the 0.15 m
    threshold: scan k was rendered 0.05 k m from the odometry pose along x,
    so at k = 3 the walls facing x lie 0.15 m off, and float32 rounding in
    either package decides the compare. Such beams may differ, and only
    where the JAX package's own plane distance is within 1e-5 m of it."""
    from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
    from rmcl_tpu.geom.mesh import load_mesh as j_load_mesh
    from rmcl_tpu.io.conversions import scan_info_to_model as j_model
    from rmcl_tpu.math.se3 import Transform as JTransform
    from rmcl_tpu.ops.segmentation import segment_scan as j_segment
    from rmcl_tpu.tools.map_segmentation import main as j_main
    from rmcl_tpu_torch.tools.map_segmentation import main as t_main

    map_path, log_path, _, _ = world_and_log
    pose = [0.4, -0.3, 1.0, 0.0, 0.0, 0.3]
    args = ["--map", map_path, "--log", log_path, "--pose"] + [str(v) for v in pose]
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert j_main(args + ["--out", j_out]) == 0
    assert t_main(args + ["--out", t_out, "--device", "cpu"]) == 0
    zj, zt = np.load(j_out), np.load(t_out)
    assert sorted(zj.files) == sorted(zt.files) and int(zt["n_scans"]) == 6
    scans = [r for r in JMessageLog.load(log_path) if r.kind == "scan"]
    bvh = j_build_bvh(j_load_mesh(map_path))
    for i, rec in enumerate(scans):
        np.testing.assert_array_equal(zt[f"s{i}_stamp"], zj[f"s{i}_stamp"])
        off = np.zeros(len(rec.payload.data.ranges), bool)
        for k in ("scan_outlier", "map_outlier"):
            off |= zt[f"s{i}_{k}"] != zj[f"s{i}_{k}"]
        if off.any():
            seg = j_segment(bvh, j_model(rec.payload.info),
                            JTransform.from_pose_tuple(jnp.asarray(pose)),
                            jnp.asarray(rec.payload.data.ranges),
                            mask_real=jnp.asarray(rec.payload.data.mask))
            gap = np.abs(np.asarray(seg.plane_dist)[off] - 0.15)
            assert gap.max() <= 1e-5, (i, int(off.sum()), gap.max())
        for k in ("scan_points", "map_points"):  # ray directions round apart in the last bit
            np.testing.assert_allclose(zt[f"s{i}_{k}"], zj[f"s{i}_{k}"], atol=1e-5, rtol=0)
    # the first scan was rendered exactly from that pose
    assert zt["s0_scan_outlier"].sum() == 0 and zt["s0_map_outlier"].sum() == 0


@pytest.mark.parametrize("to", ["scan", "o1dn"])
def test_convert_cli_matches_jax(world_and_log, tmp_path, to):
    from rmcl_tpu.tools.convert import main as j_main
    from rmcl_tpu_torch.tools.convert import main as t_main

    _, log_path, _, _ = world_and_log
    args = ["--log", log_path, "--to", to, "--width", "180", "--height", "8",
            "--phi-min", "-0.3", "--phi-max", "0.2", "--range-min", "0.1", "--range-max", "30"]
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert j_main(args + ["--out", j_out]) == 0
    assert t_main(args + ["--out", t_out, "--device", "cpu"]) == 0
    zj, zt = np.load(j_out), np.load(t_out)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def test_rmcl_cli_holds_the_truth(world_and_log, tmp_path):
    """The particle filter from a Gaussian around a pose 0.1 m off; the
    port's torch.Generator streams are not jax.random's, so it is held to
    the truth as tests/test_tools.py holds the JAX tool (0.35 m), here with
    2,000 particles."""
    from rmcl_tpu_torch.tools.rmcl_localization import main

    map_path, log_path, true_poses, _ = world_and_log
    cfg = tmp_path / "rmcl.yaml"
    cfg.write_text("max_particles: 2000\nsensor_update:\n  samples: 64\n")
    out = str(tmp_path / "track_rmcl.npz")
    assert main(["--map", map_path, "--log", log_path, "--out", out, "--config", str(cfg),
                 "--initial-pose", "0.5", "-0.3", "1.0", "0", "0", "0.3",
                 "--device", "cpu"]) == 0
    z = np.load(out)
    assert z["trans"].shape[0] == 6
    assert np.linalg.norm(z["trans"][-1] - np.asarray(true_poses[-1].trans)) < 0.35


def test_tools_default_to_the_card_and_name_unported_formats(world_and_log, tmp_path,
                                                             monkeypatch):
    from rmcl_tpu_torch.tools import micp_localization

    map_path, log_path, _, _ = world_and_log
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        micp_localization.main(["--map", map_path, "--log", log_path])
    xyz = str(tmp_path / "world.xyz")
    with pytest.raises(ValueError, match="unsupported mesh format '.xyz'"):
        micp_localization.main(["--map", xyz, "--log", log_path, "--device", "cpu"])


def test_golden_micp_track():
    """The scenario of tests/golden/gen_micp_track.py (room, 12-step arc,
    drifting odometry, three corrections a step on the BVH) through the
    port's pipeline, held to the committed JAX track at its tolerance."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.mesh import make_room_scene
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.pipeline import (MICPConfig, MICPSensorConfig, MICPSensorData,
                                              correct_once)
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    dev = "cpu"
    bvh = build_bvh(make_room_scene(n_pillars=3, seed=2), device=dev)
    model = SphericalModel.create(width=180, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    cfg = MICPConfig(optimization_iterations=5)
    scfg = MICPSensorConfig.create(max_dist=1.0)
    ts = np.linspace(0, 1, 12)
    true_xyz = np.stack([0.8 * np.cos(2 * ts), 0.8 * np.sin(2 * ts), 1.0 + 0.05 * ts],
                        -1).astype(np.float32)
    true_yaw = (0.4 * ts).astype(np.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    tom = Transform.from_xyz_euler(f32([0.05, -0.04, 0.03]), f32([0.0, 0.0, 0.02]))
    progress = torch.tensor(0.0)
    track, toms = [], []
    for i in range(len(ts)):
        true_pose = Transform.from_xyz_euler(torch.from_numpy(true_xyz[i]),
                                             f32([0.0, 0.0, float(true_yaw[i])]))
        drift = Transform.from_xyz_euler(f32([0.01 * i, -0.006 * i, 0.0]),
                                         f32([0.0, 0.0, 0.004 * i]))
        tbo = drift @ true_pose
        hits = simulate(bvh, model, true_pose)
        sensor = MICPSensorData(model=model, points=hits.point, mask=hits.hit,
                                tsb=Transform.identity(device=dev), config=scfg)
        for _ in range(3):
            tom, stats = correct_once(bvh, [sensor], tom, tbo, progress, cfg)
            progress = stats.convergence_progress
        est = tom @ tbo
        track.append(torch.cat([est.trans, est.rot]).numpy())
        toms.append(torch.cat([tom.trans, tom.rot]).numpy())
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", "micp_track.npz"))
    np.testing.assert_allclose(np.asarray(track), gold["track"], atol=GOLDEN_TOL)
    np.testing.assert_allclose(np.asarray(toms), gold["toms"], atol=GOLDEN_TOL)
    err = np.linalg.norm(np.asarray(track)[:, :3] - true_xyz, axis=1)
    assert err.max() < 5e-3, err


@pytest.mark.parametrize("tool", ["micp_localization", "rmcl_localization", "map_segmentation",
                                  "convert"])
def test_tools_run_as_modules(tool):
    """Each tool runs as ``python -m rmcl_tpu_torch.tools.<name>`` and
    offers ``--device`` with the card as its default."""
    import subprocess
    import sys as _sys

    out = subprocess.run([_sys.executable, "-m", f"rmcl_tpu_torch.tools.{tool}", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "default: the card" in out.stdout
