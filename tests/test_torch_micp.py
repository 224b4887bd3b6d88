"""The slice as a whole: MICP-L corrections in both packages, and the
port's import boundary.

A room-scene map (bins carried across, so both packages cast on the
identical packing) and one spherical sensor; the dataset is the JAX
simulation at the true pose, fed to both as the same numpy points. Both
start at +0.2 m z and 0.05 rad yaw and run 5 ``correct_once`` calls; the
poses must agree after every call."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.bvh.builder import build_bvh
from rmcl_tpu.geom.mesh import make_room_scene
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.micp import correspondences as jc
from rmcl_tpu.micp import pipeline as jp
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu_torch.convert import bins_from_arrays, bvh_from_arrays, transform_from_arrays
from rmcl_tpu_torch.math.se3 import Transform as TTransform
from rmcl_tpu_torch.micp import pipeline as tp
from rmcl_tpu_torch.micp.correspondences import find_cpc, find_rcc
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical

torch.set_num_threads(2)

# poses: float32 solves over the same correspondences up to near-tie prims
POSE_TOL = 1e-4
MATCH_FRAC_TOL = 0.005  # valid_matches, as a fraction of the rays
PROGRESS_TOL = 1e-3
# closest-point correspondences: a measured point equidistant from two
# perpendicular faces (a wall and the floor) takes either face's normal,
# decided by float32 rounding; on the bins 2 of 1440 points do so in the
# first correction, which moves that solve by 2.4e-4 m and its progress by
# 2e-3 (later corrections agree to 3e-7 m)
CP_POSE_TOL = 5e-4
CP_PROGRESS_TOL = 5e-3

REPO = pathlib.Path(__file__).resolve().parents[1]
TRUE_POSE = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
START_POSE = [0.5, -0.3, 1.2, 0.0, 0.0, 0.35]  # +0.2 m z, +0.05 rad yaw
MODEL_KW = dict(width=180, height=8, phi_min=-0.4, phi_max=0.3, range_max=30.0)


@pytest.fixture(scope="module")
def scenario():
    jb = build_bins(make_room_scene(n_pillars=4, seed=3), bin_size=32, bins_per_super=8)
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    tb = bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                          bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    jmodel, tmodel = JSpherical.create(**MODEL_KW), TSpherical.create(**MODEL_KW)
    hits = j_simulate(jb, jmodel, JTransform.from_pose_tuple(jnp.asarray(TRUE_POSE)))
    points, mask = np.array(hits.point), np.array(hits.hit)
    return jb, tb, jmodel, tmodel, points, mask


@pytest.fixture(scope="module")
def bvh_scenario(scenario):
    """The scenario's map as a BVH too (JAX slots carried across bit for bit)."""
    jbvh = build_bvh(make_room_scene(n_pillars=4, seed=3))
    tbvh = bvh_from_arrays({f: np.asarray(getattr(jbvh, f)) for f in
                            ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")},
                           device="cpu")
    return jbvh, tbvh


def _quat_close(jq, tq, tol=POSE_TOL):
    jq, tq = np.asarray(jq), tq.numpy()
    tq = tq * np.sign(np.dot(jq, tq))  # q and -q are one rotation
    np.testing.assert_allclose(tq, jq, atol=tol, rtol=0)


@pytest.mark.parametrize("solver", ["p2l_gn", "umeyama"])
def test_correct_once_matches_jax(scenario, solver):
    jb, tb, jmodel, tmodel, points, mask = scenario
    n = points.shape[0]
    j_sensor = jp.MICPSensorData(
        model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
        tsb=JTransform.identity(), config=jp.MICPSensorConfig.create(max_dist=2.0))
    t_sensor = tp.MICPSensorData(
        model=tmodel, points=torch.from_numpy(points), mask=torch.from_numpy(mask),
        tsb=TTransform.identity(device="cpu"),
        config=tp.MICPSensorConfig.create(max_dist=2.0))
    j_cfg, t_cfg = jp.MICPConfig(solver=solver), tp.MICPConfig(solver=solver)
    j_tom = JTransform.from_pose_tuple(jnp.asarray(START_POSE))
    t_tom = TTransform.from_pose_tuple(START_POSE, device="cpu")
    j_tbo, t_tbo = JTransform.identity(), TTransform.identity(device="cpu")
    j_prog, t_prog = jnp.float32(0.0), torch.tensor(0.0)
    for _ in range(5):
        j_tom, j_st = jp.correct_once(jb, [j_sensor], j_tom, j_tbo, j_prog, j_cfg)
        t_tom, t_st = tp.correct_once(tb, [t_sensor], t_tom, t_tbo, t_prog, t_cfg)
        np.testing.assert_allclose(t_tom.trans.numpy(), np.asarray(j_tom.trans),
                                   atol=POSE_TOL, rtol=0)
        _quat_close(j_tom.rot, t_tom.rot)
        assert abs(float(t_st.valid_matches) - float(j_st.valid_matches)) <= MATCH_FRAC_TOL * n
        assert abs(float(t_st.convergence_progress)
                   - float(j_st.convergence_progress)) <= PROGRESS_TOL
        assert float(t_st.total_measurements) == float(j_st.total_measurements)
        assert float(t_st.valid_measurements) == float(j_st.valid_measurements)
        j_prog, t_prog = j_st.convergence_progress, t_st.convergence_progress
    if solver == "p2l_gn":  # and both really converged back to the true pose
        np.testing.assert_allclose(t_tom.trans.numpy(), TRUE_POSE[:3], atol=0.01)


def test_correspondences_and_guards(scenario):
    _, tb, _, tmodel, points, mask = scenario
    tsm = TTransform.from_pose_tuple(TRUE_POSE, device="cpu")
    corr = find_rcc(tb, tmodel, tsm)
    # at the true pose the simulated model IS the dataset
    assert torch.equal(corr.found, torch.from_numpy(mask))
    np.testing.assert_allclose(corr.model_points.numpy()[mask], points[mask], atol=1e-4)
    # closest-point correspondences at the true pose: every measured point
    # lies on the mesh, so its closest point is itself
    cp = tp.find_correspondences(tb, [tp.MICPSensorData(
        model=tmodel, points=torch.from_numpy(points), mask=torch.from_numpy(mask),
        tsb=TTransform.identity(device="cpu"),
        config=tp.MICPSensorConfig.create(corr_type="CP"))], tsm)[0]
    assert torch.equal(cp.found, torch.from_numpy(mask))
    np.testing.assert_allclose(cp.model_points.numpy()[mask], points[mask], atol=1e-4)
    # NaN guard: a non-finite update keeps the old pose
    bad = tp.MICPSensorData(
        model=tmodel, points=torch.full_like(torch.from_numpy(points), float("nan")),
        mask=torch.from_numpy(mask), tsb=TTransform.identity(device="cpu"),
        config=tp.MICPSensorConfig.create(max_dist=2.0))
    tom, _ = tp.correct_from_correspondences([bad], [corr], tsm,
                                             TTransform.identity(device="cpu"), 0.0)
    assert torch.equal(tom.trans, tsm.trans) and torch.equal(tom.rot, tsm.rot)
    # disable_correction leaves the pose where it was
    sensor = tp.MICPSensorData(tmodel, torch.from_numpy(points), torch.from_numpy(mask),
                               TTransform.identity(device="cpu"), tp.MICPSensorConfig.create())
    tom, _ = tp.correct_once(tb, [sensor], tsm, TTransform.identity(device="cpu"), 0.0,
                             tp.MICPConfig(disable_correction=True))
    torch.testing.assert_close(tom.trans, tsm.trans)


@pytest.mark.parametrize("engine", ["bins", "bvh"])
def test_find_cpc_matches_jax(scenario, bvh_scenario, engine):
    """Closest-point correspondences from a pose 0.2 m off, gated at
    max_dist: the same found set except where a distance sits at the gate,
    model points and normals (oriented toward the query) where the
    supporting triangle is the same."""
    jb, tb, _, _, points, mask = scenario
    jmap, tmap = (jb, tb) if engine == "bins" else bvh_scenario
    mask = mask.copy()
    mask[::7] = False  # masked points are never found
    j = jc.find_cpc(jmap, jnp.asarray(points), jnp.asarray(mask),
                    JTransform.from_pose_tuple(jnp.asarray(START_POSE)), 0.5)
    t = find_cpc(tmap, torch.from_numpy(points), torch.from_numpy(mask),
                 TTransform.from_pose_tuple(START_POSE, device="cpu"), 0.5)
    jf, tf = np.asarray(j.found), t.found.numpy()
    assert not tf[::7].any()
    assert (jf != tf).mean() < MATCH_FRAC_TOL and 0.2 < tf.mean() < 0.99
    both = jf & tf
    np.testing.assert_allclose(t.model_points.numpy()[both], np.asarray(j.model_points)[both],
                               atol=1e-4)
    dot = np.sum(t.model_normals.numpy()[both] * np.asarray(j.model_normals)[both], axis=-1)
    assert (dot > 0.999).mean() > 0.99  # the same plane, oriented the same way
    assert (t.model_points.numpy()[~tf] == 0).all()


@pytest.mark.parametrize("engine,corr_type", [("bvh", "RC"), ("bvh", "CP"), ("bins", "CP")])
def test_correct_once_cp_and_bvh_match_jax(scenario, bvh_scenario, engine, corr_type):
    """Five corrections from +0.2 m z / 0.05 rad yaw with closest-point
    correspondences (on the bins or the BVH) and with ray-cast ones on the
    BVH: the poses agree after every call, and both converge."""
    jb, tb, jmodel, tmodel, points, mask = scenario
    jmap, tmap = (jb, tb) if engine == "bins" else bvh_scenario
    j_sensor = jp.MICPSensorData(
        model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
        tsb=JTransform.identity(),
        config=jp.MICPSensorConfig.create(max_dist=0.5, corr_type=corr_type))
    t_sensor = tp.MICPSensorData(
        model=tmodel, points=torch.from_numpy(points), mask=torch.from_numpy(mask),
        tsb=TTransform.identity(device="cpu"),
        config=tp.MICPSensorConfig.create(max_dist=0.5, corr_type=corr_type))
    j_tom = JTransform.from_pose_tuple(jnp.asarray(START_POSE))
    t_tom = TTransform.from_pose_tuple(START_POSE, device="cpu")
    j_tbo, t_tbo = JTransform.identity(), TTransform.identity(device="cpu")
    j_prog, t_prog = jnp.float32(0.0), torch.tensor(0.0)
    n = points.shape[0]
    pose_tol, progress_tol = ((CP_POSE_TOL, CP_PROGRESS_TOL) if corr_type == "CP"
                              else (POSE_TOL, PROGRESS_TOL))
    for _ in range(5):
        j_tom, j_st = jp.correct_once(jmap, [j_sensor], j_tom, j_tbo, j_prog, jp.MICPConfig())
        t_tom, t_st = tp.correct_once(tmap, [t_sensor], t_tom, t_tbo, t_prog, tp.MICPConfig())
        np.testing.assert_allclose(t_tom.trans.numpy(), np.asarray(j_tom.trans),
                                   atol=pose_tol, rtol=0)
        _quat_close(j_tom.rot, t_tom.rot, pose_tol)
        assert abs(float(t_st.valid_matches) - float(j_st.valid_matches)) <= MATCH_FRAC_TOL * n
        assert abs(float(t_st.convergence_progress)
                   - float(j_st.convergence_progress)) <= progress_tol
        j_prog, t_prog = j_st.convergence_progress, t_st.convergence_progress
    err = np.linalg.norm(t_tom.trans.numpy() - np.float32(TRUE_POSE[:3]))
    assert err < 0.05


def test_transform_from_arrays():
    t = transform_from_arrays([1.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0], device="cpu")
    assert torch.equal(t.apply(torch.zeros(3)), torch.tensor([1.0, 2.0, 3.0]))


def _port_files():
    return sorted((REPO / "rmcl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "rmcl_tpu"), f"{path}: imports {name}"


@pytest.fixture(scope="module")
def building_bins():
    """A small building floor's bins with a mid and a hyper level (JAX's
    packing carried across), and a VLP-16-like scan from inside it."""
    from rmcl_tpu.geom.mesh import make_building_scene

    jb = build_bins(make_building_scene(rooms_x=2, rooms_y=2, subdiv=6, n_clutter=1, seed=1),
                    bin_size=16, bins_per_super=16, bins_per_mid=4, supers_per_hyper=4)
    arrays = {f: np.asarray(getattr(jb, f)) for f in ("tri", "bin_aabb", "super_aabb",
                                                      "aabb_min", "aabb_max", "mid_aabb",
                                                      "hyper_aabb")}
    tb = bins_from_arrays(arrays, bins_per_super=16, bins_per_mid=4, supers_per_hyper=4,
                          device="cpu")
    kw = dict(width=360, height=16, range_max=40.0)
    jmodel, tmodel = JSpherical.create(**kw), TSpherical.create(**kw)
    hits = j_simulate(jb, jmodel, JTransform.from_pose_tuple(
        jnp.asarray([3.0, 3.0, 1.2, 0.0, 0.0, 0.3])), c_super=jb.n_super,
        c_bin=jb.n_super * jb.bins_per_super)
    return jb, tb, jmodel, tmodel, np.array(hits.point), np.array(hits.hit)


@pytest.mark.parametrize("c_mid,c_hyper", [(8, 0), (8, 4), (0, 4)])
def test_correct_once_mid_and_hyper_levels_match_jax(building_bins, c_mid, c_hyper):
    """MICPConfig's c_mid and c_hyper reach the binned cast in both
    packages: five corrections from +0.2 m z / 0.05 rad yaw agree after
    every call at POSE_TOL."""
    from rmcl_tpu_torch.ops.raycast_binned import _resolve_budgets

    jb, tb, jmodel, tmodel, points, mask = building_bins
    assert (_resolve_budgets(tb, 24, 96, c_mid)[2] > 0) == (c_mid > 0)  # the mid level runs
    j_sensor = jp.MICPSensorData(
        model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
        tsb=JTransform.identity(), config=jp.MICPSensorConfig.create(max_dist=0.5))
    t_sensor = tp.MICPSensorData(
        model=tmodel, points=torch.from_numpy(points), mask=torch.from_numpy(mask),
        tsb=TTransform.identity(device="cpu"), config=tp.MICPSensorConfig.create(max_dist=0.5))
    start = [3.0, 3.0, 1.4, 0.0, 0.0, 0.35]
    j_tom = JTransform.from_pose_tuple(jnp.asarray(start))
    t_tom = TTransform.from_pose_tuple(start, device="cpu")
    j_cfg = jp.MICPConfig(c_mid=c_mid, c_hyper=c_hyper)
    t_cfg = tp.MICPConfig(c_mid=c_mid, c_hyper=c_hyper)
    j_prog, t_prog = jnp.float32(0.0), torch.tensor(0.0)
    for _ in range(5):
        j_tom, j_st = jp.correct_once(jb, [j_sensor], j_tom, JTransform.identity(), j_prog, j_cfg)
        t_tom, t_st = tp.correct_once(tb, [t_sensor], t_tom, TTransform.identity(device="cpu"),
                                      t_prog, t_cfg)
        np.testing.assert_allclose(t_tom.trans.numpy(), np.asarray(j_tom.trans), atol=POSE_TOL,
                                   rtol=0)
        _quat_close(j_tom.rot, t_tom.rot)
        assert abs(float(t_st.valid_matches) - float(j_st.valid_matches)) <= (
            MATCH_FRAC_TOL * points.shape[0])
        j_prog, t_prog = j_st.convergence_progress, t_st.convergence_progress
