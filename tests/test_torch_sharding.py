"""The port's sharded MICP-L and MCL paths (``rmcl_tpu_torch.parallel``)
against the JAX package's, on 4 ranks.

The JAX side runs its sharded functions on ``make_mesh(4)`` of the 8-device
CPU mesh; the port's side runs the same inputs on 4 spawned ranks of a gloo
group (``parallel.mesh.launch``), each holding its shard, and the test
assembles the shards. Every case's inputs are made once from numpy seeds
(maps and scans by the JAX package, carried across as arrays) and each
file's cases run in two launches (MICP-L with the backward, MCL), so the
groups start twice. The sizes and tolerances are those of
``tests/test_sharding.py``; its HLO collective pins are held through the
port's per-kind collective counts. Randomness: where JAX's result follows
from its per-shard keys, the port's pure steps take JAX's draws; the
mixing and convergence cases are statistical, on the port's own streams,
as JAX's are on its keys."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.bvh.builder import build_bvh
from rmcl_tpu.geom.mesh import make_room_scene, make_sphere
from rmcl_tpu.math.gaussian import Gaussian1D as JG
from rmcl_tpu.math.se3 import Transform as JT
from rmcl_tpu.math.stats import sample_pose_uniform
from rmcl_tpu.mcl import sensor_update as jsu
from rmcl_tpu.mcl.particles import ParticleCloud as JPC
from rmcl_tpu.mcl.resampling import ResamplerConfig as JRC
from rmcl_tpu.micp import pipeline as jp
from rmcl_tpu.ops.diff import cast_rays_diff as j_cast_rays_diff
from rmcl_tpu.ops.raycast import cast_rays as j_cast_rays
from rmcl_tpu.parallel import diff_sharded as jds
from rmcl_tpu.parallel import sharded as jsh
from rmcl_tpu.parallel.mesh import make_mesh, put_replicated, put_sharded, shard_rays
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu_torch.convert import bins_from_arrays, bvh_from_arrays, particles_from_arrays
from rmcl_tpu_torch.math.se3 import Transform as TT
from rmcl_tpu_torch.mcl import resampling as trs
from rmcl_tpu_torch.mcl import sensor_update as tsu
from rmcl_tpu_torch.mcl.stats import estimate_stats
from rmcl_tpu_torch.micp import pipeline as tp
from rmcl_tpu_torch.parallel import programs as pg
from rmcl_tpu_torch.parallel.mesh import launch
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical

torch.set_num_threads(2)

N = 4  # ranks, and the JAX mesh's devices
RAYS = ((N,), ("rays",))
TIMEOUT = 240.0  # s: a hung rank fails its launch, not the suite


# -- carrying JAX inputs across (port objects with numpy leaves) --


def _bvh(jbvh):
    return pg.to_host(bvh_from_arrays({k: np.asarray(getattr(jbvh, k)) for k in (
        "nodes", "root_link", "aabb_min", "aabb_max", "n_tris")}, device="cpu"))


def _bins(jb):
    return pg.to_host(bins_from_arrays(
        {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
         for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb",
                   "hyper_aabb")},
        bins_per_super=jb.bins_per_super, bins_per_mid=jb.bins_per_mid,
        supers_per_hyper=jb.supers_per_hyper, device="cpu"))


def _tf(jt):
    return TT(rot=np.asarray(jt.rot, np.float32), trans=np.asarray(jt.trans, np.float32))


def _cloud(jc):
    return pg.to_host(particles_from_arrays(dict(
        rot=np.asarray(jc.poses.rot), trans=np.asarray(jc.poses.trans),
        mean=np.asarray(jc.likelihood.mean), sigma=np.asarray(jc.likelihood.sigma),
        n_meas=np.asarray(jc.likelihood.n_meas), state_sigma=np.asarray(jc.state_sigma),
        alive=np.asarray(jc.alive)), device="cpu"))


def _sensor(model_kw, points, mask, tsb_pose=None, **cfg):
    """The same sensor in both packages: (JAX's, the port's)."""
    jtsb = JT.identity() if tsb_pose is None else JT.from_pose_tuple(jnp.asarray(tsb_pose))
    js = jp.MICPSensorData(model=JSpherical.create(**model_kw), points=points, mask=mask,
                           tsb=jtsb, config=jp.MICPSensorConfig.create(**cfg))
    ts = tp.MICPSensorData(model=TSpherical.create(**model_kw), points=np.asarray(points),
                           mask=np.asarray(mask), tsb=_tf(jtsb),
                           config=tp.MICPSensorConfig.create(**cfg))
    return js, ts


def _jax_sharded_correct(jaccel, sensors, tom, tbo, config, steps=1):
    mesh = make_mesh(N)
    sensors_s = jsh.shard_sensor_data(sensors, mesh)
    tom, tbo = put_replicated(tom, mesh), put_replicated(tbo, mesh)
    poses = []
    for _ in range(steps):
        tom, stats = jsh.sharded_correct_once(jaccel, sensors_s, tom, tbo, jnp.float32(0.0),
                                              mesh, config=config)
        poses.append(np.concatenate([np.asarray(tom.rot), np.asarray(tom.trans)]))
    return np.stack(poses), stats


# -- MICP-L cases (test_sharding.py:61, :202, :395, :446) and the backward (:478) --

CORR_MODEL = dict(width=256, height=8, phi_min=-0.3, phi_max=0.2, range_max=30.0)
CORR_TRUE = [0.4, -0.2, 1.0, 0, 0, 0.3]
CORR_OFFSET = [0.08, -0.05, 0.04, 0, 0, 0.04]
BINS_MODEL = dict(width=128, height=8, phi_min=-0.3, phi_max=0.2, range_max=30.0)
BINS_TRUE = [0.3, -0.2, 1.0, 0, 0, 0.2]
BUDGET_MODEL = dict(width=64, height=4, phi_min=-0.2, phi_max=0.2, range_max=30.0)


@functools.lru_cache(maxsize=None)
def micp_world():
    """JAX's inputs and the port's (numpy leaves), case by case."""
    w = {}
    jbvh = build_bvh(make_room_scene(n_pillars=3, seed=4))
    true = JT.from_pose_tuple(jnp.asarray(CORR_TRUE))
    hits = j_simulate(jbvh, JSpherical.create(**CORR_MODEL), true)
    rc = _sensor(CORR_MODEL, hits.point, hits.hit, max_dist=2.0, weight=1.0)
    cp = _sensor(CORR_MODEL, hits.point, hits.hit, tsb_pose=[0.05, 0.0, 0.1, 0, 0, 0],
                 max_dist=2.0, weight=0.5, corr_type="CP")
    tom = true @ JT.from_pose_tuple(jnp.asarray(CORR_OFFSET))
    base = dict(jaccel=jbvh, taccel=_bvh(jbvh), tom=tom, tbo=JT.identity(), steps=1)
    w["bvh"] = dict(base, sensors=[rc], config=(jp.MICPConfig(), tp.MICPConfig()))
    w["umeyama"] = dict(base, sensors=[rc], config=(jp.MICPConfig(solver="umeyama"),
                                                    tp.MICPConfig(solver="umeyama")))
    w["multisensor"] = dict(base, sensors=[rc, cp], config=(jp.MICPConfig(), tp.MICPConfig()))

    geo = make_room_scene(n_pillars=2, seed=4)
    jb = build_bins(geo, bin_size=32, bins_per_super=8)
    btrue = JT.from_pose_tuple(jnp.asarray(BINS_TRUE))
    bhits = j_simulate(build_bvh(geo), JSpherical.create(**BINS_MODEL), btrue)
    w["bins"] = dict(jaccel=jb, taccel=_bins(jb), steps=3, tbo=btrue,
                     sensors=[_sensor(BINS_MODEL, bhits.point, bhits.hit, max_dist=1.0)],
                     tom=JT.from_xyz_euler(jnp.asarray([0.05, -0.04, 0.03]), jnp.zeros(3)),
                     config=(jp.MICPConfig(), tp.MICPConfig()))

    gbvh = build_bvh(make_room_scene(n_pillars=2, seed=1))
    ghits = j_simulate(gbvh, JSpherical.create(**BUDGET_MODEL), JT.identity())
    for k in (5, 2):
        w[f"budget_k{k}"] = dict(
            jaccel=gbvh, taccel=_bvh(gbvh), tom=JT.identity(), tbo=JT.identity(), steps=1,
            sensors=[_sensor(BUDGET_MODEL, ghits.point, ghits.hit, max_dist=2.0)],
            config=(jp.MICPConfig(optimization_iterations=k),
                    tp.MICPConfig(optimization_iterations=k)))
    return w


@functools.lru_cache(maxsize=None)
def cast_world():
    """test_sharding.py:43's rays on a sphere's BVH."""
    rng = np.random.default_rng(42)
    jbvh = build_bvh(make_sphere(48, 48, radius=3.0))
    n = 4096
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return jbvh, o, d


@functools.lru_cache(maxsize=None)
def backward_world():
    """test_sharding.py:478's sphere, bins, poses and rays."""
    mesh_g = make_sphere(48, 48, radius=5.0)
    jb = build_bins(mesh_g, bin_size=64, bins_per_super=16)
    verts = np.asarray(mesh_g.vertices, np.float32)
    faces = np.asarray(mesh_g.faces, np.int32)
    rng = np.random.default_rng(0)
    n_poses, n_dirs = 4, 256
    trans = rng.uniform(-1, 1, (n_poses, 3)).astype(np.float32)
    d = rng.normal(size=(n_poses * n_dirs, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pose_id = np.repeat(np.arange(n_poses, dtype=np.int32), n_dirs)
    return jb, verts, faces, trans, d, pose_id


@pytest.fixture(scope="module")
def micp_runs():
    """One 4-rank launch: every MICP-L case, the cast and the backward."""
    jobs = []
    for name, c in micp_world().items():
        jobs.append((name, RAYS, pg.correct_job, dict(
            accel=c["taccel"], sensors=[s[1] for s in c["sensors"]], tom=_tf(c["tom"]),
            tbo=_tf(c["tbo"]), config=c["config"][1], steps=c["steps"])))
    jbvh, o, d = cast_world()
    jobs.append(("cast", RAYS, pg.cast_job, dict(bvh=_bvh(jbvh), orig=o, dirs=d)))
    jb, verts, faces, trans, dirs, pose_id = backward_world()
    for wrt in ("pose", "verts"):
        jobs.append((f"backward_{wrt}", RAYS, pg.backward_job, dict(
            bins=_bins(jb), verts=verts, faces=faces, trans=trans, dirs=dirs,
            pose_id=pose_id, wrt=wrt)))
    return launch(pg.run_jobs, N, "gloo", ("cpu", jobs), timeout=TIMEOUT)


def test_cast_rays_sharded_matches_single(micp_runs):
    jbvh, o, d = cast_world()
    ref = j_cast_rays(jbvh, jnp.asarray(o), jnp.asarray(d))
    t = pg.assemble([r["cast"] for r in micp_runs], "t")
    prim = pg.assemble([r["cast"] for r in micp_runs], "prim_id")
    np.testing.assert_allclose(t, np.asarray(ref.t), rtol=1e-5)
    np.testing.assert_array_equal(prim, np.asarray(ref.prim_id))


MATCH_RTOL = {"bvh": 1e-5, "umeyama": 1e-4, "multisensor": 1e-4, "bins": 1e-4}


@pytest.mark.parametrize("case", list(MATCH_RTOL))
def test_sharded_correct_once_matches_jax(micp_runs, case):
    """The port's sharded correction against JAX's sharded one on the same
    4-way split: poses within 1e-4 after every correction, the match count
    within 1e-4 relative; the same replicated result on every rank."""
    c = micp_world()[case]
    j_poses, j_stats = _jax_sharded_correct(c["jaccel"], [s[0] for s in c["sensors"]],
                                            c["tom"], c["tbo"], c["config"][0], c["steps"])
    for r in micp_runs:
        np.testing.assert_allclose(r[case]["poses"], j_poses, atol=1e-4)
        np.testing.assert_allclose(float(r[case]["valid_matches"]),
                                   float(j_stats.valid_matches), rtol=MATCH_RTOL[case])
        np.testing.assert_array_equal(r[case]["poses"], micp_runs[0][case]["poses"])
    assert float(micp_runs[0][case]["total"]) == float(j_stats.total_measurements)
    assert float(micp_runs[0][case]["valid"]) == float(j_stats.valid_measurements)


def test_sharded_correct_once_binned_converges(micp_runs):
    """test_sharding.py:202: three sharded corrections on the bins bring the
    pose within 1e-3 m of the truth."""
    c = micp_world()["bins"]
    tom = micp_runs[0]["bins"]["poses"][-1]
    tom = TT(rot=torch.from_numpy(tom[:4]), trans=torch.from_numpy(tom[4:]))
    tbo = TT(rot=torch.tensor(np.asarray(c["tbo"].rot)),
             trans=torch.tensor(np.asarray(c["tbo"].trans)))
    err = float(torch.linalg.vector_norm((tom @ tbo).trans - tbo.trans))
    assert err < 1e-3, err


@pytest.mark.parametrize("k", [5, 2])
def test_sharded_correct_once_collective_budget(micp_runs, k):
    """K + 1 all-reduces a correction and nothing else (test_sharding.py:446)."""
    for r in micp_runs:
        assert r[f"budget_k{k}"]["counts"] == [
            {"all_reduce": k + 1, "all_gather": 0, "permute": 0}]
    for case in ("bvh", "umeyama", "multisensor"):
        assert micp_runs[0][case]["counts"] == [
            {"all_reduce": 6, "all_gather": 0, "permute": 0}]


@pytest.mark.parametrize("wrt", ["pose", "verts"])
def test_sharded_backward_matches_single_and_collective_budget(micp_runs, wrt):
    """test_sharding.py:478: the loss within 1e-5 relative and the gradient
    within rtol 2e-4, atol 1e-5 of JAX's unsharded program, the same on every
    rank, from one all-reduce an evaluation."""
    jb, verts, faces, trans, dirs, pose_id = backward_world()
    argnum = 0 if wrt == "pose" else 1

    def loss_ref(trans, verts):
        o = jnp.take(trans, pose_id, axis=0)
        h = j_cast_rays_diff(jb, verts, jnp.asarray(faces), o, jnp.asarray(dirs))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    l_ref, g_ref = jax.value_and_grad(loss_ref, argnums=argnum)(jnp.asarray(trans),
                                                                jnp.asarray(verts))
    mesh = make_mesh(N)
    l_js, g_js = jds.sharded_range_value_and_grad(
        jb, jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(trans),
        jax.device_put(jnp.asarray(dirs), shard_rays(mesh)),
        jax.device_put(jnp.asarray(pose_id), shard_rays(mesh)), mesh, wrt=wrt)
    for r in micp_runs:
        out = r[f"backward_{wrt}"]
        np.testing.assert_allclose(float(out["loss"]), float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(out["grad"], np.asarray(g_ref), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(out["grad"], np.asarray(g_js), rtol=2e-4, atol=1e-5)
        assert out["counts"] == {"all_reduce": 1, "all_gather": 0, "permute": 0}


# -- MCL cases (test_sharding.py:92, :161, :148, :118, :290, :355, :237, :528) --

GLAD_CFG = dict(min_noise_t=(0.001, 0.001, 0.001), min_noise_r=(1e-4, 1e-4, 1e-4))
MIX_TICKS = 14


def _strong_cloud(n, rng):
    """test_sharding.py:118's cloud: one strong hypothesis at slot 3."""
    w = np.full(n, 0.01, np.float32)
    w[3] = 10.0
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    jc = JPC.create(n).with_poses(JT.from_xyz_euler(jnp.asarray(trans), jnp.zeros((n, 3))))
    jc = dataclasses.replace(jc, likelihood=JG(mean=jnp.asarray(w), sigma=jnp.zeros(n),
                                               n_meas=jnp.full(n, 10.0)))
    return jc, float(trans[3, 0])


@functools.lru_cache(maxsize=None)
def mcl_world():
    w = {}
    key = jax.random.PRNGKey(0)
    # :92, the sensor update on the BVH
    jbvh = build_bvh(make_room_scene(n_pillars=2, seed=9))
    model = JSpherical.create(width=128, height=4, phi_min=-0.2, phi_max=0.2, range_max=30.0)
    hits = j_simulate(jbvh, model, JT.from_pose_tuple(jnp.asarray([0.0, 0.0, 1.0, 0, 0, 0])))
    rng = np.random.default_rng(0)
    n = 1024
    trans = rng.uniform([-3, -2, 0.8], [3, 2, 1.2], (n, 3)).astype(np.float32)
    jc = JPC.create(n).with_poses(JT.from_xyz_euler(jnp.asarray(trans), jnp.zeros((n, 3))))
    w["su_bvh"] = dict(jaccel=jbvh, taccel=_bvh(jbvh), cloud=jc, points=hits.point,
                       mask=hits.hit, cfg=dict(samples=32, dist_sigma=0.5), rtol=2e-4)
    # :161, the sensor update on the bins
    geo = make_room_scene(n_pillars=2, seed=4)
    jb = build_bins(geo, bin_size=32, bins_per_super=8)
    model = JSpherical.create(width=90, height=4, phi_min=-0.3, phi_max=0.2, range_max=30.0)
    hits = j_simulate(build_bvh(geo), model,
                      JT.from_pose_tuple(jnp.asarray([0.3, -0.2, 1.0, 0, 0, 0.2])))
    n = 64 * 8
    rng = np.random.default_rng(2)
    trans = rng.uniform([-4, -3, 0.5], [4, 3, 1.5], (n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    poses = JT.from_xyz_euler(jnp.asarray(trans), jnp.stack(
        [jnp.zeros(n), jnp.zeros(n), jnp.asarray(yaw)], -1))
    w["su_binned"] = dict(jaccel=jb, taccel=_bins(jb), cloud=JPC.create(n).with_poses(poses),
                          points=hits.point, mask=hits.hit, rtol=1e-4,
                          cfg=dict(samples=16, engine="binned", c_super=48, c_bin=256))
    for case in ("su_bvh", "su_binned"):
        c = w[case]
        c["beams"] = jsu.sample_beams(key, c["points"], c["mask"], c["cfg"]["samples"])
    # :148, the likelihood statistics
    rng = np.random.default_rng(42)
    wts = rng.random(512).astype(np.float32)
    jc = JPC.create(512)
    w["stats"] = dataclasses.replace(jc, likelihood=JG(
        mean=jnp.asarray(wts), sigma=jnp.zeros(512), n_meas=jnp.ones(512)))
    # one tournament and one residual pass on JAX's per-shard draws: random
    # likelihoods, every 11th particle dead
    rng = np.random.default_rng(7)
    n = 1024
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    jc = JPC.create(n).with_poses(JT.from_xyz_euler(
        jnp.asarray(trans), jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)))
    alive = np.ones(n, bool)
    alive[::11] = False
    wts = rng.random(n).astype(np.float32)
    wts[: n // N] *= 10.0  # shard 0 holds ~10x the mass (test_sharding.py:355)
    w["draws_cloud"] = dataclasses.replace(jc, alive=jnp.asarray(alive), likelihood=JG(
        mean=jnp.asarray(wts), sigma=jnp.asarray(rng.uniform(0, 0.1, n), jnp.float32),
        n_meas=jnp.asarray(rng.uniform(1, 50, n), jnp.float32)))
    # :118 and :290's strong-hypothesis clouds
    w["mix"] = _strong_cloud(2048, np.random.default_rng(42))
    w["doubling"] = _strong_cloud(1024, np.random.default_rng(43))
    # :237, the full loop
    world = make_room_scene(n_pillars=4, seed=1)
    lbvh = build_bvh(world)
    ltrue = JT.from_pose_tuple(jnp.asarray([1.2, -0.8, 1.0, 0.0, 0.0, 0.7]))
    scan = j_simulate(lbvh, JSpherical.create(width=180, height=8, range_max=25.0), ltrue)
    lposes = sample_pose_uniform(jax.random.PRNGKey(1),
                                 jnp.asarray([-5, -4, 0.5, 0, 0, -np.pi], jnp.float32),
                                 jnp.asarray([5, 4, 1.5, 0, 0, np.pi], jnp.float32), 2048)
    w["loop"] = dict(bvh=_bvh(lbvh), cloud=JPC.create(2048).with_poses(lposes),
                     points=np.asarray(scan.point), mask=np.asarray(scan.hit),
                     truth=np.asarray(ltrue.trans))
    return w


def _gladiator_draws(key, n_local, pool_n):
    """JAX's draws on each shard: the key folded with the shard index, split
    in three (enemy, noise, unused)."""
    out = []
    for s in range(N):
        k_enemy, k_noise, _ = jax.random.split(jax.random.fold_in(key, s), 3)
        out.append((np.asarray(jax.random.randint(k_enemy, (n_local,), 0, pool_n)),
                    np.asarray(jax.random.normal(k_noise, (n_local, 6)))))
    return out


def _residual_draws(key, n_local):
    out = []
    for s in range(N):
        k_resid, k_noise = jax.random.split(jax.random.fold_in(key, s))
        out.append((np.asarray(jax.random.uniform(k_resid)),
                    np.asarray(jax.random.normal(k_noise, (n_local, 6)))))
    return out


GLAD_SHIFTS = [(1,), (1, 2)]
RESID_TARGETS = [400, 1024]


@pytest.fixture(scope="module")
def mcl_runs():
    """One 4-rank launch: every MCL case."""
    w = mcl_world()
    jobs = []
    for case in ("su_bvh", "su_binned"):
        c = w[case]
        jobs.append((case, RAYS, pg.sensor_update_job, dict(
            accel=c["taccel"], cloud=_cloud(c["cloud"]),
            beams=tuple(np.asarray(x) for x in c["beams"]), tsb=_tf(JT.identity()),
            config=tsu.SensorUpdateConfig.create(**c["cfg"]))))
    jobs.append(("stats", RAYS, pg.stats_job, dict(cloud=_cloud(w["stats"]))))
    tcfg = trs.ResamplerConfig.create(**GLAD_CFG)
    n_local = 1024 // N
    for shifts in GLAD_SHIFTS:
        draws = _gladiator_draws(jax.random.PRNGKey(5), n_local, (1 + len(shifts)) * n_local)
        jobs.append((f"glad_{shifts}", RAYS, pg.gladiator_draws_job, dict(
            cloud=_cloud(w["draws_cloud"]), draws=draws, config=tcfg, shifts=shifts)))
    for n_target in RESID_TARGETS:
        jobs.append((f"resid_{n_target}", RAYS, pg.residual_draws_job, dict(
            cloud=_cloud(w["draws_cloud"]), draws=_residual_draws(jax.random.PRNGKey(6), n_local),
            config=trs.ResamplerConfig.create(), n_target=n_target)))
    for case, doubling, ticks in (("mix", False, 16), ("doubling", True, MIX_TICKS)):
        jc, x = w[case]
        jobs.append((case, RAYS, pg.gladiator_mixing_job, dict(
            cloud=_cloud(jc), config=tcfg, ticks=ticks, seed=11, target_x=x,
            doubling=doubling)))
    lp = w["loop"]
    jobs.append(("loop", RAYS, pg.mcl_loop_job, dict(
        bvh=lp["bvh"], cloud=_cloud(lp["cloud"]), points=lp["points"], mask=lp["mask"],
        steps=30, seed=3)))
    return launch(pg.run_jobs, N, "gloo", ("cpu", jobs), timeout=TIMEOUT)


@pytest.mark.parametrize("case", ["su_bvh", "su_binned"])
def test_sharded_sensor_update_matches_jax(mcl_runs, case):
    """test_sharding.py:92 (BVH) and :161 (bins): each rank's likelihoods
    against JAX's sharded update of the same particles and beams; no
    collective."""
    c = mcl_world()[case]
    mesh = make_mesh(N)
    out = jax.jit(lambda acc, cl, k, pts, msk, tsb: jsh.sharded_sensor_update(
        acc, cl, k, pts, msk, tsb, jsu.SensorUpdateConfig.create(**c["cfg"]), mesh))(
        c["jaccel"], put_sharded(c["cloud"], mesh), jax.random.PRNGKey(0), c["points"],
        c["mask"], JT.identity())
    np.testing.assert_allclose(pg.assemble([r[case] for r in mcl_runs], "mean"),
                               np.asarray(out.likelihood.mean), rtol=c["rtol"], atol=1e-6)
    for r in mcl_runs:
        assert r[case]["counts"] == {"all_reduce": 0, "all_gather": 0, "permute": 0}


def test_psum_likelihood_stats(mcl_runs):
    jc = mcl_world()["stats"]
    w = np.asarray(jc.likelihood.mean)
    for r in mcl_runs:
        np.testing.assert_allclose(float(r["stats"]["sum"]), w.sum(), rtol=1e-5)
        np.testing.assert_allclose(float(r["stats"]["max"]), w.max(), rtol=1e-6)
        assert r["stats"]["counts"] == {"all_reduce": 2, "all_gather": 0, "permute": 0}


def _close_clouds(runs, name, jc, tol=1e-5):
    for f, j in (("rot", jc.poses.rot), ("trans", jc.poses.trans),
                 ("mean", jc.likelihood.mean), ("sigma", jc.likelihood.sigma),
                 ("n_meas", jc.likelihood.n_meas), ("state_sigma", jc.state_sigma)):
        np.testing.assert_allclose(pg.assemble([r[name] for r in runs], f"cloud.{f}"),
                                   np.asarray(j), rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_array_equal(pg.assemble([r[name] for r in runs], "cloud.alive"),
                                  np.asarray(jc.alive))


@pytest.mark.parametrize("shifts", GLAD_SHIFTS)
def test_sharded_gladiator_matches_jax_on_its_draws(mcl_runs, shifts):
    """One sharded tournament with a ring exchange, on JAX's per-shard
    draws: the port's clouds are JAX's; one packed permute a shift and no
    other collective (test_sharding.py:528)."""
    mesh = make_mesh(N)
    jo = jax.jit(lambda c, k: jsh.sharded_gladiator_resample(
        c, k, JRC.create(**GLAD_CFG), mesh, shifts=shifts))(
        put_sharded(mcl_world()["draws_cloud"], mesh), jax.random.PRNGKey(5))
    _close_clouds(mcl_runs, f"glad_{shifts}", jo)
    for r in mcl_runs:
        assert r[f"glad_{shifts}"]["counts"] == {"all_reduce": 0, "all_gather": 0,
                                                 "permute": len(shifts)}


@pytest.mark.parametrize("n_target", RESID_TARGETS)
def test_sharded_dynamic_residual_matches_jax_on_its_draws(mcl_runs, n_target):
    """test_sharding.py:355 on JAX's per-shard draws: the port's clouds are
    JAX's, the live counts sum to n_target as compacted prefixes, the heavy
    shard is capped at its capacity, growing to capacity fills every slot;
    one all-gather and no other collective (:528)."""
    name = f"resid_{n_target}"
    mesh = make_mesh(N)
    jo = jax.jit(lambda c, k: jsh.sharded_residual_resample_dynamic(
        c, k, JRC.create(), n_target, mesh))(
        put_sharded(mcl_world()["draws_cloud"], mesh), jax.random.PRNGKey(6))
    _close_clouds(mcl_runs, name, jo)
    alive = pg.assemble([r[name] for r in mcl_runs], "cloud.alive").reshape(N, -1)
    counts = alive.sum(axis=1)
    assert counts.sum() == n_target
    for s in range(N):
        assert alive[s, : counts[s]].all() and not alive[s, counts[s]:].any()
    assert counts[0] == alive.shape[1]
    for r in mcl_runs:
        assert r[name]["counts"] == {"all_reduce": 0, "all_gather": 1, "permute": 0}


def test_sharded_gladiator_mixes_across_shards(mcl_runs):
    """test_sharding.py:118 on the port's own streams: after 16 ring rounds
    the strong hypothesis holds most of the cloud and has reached the other
    shards."""
    _, x_target = mcl_world()["mix"]
    x = pg.assemble([r["mix"] for r in mcl_runs], "x")
    assert (np.abs(x - x_target) < 0.1).mean() > 0.5
    assert (np.abs(x[x.shape[0] // 2:] - x_target) < 0.1).mean() > 0.2


def test_gladiator_mixing_time_doubling_schedule(mcl_runs):
    """test_sharding.py:290 on the port's own streams: ticks until the
    strong hypothesis holds over half of every shard, the global tournament
    against the sharded one under the doubling schedule, within 1.5x plus
    the log2(shards) ring latency."""
    jc, x_target = mcl_world()["doubling"]
    gen = torch.Generator().manual_seed(11)
    cloud = pg.to_device(_cloud(jc), "cpu")
    cfg = trs.ResamplerConfig.create(**GLAD_CFG)
    t_global = MIX_TICKS + 1
    for t in range(MIX_TICKS):
        cloud = trs.gladiator_resample(cloud, gen, cfg)
        x = cloud.poses.trans[:, 0].numpy().reshape(N, -1)
        if (np.abs(x - x_target) < 0.1).mean(axis=1).min() > 0.5:
            t_global = t + 1
            break
    near = np.stack([r["doubling"]["near"] for r in mcl_runs])  # (ranks, ticks)
    dominated = np.nonzero(near.min(axis=0) > 0.5)[0]
    t_sharded = int(dominated[0]) + 1 if dominated.size else MIX_TICKS + 1
    assert t_global <= MIX_TICKS
    assert t_sharded <= np.ceil(1.5 * t_global) + np.log2(N), (t_global, t_sharded)


def test_sharded_mcl_full_loop_converges(mcl_runs):
    """test_sharding.py:237: thirty steps of motion, sharded sensor update
    and sharded tournament from a uniform cloud end within 0.15 m of the
    truth; every rank keeps its own quarter of the cloud."""
    lp = mcl_world()["loop"]
    arrays = {k: pg.assemble([r["loop"] for r in mcl_runs], f"cloud.{k}")
              for k in ("rot", "trans", "mean", "sigma", "n_meas", "state_sigma", "alive")}
    assert all(r["loop"]["cloud"]["alive"].shape == (2048 // N,) for r in mcl_runs)
    est = estimate_stats(particles_from_arrays(arrays, device="cpu"))
    err = float(np.linalg.norm(est.pose.trans.numpy() - lp["truth"]))
    assert err < 0.15, err
