"""The port's MCL stages against the JAX package's: the motion update (the
collision kill included), the sensor update engine by engine and layout by
layout on one injected beam set and one cloud, the resamplers on the JAX
functions' own draws, the effective sample size, the live-count policy and
the particle statistics.

Both packages take the same inputs: the map carried across as arrays, the
cloud through ``particles_from_arrays``, JAX's draws regenerated from the
key exactly as the JAX function draws them (torch cannot reproduce
``jax.random`` streams)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.bvh.builder import build_bvh
from rmcl_tpu.geom.mesh import make_room_scene
from rmcl_tpu.math.gaussian import Gaussian1D as JG
from rmcl_tpu.math.se3 import Transform as JT
from rmcl_tpu.mcl import motion as jmo
from rmcl_tpu.mcl import resampling as jrs
from rmcl_tpu.mcl import sensor_update as jsu
from rmcl_tpu.mcl import stats as jms
from rmcl_tpu.mcl.particles import ParticleCloud as JPC
from rmcl_tpu.sensors.models import SphericalModel
from rmcl_tpu.sensors.simulate import simulate
from rmcl_tpu_torch.convert import bins_from_arrays, bvh_from_arrays, particles_from_arrays
from rmcl_tpu_torch.math.gaussian import MAX_N_MEAS
from rmcl_tpu_torch.math.se3 import Transform as TT
from rmcl_tpu_torch.mcl import motion as tmo
from rmcl_tpu_torch.mcl import resampling as trs
from rmcl_tpu_torch.mcl import sensor_update as tsu
from rmcl_tpu_torch.mcl import stats as tms
from rmcl_tpu_torch.mcl.particles import ParticleCloud as TPC

torch.set_num_threads(2)

# likelihoods: the rays' origins and directions come from the same float32
# pose arithmetic in both packages, and each engine's hit is the JAX
# engine's; the fold sums S evals in another order
LIK_RTOL = 1e-5
LIK_ATOL = 1e-6
# poses and elementwise updates: float32 arithmetic, transcendental
# functions a last bit apart
TOL = 1e-6
S = 24


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _world():
    """A room with pillars: JAX's BVH and bins (16-triangle bins, 32 a
    super, 8 a mid) and the port's copies; a scan at a known pose."""
    mesh = make_room_scene(n_pillars=3, seed=2)
    jbvh = build_bvh(mesh)
    jb = build_bins(mesh, bin_size=16, bins_per_super=32, bins_per_mid=8)
    tbvh = bvh_from_arrays({k: np.asarray(getattr(jbvh, k))
                            for k in ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")},
                           device="cpu")
    tb = bins_from_arrays({f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
                           for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                                     "mid_aabb", "hyper_aabb")},
                          bins_per_super=jb.bins_per_super, bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    model = SphericalModel.create(width=180, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    hits = simulate(jbvh, model, JT.from_pose_tuple(jnp.asarray([0.5, -0.5, 1.0, 0, 0, 0.4])))
    return jbvh, jb, tbvh, tb, hits.point, hits.hit


def _clouds(n=256, seed=5, spread=None):
    """One cloud in both packages: scattered over the room, or (spread in
    meters) around the scan's pose; random likelihoods and confidences."""
    rng = np.random.default_rng(seed)
    if spread is None:
        trans = rng.uniform([-4, -3, 0.5], [4, 3, 1.5], (n, 3)).astype(np.float32)
        yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    else:
        trans = (np.float32([0.5, -0.5, 1.0]) + spread * rng.normal(size=(n, 3))).astype(np.float32)
        yaw = (0.4 + 0.05 * rng.normal(size=n)).astype(np.float32)
    poses = JT.from_xyz_euler(jnp.asarray(trans),
                              jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.asarray(yaw)], -1))
    lik = JG(mean=jnp.asarray(rng.uniform(0.1, 1.0, n), jnp.float32),
             sigma=jnp.asarray(rng.uniform(0.0, 0.1, n), jnp.float32),
             n_meas=jnp.asarray(rng.uniform(0.0, 50.0, n), jnp.float32))
    jc = dataclasses.replace(JPC.create(n).with_poses(poses), likelihood=lik)
    return jc, _carry_cloud(jc)


def _carry_cloud(jc):
    return particles_from_arrays(dict(
        rot=np.asarray(jc.poses.rot), trans=np.asarray(jc.poses.trans),
        mean=np.asarray(jc.likelihood.mean), sigma=np.asarray(jc.likelihood.sigma),
        n_meas=np.asarray(jc.likelihood.n_meas), state_sigma=np.asarray(jc.state_sigma),
        alive=np.asarray(jc.alive)), device="cpu")


def _close_clouds(jc, tc, tol=TOL):
    for a, b in ((jc.poses.rot, tc.poses.rot), (jc.poses.trans, tc.poses.trans),
                 (jc.likelihood.mean, tc.likelihood.mean),
                 (jc.likelihood.sigma, tc.likelihood.sigma),
                 (jc.likelihood.n_meas, tc.likelihood.n_meas),
                 (jc.state_sigma, tc.state_sigma)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tc.alive.numpy(), np.asarray(jc.alive))


def _beams(key=3):
    *_, points, mask = _world()
    jb = jsu.sample_beams(jax.random.PRNGKey(key), points, mask, S)
    return jb, tuple(_t(x) for x in jb)


def _accels(engine):
    jbvh, jb, tbvh, tb, *_ = _world()
    return {"bvh": (jbvh, tbvh), "binned": (jb, tb), "seeded": ((jbvh, jb), (tbvh, tb))}[engine]


def _update(engine, jc, tc, beams=None, **kw):
    """One sensor update in both packages on the same injected beams."""
    *_, points, mask = _world()
    (jbeams, tbeams) = beams or _beams()
    j_acc, t_acc = _accels(engine)
    kw = dict(samples=S, engine=engine, dist_sigma=0.4, **kw)
    jo = jsu.sensor_update(j_acc, jc, jax.random.PRNGKey(0), points, mask, JT.identity(),
                           jsu.SensorUpdateConfig.create(**kw), beams=jbeams)
    to = tsu.sensor_update(t_acc, tc, None, None, None, TT.identity(device="cpu"),
                           tsu.SensorUpdateConfig.create(**kw), beams=tbeams)
    return jo, to


# --- motion update ---

def test_motion_update_matches_jax():
    jc, tc = _clouds()
    pose = [0.3, -0.1, 0.02, 0.01, -0.02, 0.2]
    jd = JT.from_pose_tuple(jnp.asarray(pose))
    td = TT.from_pose_tuple(pose, device="cpu")
    jo = jmo.motion_update(jc, jd, jnp.float32(0.25),
                           jmo.MotionUpdateConfig.create(forget_rate=0.4,
                                                         forget_rate_per_second=0.2))
    to = tmo.motion_update(tc, td, 0.25, tmo.MotionUpdateConfig.create(
        forget_rate=0.4, forget_rate_per_second=0.2))
    _close_clouds(jo, to)


def test_motion_update_collision_kill_matches_jax():
    """Steps of 3 m from scattered particles: the ones whose straight step
    crosses a wall or pillar die (mean 0, n_meas at the cap)."""
    jbvh, _, tbvh, *_ = _world()
    jc, tc = _clouds(n=300, seed=8)
    pose = [3.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    cfg = dict(check_collisions=True)
    jo = jmo.motion_update(jc, JT.from_pose_tuple(jnp.asarray(pose)), jnp.float32(1.0),
                           jmo.MotionUpdateConfig.create(**cfg), bvh=jbvh)
    to = tmo.motion_update(tc, TT.from_pose_tuple(pose, device="cpu"), 1.0,
                           tmo.MotionUpdateConfig.create(**cfg), bvh=tbvh)
    killed = to.likelihood.n_meas.numpy() == MAX_N_MEAS
    assert 0.05 < killed.mean() < 0.95  # some die, some pass
    assert (to.likelihood.mean.numpy()[killed] == 0).all()
    _close_clouds(jo, to)


# --- sensor update ---

@pytest.mark.parametrize("engine,kw", [
    ("bvh", {}),
    ("binned", dict(layout="particle")),
    ("binned", dict(layout="beam", c_super=64, c_bin=512)),
    ("binned", dict(layout="beam")),  # default budgets: some blocks truncate
    ("binned", dict(layout="particle", c_mid=48)),
    ("binned", dict(layout="beam", c_mid=8, c_super=64, c_bin=512)),
    ("seeded", {}),
    ("seeded", dict(c_super=4, c_bin=16)),  # most rays uncertified: refined by the walk
    ("bvh", dict(correspondence_type="CP")),
    ("binned", dict(correspondence_type="CP")),
    ("seeded", dict(correspondence_type="CP")),
    ("bvh", dict(range_cap_sigmas=0.0)),
])
def test_sensor_update_matches_jax(engine, kw):
    jc, tc = _clouds()
    jo, to = _update(engine, jc, tc, **kw)
    np.testing.assert_allclose(to.likelihood.mean.numpy(), np.asarray(jo.likelihood.mean),
                               rtol=LIK_RTOL, atol=LIK_ATOL)
    np.testing.assert_allclose(to.likelihood.sigma.numpy(), np.asarray(jo.likelihood.sigma),
                               rtol=LIK_RTOL, atol=LIK_ATOL)
    np.testing.assert_array_equal(to.likelihood.n_meas.numpy(), np.asarray(jo.likelihood.n_meas))
    assert torch.equal(to.poses.trans, tc.poses.trans)  # the update moves no particle


def test_sensor_update_n_meas_clamp():
    """A prior confidence near the cap: the merge clamps n_meas at
    MAX_N_MEAS, as the JAX package does."""
    jc, tc = _clouds(n=64)
    n_meas = np.linspace(MAX_N_MEAS - 40.0, MAX_N_MEAS, 64).astype(np.float32)
    jc = dataclasses.replace(jc, likelihood=dataclasses.replace(jc.likelihood,
                                                                n_meas=jnp.asarray(n_meas)))
    tc = _carry_cloud(jc)
    jo, to = _update("bvh", jc, tc)
    np.testing.assert_array_equal(to.likelihood.n_meas.numpy(), np.asarray(jo.likelihood.n_meas))
    assert float(to.likelihood.n_meas.max()) == MAX_N_MEAS
    np.testing.assert_allclose(to.likelihood.mean.numpy(), np.asarray(jo.likelihood.mean),
                               rtol=LIK_RTOL, atol=LIK_ATOL)


@pytest.mark.parametrize("engine,kw", [
    ("binned", dict(layout="beam", c_super=64, c_bin=512)),
    ("binned", dict(layout="particle")),
    ("seeded", {}),
])
def test_cluster_is_a_pure_reordering(engine, kw):
    """Clustering the particles changes the dense engine's blocks, not the
    result: the likelihoods with and without it agree."""
    _, tc = _clouds()
    *_, tbeams = _beams()
    _, t_acc = _accels(engine)
    run = lambda c: tsu.sensor_update(
        t_acc, tc, None, None, None, TT.identity(device="cpu"),
        tsu.SensorUpdateConfig.create(samples=S, engine=engine, dist_sigma=0.4, cluster=c, **kw),
        beams=tbeams).likelihood
    a, b = run(True), run(False)
    torch.testing.assert_close(a.mean, b.mean, rtol=LIK_RTOL, atol=LIK_ATOL)
    assert torch.equal(a.n_meas, b.n_meas)


def test_bvh_angular_schedule_is_bitwise_the_sampled_order(monkeypatch):
    """The exact engine casts the beams in angular order and folds them in
    the sampled order: the likelihoods are those of a cast in the sampled
    order, bit for bit."""
    _, tc = _clouds()
    *_, tbeams = _beams()
    _, tbvh = _accels("bvh")
    cfg = tsu.SensorUpdateConfig.create(samples=S, engine="bvh", dist_sigma=0.4)
    run = lambda: tsu.sensor_update(tbvh, tc, None, None, None, TT.identity(device="cpu"),
                                    cfg, beams=tbeams).likelihood
    angular = run()
    assert not torch.equal(tsu._angular_order(tbeams[0]), torch.arange(S))  # it reorders
    monkeypatch.setattr(tsu, "_angular_order", lambda d: torch.arange(d.shape[0]))
    sampled = run()
    for f in ("mean", "sigma", "n_meas"):
        assert torch.equal(getattr(angular, f), getattr(sampled, f))


def test_sample_beams_matches_jax_on_its_draws():
    """The pure step on JAX's categorical draw; the draw step picks valid
    points only and follows its generator."""
    *_, points, mask = _world()
    key = jax.random.PRNGKey(7)
    jd, jr, jv = jsu.sample_beams(key, points, mask, 64)
    n = points.shape[0]
    p = np.asarray(mask, np.float32)
    idx = jax.random.choice(key, n, (64,), replace=True, p=jnp.asarray(p / p.sum()))
    td, tr, tv = tsu.beams_from_indices(_t(points), _t(mask), _t(idx))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    gen = lambda: torch.Generator().manual_seed(2)
    a = tsu.sample_beams(gen(), _t(points), _t(mask), 500)
    b = tsu.sample_beams(gen(), _t(points), _t(mask), 500)
    assert bool(a[2].all()) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_generator_draw_equals_injected_beams():
    jc, tc = _clouds(n=64)
    *_, points, mask = _world()
    _, tbvh = _accels("bvh")
    cfg = tsu.SensorUpdateConfig.create(samples=S, engine="bvh", dist_sigma=0.4)
    tsb = TT.identity(device="cpu")
    drawn = tsu.sensor_update(tbvh, tc, torch.Generator().manual_seed(9), _t(points), _t(mask),
                              tsb, cfg)
    beams = tsu.sample_beams(torch.Generator().manual_seed(9), _t(points), _t(mask), S)
    injected = tsu.sensor_update(tbvh, tc, None, None, None, tsb, cfg, beams=beams)
    assert torch.equal(drawn.likelihood.mean, injected.likelihood.mean)


@pytest.mark.parametrize("layout", ["beam", "particle"])
def test_probe_update_rays_match_jax(layout):
    """The audit's rays: the update's block order and reach caps."""
    jc, tc = _clouds(spread=0.3)
    *_, points, mask = _world()
    key = jax.random.PRNGKey(5)
    cfg = dict(samples=S, engine="binned", dist_sigma=0.4, layout=layout)
    jo, jd, jt = jsu.probe_update_rays(jc, key, points, mask, JT.identity(),
                                       jsu.SensorUpdateConfig.create(**cfg))
    beams = tuple(_t(x) for x in jsu.sample_beams(key, points, mask, S))
    to, td, tt = tsu.probe_update_rays(tc, None, None, None, TT.identity(device="cpu"),
                                       tsu.SensorUpdateConfig.create(**cfg), beams=beams)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=TOL, atol=TOL)


# --- resampling, ESS, the live-count policy, statistics ---

def _resampler_draws(kind, key, n):
    """The JAX resampler's own draws, regenerated from its key."""
    k1, k2 = jax.random.split(key)
    normals = _t(jax.random.normal(k2, (n, 6)))
    if kind == "gladiator":
        return _t(jax.random.randint(k1, (n,), 0, n)).long(), normals
    return _t(jax.random.uniform(k1)), normals


@pytest.mark.parametrize("kind", ["gladiator", "residual", "systematic", "residual_dynamic"])
def test_resamplers_match_jax_on_their_draws(kind):
    jc, tc = _clouds(n=300, seed=3)
    alive = np.ones(300, bool)
    alive[::11] = False  # dead particles never win a duel and weigh zero
    jc = dataclasses.replace(jc, alive=jnp.asarray(alive))
    tc = _carry_cloud(jc)
    key = jax.random.PRNGKey(12)
    cfg = dict(min_noise_t=(0.05, 0.04, 0.01), min_noise_r=(0.01, 0.02, 0.03),
               likelihood_forget_per_meter=0.3, likelihood_forget_per_radian=0.2)
    jcfg, tcfg = jrs.ResamplerConfig.create(**cfg), trs.ResamplerConfig.create(**cfg)
    draws = _resampler_draws(kind, key, 300)
    if kind == "residual_dynamic":
        jo = jrs.residual_resample_dynamic(jc, key, jcfg, jnp.int32(200))
        to = trs.residual_dynamic_from_draws(tc, *draws, tcfg, torch.tensor(200))
    else:
        jo = getattr(jrs, f"{kind}_resample")(jc, key, jcfg)
        to = getattr(trs, f"{kind}_from_draws")(tc, *draws, tcfg)
    _close_clouds(jo, to, 1e-5)  # Euler round trips of perturbed poses


@pytest.mark.parametrize("kind", ["residual", "systematic"])
def test_degenerate_weights_resample_to_the_identity(kind):
    jc, tc = _clouds(n=64)
    tc = dataclasses.replace(tc, likelihood=dataclasses.replace(
        tc.likelihood, mean=torch.zeros(64)))
    to = getattr(trs, f"{kind}_resample")(tc, torch.Generator().manual_seed(0),
                                          trs.ResamplerConfig.create())
    assert torch.equal(to.poses.trans, tc.poses.trans)


def test_resamplers_draw_from_the_generator():
    _, tc = _clouds(n=200)
    cfg = trs.ResamplerConfig.create()
    for fn in (trs.gladiator_resample, trs.residual_resample, trs.systematic_resample):
        a = fn(tc, torch.Generator().manual_seed(4), cfg)
        b = fn(tc, torch.Generator().manual_seed(4), cfg)
        assert torch.equal(a.poses.trans, b.poses.trans)
        assert not torch.equal(a.poses.trans, tc.poses.trans)
    d = trs.residual_resample_dynamic(tc, torch.Generator().manual_seed(4), cfg, 120)
    assert int(d.n_alive) == 120 and bool(d.alive[:120].all())


def test_ess_and_adaptive_count_match_jax():
    for spread in (None, 0.3):
        jc, tc = _clouds(n=400, spread=spread)
        np.testing.assert_allclose(float(trs.effective_sample_size(tc)),
                                   float(jrs.effective_sample_size(jc)), rtol=1e-5)
        for kw in (dict(n_min=64, spread_ref=0.5), dict(n_min=10, n_max=300)):
            assert int(trs.adaptive_particle_count(tc, **kw)) == int(
                jrs.adaptive_particle_count(jc, **kw))


@pytest.mark.parametrize("case", ["all", "induction", "some_dead", "empty"])
def test_estimate_stats_match_jax(case):
    jc, tc = _clouds(n=300, spread=0.3)
    alive = np.ones(300, bool)
    if case == "some_dead":
        alive[::3] = False
    elif case == "empty":
        alive[:] = False
    jc = dataclasses.replace(jc, alive=jnp.asarray(alive))
    tc = _carry_cloud(jc)
    m = 100 if case == "induction" else None
    js_, ts_ = jms.estimate_stats(jc, max_induction_particles=m), tms.estimate_stats(tc, m)
    for f in ("likelihood_mean", "likelihood_sigma", "likelihood_min", "likelihood_max",
              "shift", "trans_bb_min", "trans_bb_max", "n_particles", "covariance"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(), np.asarray(getattr(js_, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(ts_.pose.trans.numpy(), np.asarray(js_.pose.trans), rtol=1e-5,
                               atol=1e-6)
    dot = abs(float(np.dot(ts_.pose.rot.numpy(), np.asarray(js_.pose.rot))))
    assert abs(dot - 1.0) < 1e-5
    if case == "empty":
        assert all(bool(torch.isfinite(getattr(ts_, f)).all())
                   for f in ("likelihood_min", "likelihood_max", "trans_bb_min"))


def test_particle_cloud_matches_jax():
    jc, tc = _clouds(n=50)
    assert tc.capacity == jc.capacity == 50 and int(tc.n_alive) == int(jc.n_alive)
    np.testing.assert_allclose(tc.weights().numpy(), np.asarray(jc.weights()), rtol=TOL,
                               atol=1e-9)
    fresh = TPC.create(8, device="cpu")
    jf = JPC.create(8)
    np.testing.assert_array_equal(fresh.poses.rot.numpy(), np.asarray(jf.poses.rot))
    np.testing.assert_array_equal(fresh.likelihood.mean.numpy(), np.asarray(jf.likelihood.mean))
