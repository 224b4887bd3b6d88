"""MCL's ray-cast sensor update on the exact walk as one step,
``ops/traverse_cuda.py::walk_score_rc``: its plain version (what every CPU
update runs) against the composition the other engines run, the cast
(``cast_update_rays``), ``score_rc`` and ``fold``, bitwise; and the
sensor update's dispatch to it. The kernels' side is in
``tests/test_torch_cuda.py``. Imports neither JAX nor the JAX package."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import gaussian_pdf
from rmcl_tpu_torch.mcl import sensor_update as tsu
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.ops import traverse_cuda
from rmcl_tpu_torch.ops.traverse_cuda import walk_score_rc
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate
from rmcl_tpu_torch.utils import timing

torch.set_num_threads(2)

POSE = [3.1, 2.9, 1.5, 0, 0, 0.3]
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _world():
    """The small building (4,136 faces), its BVH and a scan at POSE."""
    from rmcl_tpu_torch.geom.mesh import make_building_scene

    mesh = make_building_scene(subdiv=4)
    bvh = build_bvh(mesh, device=CPU)
    model = SphericalModel.create(width=180, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    hits = simulate(bvh, model, Transform.from_pose_tuple(POSE, device=CPU))
    return mesh, bvh, hits.point, hits.hit


def _cloud(n, case="scan", seed=4, spread=0.5):
    """n particles about POSE; under "edges" every tenth lifted 20 m, above
    the roof, where the beams that point up hit nothing."""
    rng = np.random.default_rng(seed)
    xyz = np.float32(POSE[:3]) + rng.normal(scale=[spread, spread, 0.05], size=(n, 3))
    if case == "edges":
        xyz[::10, 2] += 20.0
    eul = np.zeros((n, 3), np.float32)
    eul[:, 2] = POSE[5] + rng.normal(scale=0.2, size=n)
    poses = Transform.from_xyz_euler(torch.from_numpy(xyz.astype(np.float32)),
                                     torch.from_numpy(eul))
    cloud = ParticleCloud.create(n, device=CPU).with_poses(poses)
    lik = dataclasses.replace(cloud.likelihood,
                              mean=torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32)),
                              n_meas=torch.from_numpy(rng.uniform(0, 50, n).astype(np.float32)))
    return dataclasses.replace(cloud, likelihood=lik)


def _beams(S, case, seed=6):
    """S beams drawn from the scan, edited for ``case``: "scan" as drawn;
    "edges" with a third of them real misses (invalid or past range_max),
    some measured closer than range_min, and some measured at half the
    surface's distance (so the range cap stops their rays short of it)."""
    *_, points, mask = _world()
    dirs, ranges, valid = tsu.sample_beams(torch.Generator().manual_seed(seed), points, mask, S)
    if case == "edges":
        ranges, valid = ranges.clone(), valid.clone()
        valid[0::6] = False
        ranges[1::6] = 45.0  # past range_max: a real miss
        ranges[2::6] = 0.05  # under range_min: a real miss
        ranges[3::6] *= 0.5  # the cap stops the ray before the surface
    return dirs, ranges, valid


def _config(S, case):
    kw = dict(samples=S, engine="bvh", dist_sigma=0.4, range_max=30.0)
    if case == "edges":
        # simulated hits nearer than range_min from particles next to walls
        kw.update(range_min=0.9, range_cap_sigmas=2.0, real_miss_sim_miss_error=0.25)
    return tsu.SensorUpdateConfig.create(**kw)


def _composition(bvh, cloud, tsb, cfg, beams):
    """The update as the other engines compose it: (evals, e_mean, e_var,
    the updated cloud)."""
    layout = tsu.beam_layout(cfg, beams)
    tsm, perm_inv = tsu.cluster_poses(cloud, tsb, cfg)
    orig_m, dirs_m, hits = tsu.cast_update_rays(bvh, cfg, tsm, layout)
    error = tsu.score_rc(cfg, layout, orig_m, dirs_m, hits)
    evals = gaussian_pdf(error, cfg.dist_sigma)
    w = layout.weight[None, :]
    e_mean = torch.sum(evals * w, dim=-1) / cfg.samples
    e_var = torch.sum(w * (evals - e_mean[:, None]) ** 2, dim=-1) / cfg.samples
    return evals, e_mean, e_var, tsu.fold(cloud, cfg, layout, error, perm_inv)


def _walk_score(bvh, cloud, tsb, cfg, beams, **kw):
    layout = tsu.beam_layout(cfg, beams)
    tsm, _ = tsu.cluster_poses(cloud, tsb, cfg)
    return walk_score_rc(bvh.nodes, bvh.root_link, torch.cat([tsm.rot, tsm.trans], dim=-1),
                         tsu.score_beams(layout), range_min=cfg.range_min,
                         hit_miss=cfg.real_hit_sim_miss_error,
                         miss_hit=cfg.real_miss_sim_hit_error,
                         miss_miss=cfg.real_miss_sim_miss_error, dist_sigma=cfg.dist_sigma,
                         evals=True, **kw)


def _assert_same_likelihood(a, b):
    for f in ("mean", "sigma", "n_meas"):
        assert torch.equal(getattr(a.likelihood, f), getattr(b.likelihood, f)), f


@pytest.mark.parametrize("S,N,case", [
    (100, 300, "scan"),
    (37, 300, "scan"),
    (100, 257, "edges"),
    (37, 130, "edges"),
])
def test_plain_version_is_the_composition_bitwise(S, N, case):
    """Evals, both sums and the sensor update's likelihoods equal the
    composition's bit for bit (N not a multiple of 128 either)."""
    _, bvh, *_ = _world()
    cloud, tsb = _cloud(N, case), Transform.identity(device=CPU)
    cfg, beams = _config(S, case), _beams(S, case)
    evals, e_mean, e_var, want = _composition(bvh, cloud, tsb, cfg, beams)
    got_mean, got_var, got_evals = _walk_score(bvh, cloud, tsb, cfg, beams)
    assert torch.equal(got_evals, evals)
    assert torch.equal(got_mean, e_mean) and torch.equal(got_var, e_var)
    _assert_same_likelihood(tsu.sensor_update(bvh, cloud, None, None, None, tsb, cfg,
                                              beams=beams), want)


@pytest.mark.parametrize("case", ["scan", "edges"])
def test_cases_reach_every_branch(case):
    """The cases do what they are for: real hits scored by their distance,
    and under "edges" also each penalty, simulated hits nearer than
    range_min, and real hits whose capped ray stops short of the surface."""
    _, bvh, *_ = _world()
    S = 100
    cloud, tsb = _cloud(257, case), Transform.identity(device=CPU)
    cfg, beams = _config(S, case), _beams(S, case)
    layout = tsu.beam_layout(cfg, beams)
    tsm, _ = tsu.cluster_poses(cloud, tsb, cfg)
    _, _, hits = tsu.cast_update_rays(bvh, cfg, tsm, layout)
    real = layout.real_hit[None, :].expand_as(hits.hit)
    near = hits.hit & (hits.t <= cfg.range_min)
    assert bool((hits.hit & ~near & real).any())  # scored by distance
    if case == "edges":
        assert bool((~real & hits.hit & ~near).any())  # real miss, sim hit
        assert bool((~real & ~hits.hit).any())  # real miss, sim miss
        assert bool((real & near).any())  # a sim hit nearer than range_min
        # capped short: the uncapped ray hits, the capped one does not
        free = dataclasses.replace(cfg, range_cap_sigmas=0.0)
        _, _, open_hits = tsu.cast_update_rays(bvh, free, tsm, tsu.beam_layout(free, beams))
        assert bool((real & ~hits.hit & open_hits.hit).any())


def test_chunked_walk_is_the_unchunked_one():
    """The plain version's walk in chunks (here of 1,000 rays, not a
    multiple of S) gives the unchunked result bitwise."""
    _, bvh, *_ = _world()
    cloud, tsb = _cloud(300, "edges"), Transform.identity(device=CPU)
    cfg, beams = _config(37, "edges"), _beams(37, "edges")
    a = _walk_score(bvh, cloud, tsb, cfg, beams, chunk_size=1000)
    b = _walk_score(bvh, cloud, tsb, cfg, beams)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sensor_update_takes_it_for_rc_on_the_bvh(monkeypatch):
    """RC on the bvh engine runs walk_score_rc once an update (the span and
    the counter ``rmcl.mcl.walk_score``) and never the step-by-step cast;
    CP on the bvh engine and RC on the binned engine do not take it."""
    from rmcl_tpu_torch.bvh.bins import build_bins

    mesh, bvh, points, mask = _world()
    cloud, tsb = _cloud(200), Transform.identity(device=CPU)
    cfg = _config(24, "scan")
    calls = []
    cast = tsu.cast_update_rays
    monkeypatch.setattr(tsu, "cast_update_rays",
                        lambda *a, **k: calls.append(a[1].engine) or cast(*a, **k))
    timing.set_tracing(True)
    try:
        tsu.sensor_update(bvh, cloud, torch.Generator().manual_seed(1), points, mask, tsb, cfg)
        tsu.sensor_update(bvh, cloud, torch.Generator().manual_seed(1), points, mask, tsb, cfg)
        assert calls == []
        assert timing.counters().get("rmcl.mcl.walk_score") == 2
        assert timing.store().count["rmcl.mcl.walk_score"] == 2
        tsu.sensor_update(bvh, cloud, torch.Generator().manual_seed(1), points, mask, tsb,
                          dataclasses.replace(cfg, correspondence_type="CP"))
        bins = build_bins(mesh, bin_size=8, bins_per_super=16, device=CPU)
        tsu.sensor_update(bins, cloud, torch.Generator().manual_seed(1), points, mask, tsb,
                          dataclasses.replace(cfg, engine="binned", c_super=64, c_bin=512))
        assert calls == ["binned"]
        assert timing.counters().get("rmcl.mcl.walk_score") == 2
    finally:
        timing.set_tracing(False)


def test_node_compact_prefix_is_the_composition_bitwise():
    """The node's compact-prefix update (a dynamic count: the live prefix,
    padded to a power of two, is cast) writes the composition's likelihoods
    on that prefix, bit for bit, and leaves the rest."""
    from rmcl_tpu_torch.mcl import node as tnode

    _, bvh, points, mask = _world()
    cfg = tnode.MCLConfig(n_particles=512, seed=3, dynamic_count="adaptive",
                          resampler="residual", adaptive_n_min=64,
                          sensor=tsu.SensorUpdateConfig.create(samples=32, dist_sigma=0.3,
                                                               engine="bvh"))
    node = tnode.MCLNode(bvh, cfg)
    node.initial_pose_guess(Transform.from_pose_tuple(POSE, device=CPU),
                            torch.diag(torch.tensor([1e-2, 1e-2, 1e-4, 1e-6, 1e-6, 1e-3])))
    tsb = Transform.identity(device=CPU)
    node.motion_update(Transform.identity(device=CPU), 0.0)
    node.motion_update(Transform.from_pose_tuple([0.01, 0, 0, 0, 0, 0], device=CPU), 0.1)
    node.sensor_update(points, mask, tsb)
    assert node.resample()
    k = node._compact_slice()
    assert k is not None and k < 512
    before = node.cloud
    g = torch.Generator(device=CPU)
    g.set_state(node.generator.get_state())
    beams = tsu.sample_beams(g, points, mask, 32)
    node.sensor_update(points, mask, tsb)
    sub = before.map(lambda x: x[:k])
    *_, want = _composition(bvh, sub, tsb, node.config.sensor, beams)
    for f in ("mean", "sigma", "n_meas"):
        got = getattr(node.cloud.likelihood, f)
        assert torch.equal(got[:k], getattr(want.likelihood, f)), f
        assert torch.equal(got[k:], getattr(before.likelihood, f)[k:]), f


@pytest.mark.parametrize("bad", ["tsm_shape", "beams_shape", "dtype", "device"])
def test_walk_score_rc_checks_its_inputs(bad):
    _, bvh, *_ = _world()
    tsm = torch.zeros((10, 7))
    beams = torch.zeros((5, traverse_cuda.BEAM_WORDS))
    if bad == "tsm_shape":
        tsm = torch.zeros((10, 6))
    elif bad == "beams_shape":
        beams = torch.zeros((5, 7))
    elif bad == "dtype":
        tsm = tsm.double()
    else:
        tsm = tsm.to("meta")
    kw = dict(range_min=0.1, hit_miss=100.0, miss_hit=100.0, miss_miss=0.0, dist_sigma=0.4)
    with pytest.raises((ValueError, TypeError)):
        walk_score_rc(bvh.nodes, bvh.root_link, tsm, beams, **kw)
