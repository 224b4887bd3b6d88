"""The port's TrackedCorrector against the JAX package's, on the world of
tests/test_tracking.py: the same bins (carried across), the same dataset,
the same start pose; the pose track and the re-culls must agree."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.micp.pipeline import MICPConfig as JConfig
from rmcl_tpu.micp.pipeline import MICPSensorConfig as JSensorConfig
from rmcl_tpu.micp.pipeline import MICPSensorData as JSensorData
from rmcl_tpu.micp.tracking import TrackedCorrector as JTracked
from rmcl_tpu.sensors.models import OnDnModel as JOnDn
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu_torch.convert import bins_from_arrays, transform_from_arrays
from rmcl_tpu_torch.micp import pipeline as tp
from rmcl_tpu_torch.micp.tracking import TrackedCorrector
from rmcl_tpu_torch.sensors.models import OnDnModel, SphericalModel

torch.set_num_threads(2)

# GN solves over the same correspondences; the sums run in another order in
# the two frameworks, so poses agree to float32 rounding of the solve, not
# bitwise. The loop contracts, so the difference does not grow over steps.
POSE_TOL = 1e-5
MATCH_RTOL = 5e-3
START = [0.15, -0.1, 0.08]


@functools.lru_cache(maxsize=None)
def _world():
    jb = build_bins(make_sphere(80, 80, radius=10.0), bin_size=64, bins_per_super=16,
                    supers_per_hyper=16)
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    tb = bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                          bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    jmodel = JSpherical.vlp16(width=180)
    hits = j_simulate(jb, jmodel, JTransform.identity(), c_super=24, c_bin=256)
    points = np.asarray(jmodel.polar_to_cartesian(jnp.where(hits.hit, hits.t, 0.0)))
    return jb, tb, jmodel, points, np.asarray(hits.hit)


def _jax_track(jb, models, datas, tsbs, tom, n_steps, **kw):
    tc = JTracked(jb, models, JConfig(c_bin=256), **kw)
    tbo = JTransform.identity()
    state = tc.init(jb, tom, tbo, tsbs)
    track = []
    for _ in range(n_steps):
        state, stats = tc.step(jb, datas, state, tbo)
        track.append((np.asarray(state.tom.trans), np.asarray(state.tom.rot),
                      float(stats.valid_matches)))
    return track, int(state.n_reculls)


def _port_track(tb, models, datas, tsbs, tom, n_steps, **kw):
    tc = TrackedCorrector(tb, models, tp.MICPConfig(c_bin=256), **kw)
    tbo = transform_from_arrays([1.0, 0, 0, 0], [0.0, 0, 0], device="cpu")
    state = tc.init(tb, tom, tbo, tsbs)
    track = []
    for _ in range(n_steps):
        state, stats = tc.step(tb, datas, state, tbo)
        track.append((state.tom.trans.numpy(), state.tom.rot.numpy(),
                      float(stats.valid_matches)))
    return track, state.n_reculls


def _compare(jt, tt):
    for (j_t, j_q, j_n), (t_t, t_q, t_n) in zip(jt, tt):
        np.testing.assert_allclose(t_t, j_t, rtol=0.0, atol=POSE_TOL)
        np.testing.assert_allclose(t_q * np.sign(np.dot(t_q, j_q)), j_q, rtol=0.0,
                                   atol=POSE_TOL)
        # the same correspondences up to a few rays at the distance gate or
        # grazing an edge (the JAX package's own tracked-vs-generic check)
        np.testing.assert_allclose(t_n, j_n, rtol=MATCH_RTOL)


def test_tracked_corrector_matches_jax():
    """8 steps from the +(0.15, -0.1, 0.08) m offset: poses within 1e-5 m,
    the same re-culls (init + one after the first correction's jump)."""
    jb, tb, jmodel, points, mask = _world()
    jdata = JSensorData(model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
                        tsb=JTransform.identity(),
                        config=JSensorConfig.create(max_dist=0.6))
    model = SphericalModel.vlp16(width=180)
    tdata = tp.MICPSensorData(model=model, points=torch.from_numpy(points),
                              mask=torch.from_numpy(mask),
                              tsb=transform_from_arrays([1.0, 0, 0, 0], [0.0, 0, 0], "cpu"),
                              config=tp.MICPSensorConfig.create(max_dist=0.6))
    kw = dict(origin_margin=0.05, dir_margin=0.01)
    jt, j_re = _jax_track(jb, jmodel, jdata, jdata.tsb,
                          JTransform(rot=jnp.asarray([1.0, 0, 0, 0]),
                                     trans=jnp.asarray(START, jnp.float32)), 8, **kw)
    tt, t_re = _port_track(tb, model, tdata, tdata.tsb,
                           transform_from_arrays([1.0, 0, 0, 0], START, "cpu"), 8, **kw)
    assert t_re == j_re == 2
    _compare(jt, tt)
    assert np.linalg.norm(tt[-1][0]) < 1e-3  # converged onto the truth


@pytest.mark.parametrize("margins", [(0.05, 0.01), (1e-9, 1e-9)], ids=["reuse", "recull"])
def test_tracked_multisensor_ondn_matches_jax(margins):
    """Two sensors (spherical + OnDn through the paired layout), 4 steps,
    with reuse and with a re-cull every step."""
    jb, tb, jmodel, points, mask = _world()
    rng = np.random.default_rng(5)
    origs = rng.uniform(-0.2, 0.2, (256, 3)).astype(np.float32)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    jondn = JOnDn.create(origs=jnp.asarray(origs), dirs=jnp.asarray(dirs), range_max=50.0)
    jtsb2 = JTransform.from_pose_tuple(jnp.asarray([0.1, 0.0, 0.05, 0, 0, 0.2]))
    hits2 = j_simulate(jb, jondn, jtsb2, c_super=24, c_bin=256)
    p2 = np.asarray(jondn.polar_to_cartesian(jnp.where(hits2.hit, hits2.t, 0.0)))
    m2 = np.asarray(hits2.hit)
    ident = lambda: transform_from_arrays([1.0, 0, 0, 0], [0.0, 0, 0], "cpu")
    tsb2 = transform_from_arrays(np.asarray(jtsb2.rot), np.asarray(jtsb2.trans), "cpu")
    jd = [JSensorData(model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
                      tsb=JTransform.identity(), config=JSensorConfig.create(max_dist=0.6)),
          JSensorData(model=jondn, points=jnp.asarray(p2), mask=jnp.asarray(m2), tsb=jtsb2,
                      config=JSensorConfig.create(max_dist=0.6, weight=0.7))]
    ondn = OnDnModel.create(origs=origs, dirs=dirs, range_max=50.0, device="cpu")
    td = [tp.MICPSensorData(model=SphericalModel.vlp16(width=180),
                            points=torch.from_numpy(points), mask=torch.from_numpy(mask),
                            tsb=ident(), config=tp.MICPSensorConfig.create(max_dist=0.6)),
          tp.MICPSensorData(model=ondn, points=torch.from_numpy(p2), mask=torch.from_numpy(m2),
                            tsb=tsb2, config=tp.MICPSensorConfig.create(max_dist=0.6, weight=0.7))]
    start = [0.06, -0.04, 0.03]
    kw = dict(origin_margin=margins[0], dir_margin=margins[1], group=64)
    jt, j_re = _jax_track(jb, [jmodel, jondn], jd, [d.tsb for d in jd],
                          JTransform(rot=jnp.asarray([1.0, 0, 0, 0]),
                                     trans=jnp.asarray(start, jnp.float32)), 4, **kw)
    tt, t_re = _port_track(tb, [d.model for d in td], td, [d.tsb for d in td],
                           transform_from_arrays([1.0, 0, 0, 0], start, "cpu"), 4, **kw)
    assert t_re == j_re
    _compare(jt, tt)
