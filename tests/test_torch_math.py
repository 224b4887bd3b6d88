"""Parity of the PyTorch port's math core with the JAX package.

Same inputs, made with numpy from a seed, go through both packages.
Tolerance 1e-6 (float32 elementwise arithmetic, where the two frameworks
may round transcendental functions a last bit apart); 1e-5 where an SVD is
involved (LAPACK and XLA's SVD take different iterations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.math import gaussian as jg
from rmcl_tpu.math import se3 as js
from rmcl_tpu.math import stats as jst
from rmcl_tpu_torch.math import gaussian as tg
from rmcl_tpu_torch.math import se3 as ts
from rmcl_tpu_torch.math import stats as tst

torch.set_num_threads(2)

TOL = 1e-6
SVD_TOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pair(rng, n=16):
    """The same random transforms in both packages."""
    rot = _quats(rng, n)
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    return (js.Transform(jnp.asarray(rot), jnp.asarray(trans)),
            ts.Transform(torch.from_numpy(rot), torch.from_numpy(trans)))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "rotate", "normalized",
                                "to_matrix", "log6", "from_matrix"])
def test_transform_ops_match_jax(rng, op):
    ja, ta = _pair(rng)
    jb, tb = _pair(rng)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    if op == "compose":
        jr, tr = ja @ jb, ta @ tb
    elif op == "inverse":
        jr, tr = ~ja, ~ta
    elif op == "apply":
        jr, tr = ja.apply(jnp.asarray(pts)), ta.apply(torch.from_numpy(pts))
    elif op == "rotate":
        jr, tr = ja.rotate(jnp.asarray(pts)), ta.rotate(torch.from_numpy(pts))
    elif op == "normalized":
        scale = np.float32(1.3)
        jr = js.Transform(ja.rot * scale, ja.trans).normalized()
        tr = ts.Transform(ta.rot * scale, ta.trans).normalized()
    elif op == "to_matrix":
        jr, tr = ja.to_matrix(), ta.to_matrix()
    elif op == "log6":
        jr, tr = ja.log6(), ta.log6()
    else:
        m = np.array(ja.to_matrix())
        jr = js.Transform.from_matrix(jnp.asarray(m))
        tr = ts.Transform.from_matrix(torch.from_numpy(m))
    if isinstance(jr, js.Transform):
        _close(jr.rot, tr.rot)
        _close(jr.trans, tr.trans)
    else:
        _close(jr, tr)


def test_transform_constructors_match_jax(rng):
    pose6 = rng.normal(size=(5, 6)).astype(np.float32)
    j6 = js.Transform.from_pose_tuple(jnp.asarray(pose6))
    t6 = ts.Transform.from_pose_tuple(pose6, device="cpu")
    _close(j6.rot, t6.rot)
    _close(j6.trans, t6.trans)
    pose7 = np.concatenate([pose6[:, :3], _quats(rng, 5)], 1)
    j7 = js.Transform.from_pose_tuple(jnp.asarray(pose7))
    t7 = ts.Transform.from_pose_tuple(pose7, device="cpu")
    _close(j7.rot, t7.rot)
    _close(j7.trans, t7.trans)
    with pytest.raises(ValueError):
        ts.Transform.from_pose_tuple([1.0, 2.0], device="cpu")
    e = torch.from_numpy(pose6[:, 3:])
    _close(js.EulerAngles(*[jnp.asarray(pose6[:, 3 + k]) for k in range(3)]).to_quaternion(),
           ts.EulerAngles(e[:, 0], e[:, 1], e[:, 2]).to_quaternion())


def test_transform_batch_helpers(rng):
    _, ta = _pair(rng, 6)
    assert ta.batch_shape == (6,)
    assert ta.expand_dims(-1).batch_shape == (6, 1)
    assert ta.reshape((2, 3)).batch_shape == (2, 3)
    assert ta[1:3].batch_shape == (2,)
    bad = ts.Transform(ta.rot.clone(), ta.trans.clone())
    bad.trans[2, 0] = float("nan")
    assert ta.is_finite().all() and not bad.is_finite()[2] and bad.is_finite()[1]
    ident = ts.Transform.identity((4,), device="cpu")
    _close(np.tile([1.0, 0, 0, 0], (4, 1)), ident.rot)


def test_transform_stack_matches_jax(rng):
    """Stacking a list of poses along a new leading axis, as the scene
    graph's instance table does."""
    ja, ta = _pair(rng, 4)
    js_stack = js.transform_stack([ja[i] for i in range(4)])
    ts_stack = ts.transform_stack([ta[i] for i in range(4)])
    assert ts_stack.batch_shape == (4,)
    _close(js_stack.rot, ts_stack.rot)
    _close(js_stack.trans, ts_stack.trans)
    nested = ts.transform_stack([ta[0:2], ta[2:4]])
    assert nested.batch_shape == (2, 2) and torch.equal(nested.reshape((4,)).rot, ta.rot)


@pytest.mark.parametrize("fn", ["exp", "log", "from_euler", "to_euler"])
def test_quaternion_maps_match_jax(rng, fn):
    v = (0.8 * rng.normal(size=(32, 3))).astype(np.float32)
    v[0] = 0.0  # the small-angle branch
    if fn == "exp":
        _close(js.Quaternion.exp(jnp.asarray(v)), ts.Quaternion.exp(torch.from_numpy(v)))
    elif fn == "log":
        q = _quats(rng, 32)
        _close(js.Quaternion.log(jnp.asarray(q)), ts.Quaternion.log(torch.from_numpy(q)))
    elif fn == "from_euler":
        _close(js.Quaternion.from_euler(*jnp.asarray(v).T),
               ts.Quaternion.from_euler(*torch.from_numpy(v).T))
    else:
        q = _quats(rng, 32)
        for a, b in zip(js.Quaternion.to_euler(jnp.asarray(q)),
                        ts.Quaternion.to_euler(torch.from_numpy(q))):
            _close(a, b)


def _point_sets(rng, n=200):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    m = (d @ np.asarray(js.Quaternion.to_matrix(jnp.asarray(_quats(rng, 1)[0]))).T
         + rng.normal(size=3) + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.3
    return d, m, mask


def _stats_close(js_, ts_, tol=TOL):
    for f in ("dataset_mean", "model_mean", "covariance", "n_meas"):
        _close(getattr(js_, f), getattr(ts_, f), tol)


def test_cross_statistics_match_jax(rng):
    d1, m1, k1 = _point_sets(rng)
    d2, m2, k2 = _point_sets(rng)
    j1 = jg.CrossStatistics.from_masked_points(jnp.asarray(d1), jnp.asarray(m1), jnp.asarray(k1))
    t1 = tg.CrossStatistics.from_masked_points(torch.from_numpy(d1), torch.from_numpy(m1),
                                               torch.from_numpy(k1))
    j2 = jg.CrossStatistics.from_masked_points(jnp.asarray(d2), jnp.asarray(m2), jnp.asarray(k2))
    t2 = tg.CrossStatistics.from_masked_points(torch.from_numpy(d2), torch.from_numpy(m2),
                                               torch.from_numpy(k2))
    _stats_close(j1, t1)
    _stats_close(j1 + j2, t1 + t2)
    _stats_close(j1 + jg.CrossStatistics.empty(), t1 + tg.CrossStatistics.empty(device="cpu"))
    _stats_close(j1.scale_weight(0.5), t1.scale_weight(0.5))
    jT, tT = _pair(rng, 1)
    _stats_close(j1.transform(jT[0]), t1.transform(tT[0]))
    # an all-masked set is the empty monoid element
    none = np.zeros_like(k1)
    _stats_close(
        jg.CrossStatistics.from_masked_points(jnp.asarray(d1), jnp.asarray(m1), jnp.asarray(none)),
        tg.CrossStatistics.from_masked_points(torch.from_numpy(d1), torch.from_numpy(m1),
                                              torch.from_numpy(none)))


def test_gaussian1d_merge_matches_jax(rng):
    a = [rng.random(8).astype(np.float32) for _ in range(3)]
    b = [rng.random(8).astype(np.float32) for _ in range(3)]
    b[2][0] = 0.0
    a[2][0] = 0.0  # an empty merge
    jm = jg.Gaussian1D(*map(jnp.asarray, a)) + jg.Gaussian1D(*map(jnp.asarray, b))
    tm = tg.Gaussian1D(*map(torch.from_numpy, a)) + tg.Gaussian1D(*map(torch.from_numpy, b))
    for f in ("mean", "sigma", "n_meas"):
        _close(getattr(jm, f), getattr(tm, f))
    _close(jg.Gaussian1D.of(jnp.asarray(a[0])).forget(0.25).n_meas,
           tg.Gaussian1D.of(torch.from_numpy(a[0])).forget(0.25).n_meas)


def test_umeyama_transform_matches_jax(rng):
    d, m, k = _point_sets(rng, 400)
    jst_ = jg.CrossStatistics.from_masked_points(jnp.asarray(d), jnp.asarray(m), jnp.asarray(k))
    tst_ = tg.CrossStatistics.from_masked_points(torch.from_numpy(d), torch.from_numpy(m),
                                                 torch.from_numpy(k))
    jT = jst.umeyama_transform(jst_)
    tT = tst.umeyama_transform(tst_)
    _close(jT.rot, tT.rot, SVD_TOL)
    _close(jT.trans, tT.trans, SVD_TOL)
    _close(jst.kabsch_rotation(jst_.covariance), tst.kabsch_rotation(tst_.covariance), SVD_TOL)
    # degenerate statistics give the identity
    tI = tst.umeyama_transform(tg.CrossStatistics.empty(device="cpu"))
    _close(np.array([1.0, 0, 0, 0]), tI.rot)
    _close(np.zeros(3), tI.trans)


# --- the MCL half of math/stats: Markley mean, pose covariance, samplers ---

# eigh and the weighted sums run in other orders: the mean rotation agrees
# to 1e-5 as a rotation (|<q_a, q_b>| within 1e-5 of 1), the covariance to
# 1e-5 relative
EIG_TOL = 1e-5


def _cloud_pair(rng, n=200, spread=0.3):
    """A cloud of poses around one random pose, and weights with zeros."""
    base = _quats(rng, 1)
    d = rng.normal(scale=spread, size=(n, 3)).astype(np.float32)
    jq = js.Quaternion.mul(jnp.asarray(base), js.Quaternion.exp(jnp.asarray(d)))
    rot = np.array(jq, np.float32)
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.uniform(size=n).astype(np.float32)
    w[::7] = 0.0
    return (js.Transform(jnp.asarray(rot), jnp.asarray(trans)),
            ts.Transform(torch.from_numpy(rot), torch.from_numpy(trans)), w)


def _same_rotation(jq, tq, tol=EIG_TOL):
    dot = abs(float(np.dot(np.asarray(jq, np.float64), tq.numpy().astype(np.float64))))
    assert abs(dot - 1.0) <= tol, dot
    assert float(tq[0]) >= 0.0  # the sign rule


@pytest.mark.parametrize("spread", [0.3, 1e-3])  # 1e-3: a tight, near-degenerate cloud
def test_markley_mean_matches_jax(rng, spread):
    jp, tp, w = _cloud_pair(rng, spread=spread)
    _same_rotation(jst.markley_mean(jp.rot, jnp.asarray(w)),
                   tst.markley_mean(tp.rot, torch.from_numpy(w)))
    # all-zero weights fall back to the unweighted mean
    z = np.zeros_like(w)
    _same_rotation(jst.markley_mean(jp.rot, jnp.asarray(z)),
                   tst.markley_mean(tp.rot, torch.from_numpy(z)))


def test_weighted_pose_mean_and_covariance_match_jax(rng):
    jp, tp, w = _cloud_pair(rng)
    jm = jst.weighted_pose_mean(jp, jnp.asarray(w))
    tm = tst.weighted_pose_mean(tp, torch.from_numpy(w))
    _same_rotation(jm.rot, tm.rot)
    _close(jm.trans, tm.trans, EIG_TOL)
    jc = jst.pose_covariance_6x6(jp, jm, jnp.asarray(w))
    tc = tst.pose_covariance_6x6(tp, tm, torch.from_numpy(w))
    _close(jc, tc, EIG_TOL)


def test_pose_samplers_match_jax_on_the_same_draws():
    """The pure steps on JAX's own draws, regenerated from the key as the
    JAX samplers draw them."""
    import jax

    key = jax.random.PRNGKey(4)
    mean_j = js.Transform(jnp.asarray([0.9, 0.1, -0.2, 0.3]) / np.sqrt(0.95),
                          jnp.asarray([1.0, -2.0, 0.5]))
    mean_t = ts.Transform(torch.from_numpy(np.asarray(mean_j.rot)),
                          torch.from_numpy(np.asarray(mean_j.trans)))
    cov = np.diag([0.04, 0.04, 0.01, 1e-4, 1e-4, 3e-3]).astype(np.float32)
    cov[0, 1] = cov[1, 0] = 0.01
    jg_ = jst.sample_pose_gaussian(key, mean_j, jnp.asarray(cov), 300)
    normals = np.asarray(jax.random.normal(key, (300, 6), dtype=jnp.float32))
    tg_ = tst.pose_gaussian_from_normals(mean_t, torch.from_numpy(cov), torch.from_numpy(normals))
    _close(jg_.rot, tg_.rot, 1e-5)  # the Cholesky factors round apart
    _close(jg_.trans, tg_.trans, 1e-5)
    lo, hi = [-1, -2, 0, -0.1, -0.1, -np.pi], [3, 2, 1, 0.1, 0.1, np.pi]
    ju = jst.sample_pose_uniform(key, jnp.asarray(lo), jnp.asarray(hi), 300)
    u = np.asarray(jax.random.uniform(key, (300, 6), minval=jnp.asarray(lo),
                                      maxval=jnp.asarray(hi)))
    tu = tst.pose_uniform_from_draws(torch.from_numpy(u))
    _close(ju.rot, tu.rot)
    _close(ju.trans, tu.trans)


def test_pose_samplers_draw_from_the_generator():
    """The draw steps: the same seed gives the same poses; uniform poses
    stay in the box; Gaussian poses spread as the covariance says."""
    gen = lambda: torch.Generator().manual_seed(11)
    mean = ts.Transform.identity(device="cpu")
    cov = torch.diag(torch.tensor([0.04, 0.01, 0.0001, 1e-4, 1e-4, 1e-2]))
    a = tst.sample_pose_gaussian(gen(), mean, cov, 20000)
    b = tst.sample_pose_gaussian(gen(), mean, cov, 20000)
    assert torch.equal(a.trans, b.trans) and torch.equal(a.rot, b.rot)
    np.testing.assert_allclose(a.trans.std(0).numpy(), [0.2, 0.1, 0.01], rtol=0.03)
    lo, hi = [-1.0, -2.0, 0.0, 0.0, 0.0, -0.5], [3.0, 2.0, 1.0, 0.0, 0.0, 0.5]
    u = tst.sample_pose_uniform(gen(), lo, hi, 5000, device="cpu")
    assert bool((u.trans >= torch.tensor(lo[:3])).all() & (u.trans <= torch.tensor(hi[:3])).all())


def test_gaussian_pdf_matches_jax(rng):
    x = rng.normal(scale=2.0, size=500).astype(np.float32)
    m = rng.normal(size=500).astype(np.float32)
    for sigma in (0.4, 2.0):
        _close(jst.gaussian_pdf(jnp.asarray(x), sigma),
               tst.gaussian_pdf(torch.from_numpy(x), sigma))
        _close(jst.gaussian_pdf(jnp.asarray(x), sigma, jnp.asarray(m)),
               tst.gaussian_pdf(torch.from_numpy(x), sigma, torch.from_numpy(m)))
