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
