"""Gradients through the port's casts: ``ops/diff.py::cast_rays_diff`` with
respect to the mesh vertices (on the exact and the binned engine), and
``cast_rays_binned`` with respect to the ray origins, against the JAX
package on the CPU.

Both packages pick the winners on the same structures (the port's BVH and
default bins are bitwise JAX's), then re-derive t from the same float32
plane arithmetic, which the two frameworks may round an ulp apart, so:

- t within T_TOL (1e-5, relative and absolute: JAX's own bar between the
  engines, ``tests/test_bvh_raycast.py``); hits and winners equal;
- gradients against ``jax.grad`` within GRAD_RTOL (1e-4 relative) + GRAD_ATOL
  (1e-5): float32 sums of per-ray terms in another order;
- central differences (eps 1e-3, on a float32 loss) within FD_RTOL (5%) +
  FD_ATOL (1e-3), JAX's own bar for the vertex gradient; the origin
  gradient of ``tests/test_raycast_binned.py`` within its 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins as j_build_bins
from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.ops.diff import cast_rays_diff as j_cast_rays_diff
from rmcl_tpu.ops.raycast import cast_rays as j_cast_rays
from rmcl_tpu.ops.raycast_binned import cast_rays_binned as j_cast_rays_binned
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.ops.diff import cast_rays_diff
from rmcl_tpu_torch.ops.raycast import cast_rays
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned

torch.set_num_threads(2)

T_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FD_EPS, FD_RTOL, FD_ATOL = 1e-3, 0.05, 1e-3


def _sphere_rays():
    """32 rays from the centre of a radius-2 sphere (all hit) and 8 from
    outside pointing away (all miss: they gather face 0, and no NaN may
    reach a gradient through the selects)."""
    rng = np.random.default_rng(42)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((40, 3), np.float32)
    o[32:] = 10.0 * d[32:]
    return o, d


@pytest.fixture(scope="module")
def sphere():
    mesh = jm.make_sphere(24, 24, radius=2.0)
    assert np.array_equal(mesh.vertices, tm.make_sphere(24, 24, radius=2.0).vertices)
    structs = {
        "bvh": (j_build_bvh(mesh), build_bvh(mesh, device="cpu")),
        "bins": (j_build_bins(mesh, bin_size=16, bins_per_super=8),
                 build_bins(mesh, bin_size=16, bins_per_super=8, device="cpu")),
    }
    return mesh, structs


@pytest.mark.parametrize("engine", ["bvh", "bins"])
def test_cast_rays_diff_matches_jax(sphere, engine):
    mesh, structs = sphere
    js, ts = structs[engine]
    o, d = _sphere_rays()
    V, F = mesh.vertices, mesh.faces

    jh = j_cast_rays_diff(js, jnp.asarray(V), jnp.asarray(F), jnp.asarray(o), jnp.asarray(d))
    verts = torch.from_numpy(V.copy()).requires_grad_(True)
    th = cast_rays_diff(ts, verts, torch.from_numpy(F), torch.from_numpy(o), torch.from_numpy(d))
    hit = th.hit.numpy()
    assert hit[:32].all() and not hit[32:].any()
    np.testing.assert_array_equal(np.asarray(jh.hit), hit)
    np.testing.assert_array_equal(np.asarray(jh.prim_id), th.prim_id.numpy())
    np.testing.assert_allclose(th.t.detach().numpy(), np.asarray(jh.t), rtol=T_TOL, atol=T_TOL)
    np.testing.assert_allclose(th.normal.detach().numpy(), np.asarray(jh.normal), atol=T_TOL)
    # the same t as the engine's own cast
    base = cast_rays(structs["bvh"][1], torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(th.t.detach().numpy(), base.t.numpy(), rtol=T_TOL, atol=T_TOL)

    def j_loss(v):
        h = j_cast_rays_diff(js, v, jnp.asarray(F), jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    def t_loss(v):
        h = cast_rays_diff(ts, v, torch.from_numpy(F), torch.from_numpy(o), torch.from_numpy(d))
        return torch.where(h.hit, h.t, 0.0).sum()

    jg = np.asarray(jax.grad(j_loss)(jnp.asarray(V)))
    t_loss(verts).backward()
    g = verts.grad.numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    # central differences on the 5 largest-gradient vertex coordinates
    with torch.no_grad():
        for i in np.argsort(np.abs(g).ravel())[-5:]:
            e = np.zeros(V.size, np.float32)
            e[i] = FD_EPS
            e = torch.from_numpy(e.reshape(V.shape))
            v0 = torch.from_numpy(V)
            fd = (float(t_loss(v0 + e)) - float(t_loss(v0 - e))) / (2 * FD_EPS)
            np.testing.assert_allclose(fd, g.ravel()[i], rtol=FD_RTOL, atol=FD_ATOL)


def test_binned_gradients_wrt_origins():
    """The port's twin of ``tests/test_raycast_binned.py::test_binned_gradients``:
    d(sum t)/d(origins) through ``cast_rays_binned`` by autograd, against
    central differences and ``jax.grad``."""
    mesh = jm.make_sphere(48, 48, radius=2.0)
    jb = j_build_bins(mesh, bin_size=32, bins_per_super=8)
    tb = build_bins(mesh, bin_size=32, bins_per_super=8, device="cpu")
    d = np.broadcast_to(np.asarray([0.70710678, 0.70710678, 0.0], np.float32), (4, 3)).copy()
    o0 = np.tile([[0.1, -0.2, 0.05]], (4, 1)).astype(np.float32)

    def f(o):
        return cast_rays_binned(tb, o, torch.from_numpy(d)).t.sum()

    o = torch.from_numpy(o0.copy()).requires_grad_(True)
    f(o).backward()
    g = o.grad.numpy()
    jg = np.asarray(jax.grad(lambda x: j_cast_rays_binned(jb, x, jnp.asarray(d)).t.sum())(
        jnp.asarray(o0)))
    np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with torch.no_grad():
        for axis in range(3):
            delta = np.zeros((4, 3), np.float32)
            delta[:, axis] = FD_EPS
            fd = (float(f(torch.from_numpy(o0 + delta)))
                  - float(f(torch.from_numpy(o0 - delta)))) / (2 * FD_EPS)
            np.testing.assert_allclose(g[:, axis].sum(), fd, atol=5e-2)
    # and through the directions: finite, and the same as JAX's
    dirs = torch.from_numpy(d.copy()).requires_grad_(True)
    cast_rays_binned(tb, torch.from_numpy(o0), dirs).t.sum().backward()
    jgd = np.asarray(jax.grad(lambda x: j_cast_rays_binned(jb, jnp.asarray(o0), x).t.sum())(
        jnp.asarray(d)))
    np.testing.assert_allclose(dirs.grad.numpy(), jgd, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_exact_engine_gradients_reach_origins_through_cast_rays_diff(sphere):
    """Rays and vertices together: d(sum t)/d(origin) of ``cast_rays_diff``
    equals ``cast_rays``' own (the same plane, re-derived from the live
    vertices)."""
    mesh, structs = sphere
    o, d = _sphere_rays()
    o_a = torch.from_numpy(o[:32] * 0.25).requires_grad_(True)
    o_b = o_a.detach().clone().requires_grad_(True)
    dd = torch.from_numpy(d[:32])
    verts = torch.from_numpy(mesh.vertices.copy()).requires_grad_(True)
    cast_rays_diff(structs["bvh"][1], verts, mesh.faces, o_a, dd).t.sum().backward()
    cast_rays(structs["bvh"][1], o_b, dd).t.sum().backward()
    np.testing.assert_allclose(o_a.grad.numpy(), o_b.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert verts.grad is not None and np.isfinite(verts.grad.numpy()).all()
