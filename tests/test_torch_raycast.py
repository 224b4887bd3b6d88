"""The exact BVH engine: ``cast_rays``, ``cast_ranges``, ``occluded`` and
``simulate`` on a BVH against the JAX package, against the float64 oracle,
and ``d t / d origin`` by autograd against ``jax.grad``.

Both packages walk the same BVH (the JAX slots carried across bit for bit)
with the same float32 arithmetic, but XLA may contract or reorder it, so:

- ``hit`` may differ only on grazing rays (an edge or vertex between two
  triangles, or a silhouette): fewer than GRAZE_FRAC of the rays;
- ``t`` agrees within T_RTOL relative where both hit (the re-derivation
  from the same plane, ulps apart);
- ``prim_id`` may differ only at a near-tie: where it differs, the two
  packages' t agree within T_RTOL (two triangles at one distance)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.ops import raycast as jr
from rmcl_tpu.sensors.models import SphericalModel as JSpherical
from rmcl_tpu.sensors.simulate import simulate as j_simulate
from rmcl_tpu.sensors.simulate import simulate_ranges as j_simulate_ranges
from rmcl_tpu_torch.bvh.types import SENTINEL_LINK
from rmcl_tpu_torch.convert import bvh_from_arrays
from rmcl_tpu_torch.math.se3 import Transform as TTransform
from rmcl_tpu_torch.ops import raycast as tr
from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, traverse_rays_reference
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical
from rmcl_tpu_torch.sensors.simulate import simulate as t_simulate
from rmcl_tpu_torch.sensors.simulate import simulate_ranges as t_simulate_ranges

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
from oracle import oracle_cast  # noqa: E402

torch.set_num_threads(2)

GRAZE_FRAC = 0.005
T_RTOL = 1e-5
T_ATOL = 1e-6  # t near 0 (a ray starting on a surface)
GRAD_RTOL = 1e-4  # gradients of t: the plane re-derivation's float32 quotient

MESHES = {
    "room": lambda: jm.make_room_scene(n_pillars=4, seed=3),
    "building": lambda: jm.make_building_scene(subdiv=4),
    "sphere": lambda: jm.make_sphere(24, 32, radius=5.0),
}
_BVHS = {}


def _bvhs(name):
    """(mesh, JAX BVH, the port's BVH carried across bit for bit)."""
    if name not in _BVHS:
        mesh = MESHES[name]()
        jb = j_build_bvh(mesh)
        arrays = {f: np.asarray(getattr(jb, f))
                  for f in ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")}
        _BVHS[name] = (mesh, jb, bvh_from_arrays(arrays, device="cpu"))
    return _BVHS[name]


def _rays(mesh, kind, n=3000, seed=0):
    """Scattered rays from inside the mesh's box, or a scan from its centre."""
    lo, hi = mesh.aabb()
    c, h = (lo + hi) / 2, (hi - lo) / 2
    rng = np.random.default_rng(seed)
    if kind == "scan":
        model = JSpherical.create(width=180, height=16, phi_min=-0.5, phi_max=0.5)
        o_s, d_s = model.rays()
        pose = JTransform.from_pose_tuple(jnp.asarray([*(c + 0.1 * h), 0.0, 0.0, 0.4]))
        return np.array(pose.apply(o_s)), np.array(pose.rotate(d_s))
    o = rng.uniform(c - 0.8 * h, c + 0.8 * h, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_hits_agree(jh, th):
    j_hit, t_hit = np.asarray(jh.hit), th.hit.numpy()
    assert (j_hit != t_hit).mean() < GRAZE_FRAC
    both = j_hit & t_hit
    assert both.sum() > 0.5 * j_hit.size  # the rays really hit geometry
    jt, tt = np.asarray(jh.t)[both], th.t.numpy()[both]
    np.testing.assert_allclose(tt, jt, rtol=T_RTOL, atol=T_ATOL)
    same = np.asarray(jh.prim_id)[both] == th.prim_id.numpy()[both]
    assert (~same).mean() < GRAZE_FRAC  # near-ties are rare; their t agree (above)
    np.testing.assert_allclose(th.point.numpy()[both][same], np.asarray(jh.point)[both][same],
                               rtol=T_RTOL, atol=1e-5)
    np.testing.assert_allclose(th.normal.numpy()[both][same], np.asarray(jh.normal)[both][same],
                               atol=1e-6)
    assert (th.prim_id.numpy()[~t_hit] == -1).all() and (th.t.numpy()[~t_hit] == 3.0e38).all()


@pytest.mark.parametrize("name,kind", [
    ("room", "scan"), ("room", "scattered"), ("building", "scattered"),
    ("building", "scan"), ("sphere", "scattered"),
])
def test_cast_rays_matches_jax(name, kind):
    mesh, jb, tb = _bvhs(name)
    o, d = _rays(mesh, kind)
    jh = jr.cast_rays(jb, jnp.asarray(o), jnp.asarray(d))
    th = tr.cast_rays(tb, torch.from_numpy(o), torch.from_numpy(d))
    _assert_hits_agree(jh, th)


def test_cast_rays_batch_shape_and_ranges():
    """Broadcast origins, a per-ray t_max, no normal flip; the range-only
    wrapper."""
    mesh, jb, tb = _bvhs("room")
    o, d = _rays(mesh, "scattered", n=600, seed=2)
    o3, d3 = o.reshape(20, 30, 3)[:, :1], d.reshape(20, 30, 3)
    t_max = np.random.default_rng(3).uniform(0.5, 6.0, (20, 30)).astype(np.float32)
    jh = jr.cast_rays(jb, jnp.asarray(o3), jnp.asarray(d3), t_min=0.1, t_max=jnp.asarray(t_max),
                      flip_normals=False)
    th = tr.cast_rays(tb, torch.from_numpy(o3), torch.from_numpy(d3), t_min=0.1,
                      t_max=torch.from_numpy(t_max), flip_normals=False)
    assert th.t.shape == (20, 30) and th.point.shape == (20, 30, 3)
    _assert_hits_agree(jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), jh),
                       tr.RayHits(**{k: v.reshape((-1,) + v.shape[2:])
                                     for k, v in vars(th).items()}))
    jt = np.asarray(jr.cast_ranges(jb, jnp.asarray(o), jnp.asarray(d), 0.0, 4.0))
    tt = tr.cast_ranges(tb, torch.from_numpy(o), torch.from_numpy(d), 0.0, 4.0).numpy()
    both = (jt < 3e38) & (tt < 3e38)
    assert ((jt < 3e38) != (tt < 3e38)).mean() < GRAZE_FRAC
    np.testing.assert_allclose(tt[both], jt[both], rtol=T_RTOL, atol=T_ATOL)


def test_occluded_matches_jax():
    """Segments between scattered points, with zero-length and sub-2-eps
    segments, which the entry rule (t_max <= t_min) never blocks."""
    mesh, jb, tb = _bvhs("building")
    lo, hi = mesh.aabb()
    rng = np.random.default_rng(4)
    a = rng.uniform(lo, hi, (2000, 3)).astype(np.float32)
    b = rng.uniform(lo, hi, (2000, 3)).astype(np.float32)
    b[:100] = a[:100]  # zero length
    b[100:200] = a[100:200] + np.float32(5e-4)  # shorter than 2 * eps
    jo = np.asarray(jr.occluded(jb, jnp.asarray(a), jnp.asarray(b)))
    to = tr.occluded(tb, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert not to[:200].any() and not jo[:200].any()
    assert (jo != to).mean() < GRAZE_FRAC
    assert 0.1 < to.mean() < 0.9  # both outcomes occur


def test_traverse_plain_version_matches_jax_loop():
    """The K5 plain version against the JAX loop it ports
    (``_traverse_batch``), and its visit counts: none for a ray whose
    segment is empty, and a leaf visit for every hit."""
    mesh, jb, tb = _bvhs("building")
    o, d = _rays(mesh, "scattered", n=2000, seed=6)
    t_min = np.zeros(2000, np.float32)
    t_max = np.full(2000, 3.0e38, np.float32)
    t_max[::5] = 0.0
    jt, js, jcur = jr._traverse_batch(jb.nodes, jb.root_link, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_min), jnp.asarray(t_max))
    assert (np.asarray(jcur) == int(SENTINEL_LINK)).all()
    args = [torch.from_numpy(x) for x in (o, d, t_min, t_max)]
    tt, ts, visits = traverse_rays(tb.nodes, tb.root_link, *args, visits=True)
    t2, s2 = traverse_rays_reference(tb.nodes, tb.root_link, *args)
    assert torch.equal(tt, t2) and torch.equal(ts, s2)  # the wrapper takes the plain version
    js = np.asarray(js)
    assert ((js >= 0) != (ts.numpy() >= 0)).mean() < GRAZE_FRAC
    both = (js >= 0) & (ts.numpy() >= 0)
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(jt)[both], rtol=T_RTOL)
    v = visits.numpy()
    assert (v[::5] == 0).all()
    assert (v[ts.numpy() >= 0, 1] >= 1).all() and (v[1::5, 0] >= 1).all()
    assert v.sum(axis=1).max() <= tb.n_slots


def test_exact_engine_matches_oracle():
    """The oracle check of tests/test_oracle_parity.py on the port: tracking
    scan rays and scattered rays on the room scene against the float64
    brute force (rays that graze an edge may flip, < 0.5%)."""
    mesh = jm.make_room_scene((8.0, 6.0, 3.0), n_pillars=4, seed=11)
    _, _, tb = (None, None, bvh_from_arrays(
        {f: np.asarray(getattr(j_build_bvh(mesh), f))
         for f in ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")}, device="cpu"))
    model = JSpherical.create(width=180, height=6, phi_min=-0.3, phi_max=0.25, range_max=30.0)
    o_s, d_s = model.rays()
    O, D = [], []
    for k in range(6):
        pose = JTransform.from_pose_tuple(jnp.asarray(
            [0.3 * k - 0.8, 0.2 * ((-1) ** k), 1.0 + 0.05 * k, 0.0, 0.0, 0.4 * k]))
        O.append(np.asarray(pose.apply(o_s)))
        D.append(np.asarray(pose.rotate(d_s)))
    rng = np.random.default_rng(3)
    os_ = rng.uniform([-3.5, -2.5, 0.3], [3.5, 2.5, 2.5], (2000, 3))
    ds_ = rng.normal(size=(2000, 3))
    ds_ /= np.linalg.norm(ds_, axis=1, keepdims=True)
    o = np.concatenate(O + [os_]).astype(np.float32)
    d = np.concatenate(D + [ds_]).astype(np.float32)
    gold = oracle_cast(mesh.vertices, mesh.faces, o, d)
    th = tr.cast_rays(tb, torch.from_numpy(o), torch.from_numpy(d))
    eh, et, en = th.hit.numpy(), th.t.numpy(), th.normal.numpy()
    gh, gt, gn = gold["hit"], gold["t"], gold["normal"]
    both = eh & gh
    bad = (eh != gh) | (both & ~np.isclose(et, gt, rtol=1e-4, atol=2e-4))
    assert bad.mean() < 0.005
    good = both & ~bad
    assert np.percentile(np.abs(np.sum(en[good] * gn[good], axis=-1)), 1) > 0.999


def test_t_gradient_matches_jax():
    """d t / d origin and d t / d direction through the plane
    re-derivation: autograd against jax.grad, on rays that hit."""
    mesh, jb, tb = _bvhs("room")
    o, d = _rays(mesh, "scattered", n=500, seed=8)

    def j_loss(oo, dd):
        h = jr.cast_rays(jb, oo, dd)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    jgo, jgd = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    to = torch.from_numpy(o).requires_grad_(True)
    td = torch.from_numpy(d).requires_grad_(True)
    h = tr.cast_rays(tb, to, td)
    torch.where(h.hit, h.t, 0.0).sum().backward()
    hit = h.hit.numpy() & np.asarray(jr.cast_rays(jb, jnp.asarray(o), jnp.asarray(d)).hit)
    assert hit.mean() > 0.9
    np.testing.assert_allclose(to.grad.numpy()[hit], np.asarray(jgo)[hit], rtol=GRAD_RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(td.grad.numpy()[hit], np.asarray(jgd)[hit], rtol=GRAD_RTOL,
                               atol=1e-4)
    assert (to.grad.numpy()[~h.hit.numpy()] == 0).all()


def test_simulate_on_bvh_matches_jax():
    """simulate and simulate_ranges dispatch a BVH to the exact engine;
    points and normals come back in the sensor frame, batched over poses."""
    mesh, jb, tb = _bvhs("room")
    kw = dict(width=90, height=8, phi_min=-0.4, phi_max=0.3, range_max=30.0)
    poses = [[0.5, -0.3, 1.0, 0.0, 0.0, 0.3], [-1.0, 1.0, 1.5, 0.0, 0.1, -0.5]]
    jt = JTransform.from_pose_tuple(jnp.asarray(poses))
    tt = TTransform.from_pose_tuple(poses, device="cpu")
    jh = j_simulate(jb, JSpherical.create(**kw), jt)
    th = t_simulate(tb, TSpherical.create(**kw), tt)
    assert th.hit.shape == (2, 720)
    _assert_hits_agree(jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), jh),
                       tr.RayHits(**{k: v.reshape((-1,) + v.shape[2:])
                                     for k, v in vars(th).items()}))
    jr_ = np.asarray(j_simulate_ranges(jb, JSpherical.create(**kw), jt, miss_value=-1.0))
    tr_ = t_simulate_ranges(tb, TSpherical.create(**kw), tt, miss_value=-1.0).numpy()
    ok = (jr_ >= 0) & (tr_ >= 0)
    np.testing.assert_allclose(tr_[ok], jr_[ok], rtol=T_RTOL)
    assert ((jr_ < 0) != (tr_ < 0)).mean() < GRAZE_FRAC
    with pytest.raises(TypeError):
        t_simulate(object(), TSpherical.create(**kw), tt)


# --- cast_rays_seeded: the dense seed (K3 + K1, lossless flags) and K5 ---

def _seed_bins(name, S=16):
    """The mesh's triangle bins (bins of 8, S a super, mids of 4) in both
    packages."""
    from rmcl_tpu.bvh.bins import build_bins as j_build_bins
    from rmcl_tpu_torch.convert import bins_from_arrays

    jb = j_build_bins(MESHES[name](), bin_size=8, bins_per_super=S, bins_per_mid=4)
    tb = bins_from_arrays({f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
                           for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                                     "mid_aabb", "hyper_aabb")},
                          bins_per_super=jb.bins_per_super, bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    return jb, tb


@pytest.mark.parametrize("name,kind,kw", [
    ("building", "scan", dict()),  # small budgets: most rays uncertified, walked
    ("building", "scan", dict(c_super=40, c_bin=600)),  # budgets past the map: all certified
    ("building", "scattered", dict(c_mid=8)),
    ("room", "scattered", dict(sort=False)),
])
def test_cast_rays_seeded_matches_jax(name, kind, kw):
    from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned

    mesh, jbvh, tbvh = _bvhs(name)
    jbins, tbins = _seed_bins(name)
    o, d = _rays(mesh, kind)
    jh = jr.cast_rays_seeded(jbvh, jbins, jnp.asarray(o), jnp.asarray(d), t_max=20.0, **kw)
    th = tr.cast_rays_seeded(tbvh, tbins, torch.from_numpy(o), torch.from_numpy(d), t_max=20.0,
                             **kw)
    _assert_hits_agree(jh, th)
    # and the exact engine's result: the seed changes which rays are walked,
    # not what they hit
    ex = tr.cast_rays(tbvh, torch.from_numpy(o), torch.from_numpy(d), t_max=20.0)
    assert torch.equal(th.hit, ex.hit)
    torch.testing.assert_close(th.t, ex.t, rtol=T_RTOL, atol=T_ATOL)
    dense = {k: v for k, v in kw.items() if k != "sort"}
    _, certified = cast_rays_binned(tbins, torch.from_numpy(o), torch.from_numpy(d), t_max=20.0,
                                    with_lossless=True, **dense)
    if "c_bin" in kw:
        assert bool(certified.all())
    elif name == "building" and not dense:
        assert float(certified.float().mean()) < 0.5


def test_cast_rays_seeded_sort_changes_nothing():
    mesh, _, tbvh = _bvhs("building")
    _, tbins = _seed_bins("building")
    o, d = (torch.from_numpy(x) for x in _rays(mesh, "scattered"))
    a = tr.cast_rays_seeded(tbvh, tbins, o, d, t_max=20.0)
    b = tr.cast_rays_seeded(tbvh, tbins, o, d, t_max=20.0, sort=False)
    for f in ("t", "hit", "prim_id", "inst_id", "point", "normal"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    o3, d3 = o[:300].reshape(3, 100, 3), d[:300].reshape(3, 100, 3)
    h3 = tr.cast_rays_seeded(tbvh, tbins, o3, d3, t_max=20.0)
    assert h3.t.shape == (3, 100) and h3.normal.shape == (3, 100, 3)
