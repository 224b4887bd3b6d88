"""Closest-point queries: the Ericson closest point, the exact BVH engine,
the dense binned engine (its candidate lists included) and the seeded
engine, against the JAX package and the float64 oracle; and the Morton
cluster order the binned engine sorts queries by.

Tolerances: both packages run the same float32 arithmetic, but XLA may
contract or reorder it, so distances agree within D_RTOL relative (a few
ulps) and D_ATOL absolute (a query on the surface); the supporting triangle
(``prim_id``) may differ only at a near-tie, where the two distances agree
anyway (equidistant triangles around a shared edge or vertex), at most
TIE_FRAC of the queries. ``found`` is equal except where a distance sits at
``max_dist`` within D_RTOL."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins as j_build_bins
from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.ops import closest_point as jcp
from rmcl_tpu.ops import order as jorder
from rmcl_tpu_torch.convert import bins_from_arrays, bvh_from_arrays
from rmcl_tpu_torch.ops import closest_point as tcp
from rmcl_tpu_torch.ops import order as torder
from rmcl_tpu_torch.ops.closest_cuda import (closest_bins, closest_bins_reference,
                                            ericson_vw_planes)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
from oracle import oracle_closest_point  # noqa: E402

torch.set_num_threads(2)

D_RTOL = 1e-5
D_ATOL = 1e-6
TIE_FRAC = 0.03
_BIN_FIELDS = ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb", "hyper_aabb")

MESHES = {
    "room": lambda: jm.make_room_scene(n_pillars=4, seed=3),
    "building": lambda: jm.make_building_scene(subdiv=4),
    "sphere_room": lambda: jm.make_sphere(24, 32, radius=5.0).concat(
        jm.make_room_scene(n_pillars=4, seed=3)),
}
_MAPS = {}


def _maps(name, bin_size=16, bps=8):
    """(mesh, JAX BVH, JAX bins, the port's BVH and bins carried across)."""
    key = (name, bin_size, bps)
    if key not in _MAPS:
        mesh = MESHES[name]()
        jb = j_build_bvh(mesh)
        jbins = j_build_bins(mesh, bin_size=bin_size, bins_per_super=bps)
        tb = bvh_from_arrays({f: np.asarray(getattr(jb, f)) for f in
                              ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")},
                             device="cpu")
        tbins = bins_from_arrays(
            {f: None if getattr(jbins, f) is None else np.asarray(getattr(jbins, f))
             for f in _BIN_FIELDS},
            bins_per_super=jbins.bins_per_super, bins_per_mid=jbins.bins_per_mid,
            supers_per_hyper=jbins.supers_per_hyper, device="cpu")
        _MAPS[key] = (mesh, jb, jbins, tb, tbins)
    return _MAPS[key]


def _queries(mesh, n=1500, seed=0, grow=0.1):
    lo, hi = mesh.aabb()
    c, h = (lo + hi) / 2, (hi - lo) / 2 * (1 + grow)
    return np.random.default_rng(seed).uniform(c - h, c + h, (n, 3)).astype(np.float32)


def _assert_cp_agree(j, t, max_dist=3.0e38):
    jf, tf = np.asarray(j.found), t.found.numpy()
    jd, td = np.asarray(j.dist), t.dist.numpy()
    at_edge = np.isclose(np.where(jf, jd, td), max_dist, rtol=D_RTOL)
    assert ((jf != tf) & ~at_edge).sum() == 0
    both = jf & tf
    assert both.any()
    np.testing.assert_allclose(td[both], jd[both], rtol=D_RTOL, atol=D_ATOL)
    same = np.asarray(j.prim_id)[both] == t.prim_id.numpy()[both]
    assert (~same).mean() <= TIE_FRAC
    np.testing.assert_allclose(t.point.numpy()[both][same], np.asarray(j.point)[both][same],
                               rtol=D_RTOL, atol=1e-5)
    np.testing.assert_allclose(t.normal.numpy()[both][same], np.asarray(j.normal)[both][same],
                               atol=1e-6)
    assert (t.prim_id.numpy()[~tf] == -1).all() and (t.dist.numpy()[~tf] == 3.0e38).all()


# Ericson's seven Voronoi regions of the triangle (0,0,0), (1,0,0), (0,1,0)
REGIONS = {
    "vertex_a": [-0.5, -0.5, 0.3],
    "vertex_b": [1.7, -0.2, -0.4],
    "vertex_c": [-0.2, 1.6, 0.2],
    "edge_ab": [0.4, -0.6, 0.5],
    "edge_ac": [-0.7, 0.3, -0.2],
    "edge_bc": [0.8, 0.8, 0.1],
    "face": [0.2, 0.3, 0.9],
}


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_closest_point_on_triangle_regions(region):
    rng = np.random.default_rng(1)
    # the region's point and small jitters around it, on a scaled copy too
    q = np.float32(REGIONS[region]) + rng.normal(scale=0.02, size=(64, 3)).astype(np.float32)
    for scale in (1.0, 37.0):
        v0 = np.zeros(3, np.float32)
        e1 = np.float32([scale, 0, 0])
        e2 = np.float32([0, scale, 0])
        qs = q * np.float32(scale)
        want = np.asarray(jcp.closest_point_on_triangle(
            jnp.asarray(qs), jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)))
        got = tcp.closest_point_on_triangle(torch.from_numpy(qs), torch.from_numpy(v0),
                                            torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
        np.testing.assert_allclose(got, want, rtol=D_RTOL, atol=1e-6 * scale)
        gold = oracle_closest_point(np.stack([v0, e1, e2]), np.array([[0, 1, 2]]), qs)
        np.testing.assert_allclose(got, gold["point"], rtol=1e-5, atol=1e-5 * scale)
    # the scalar-plane form of the kernels gives the same barycentrics
    z, o = np.zeros(64, np.float32), np.ones(64, np.float32)
    tri = (z, z, z, o, z, z, z, o, z)  # a, ab, ac of the unit triangle
    v, w = ericson_vw_planes(*torch.from_numpy(q).unbind(-1),
                             *(torch.from_numpy(x) for x in tri))
    jv, jw = jcp._ericson_vw_planes(*jnp.asarray(q).T, *(jnp.asarray(x) for x in tri))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("name,max_dist", [
    ("room", 3.0e38), ("building", 0.5), ("sphere_room", 3.0e38), ("sphere_room", 0.3),
])
def test_closest_points_matches_jax(name, max_dist):
    mesh, jb, _, tb, _ = _maps(name)
    q = _queries(mesh, seed=2)
    j = jcp.closest_points(jb, jnp.asarray(q), max_dist=max_dist)
    t = tcp.closest_points(tb, torch.from_numpy(q), max_dist=max_dist)
    _assert_cp_agree(j, t, max_dist)


def _j_candidates(jbins, q, max_d2, Rq, cs, cb):
    """The JAX package's candidate lists for blocks of Rq queries (padded
    with origin queries at max_d2 = 0, as closest_points_binned pads)."""
    n_pad = (-q.shape[0]) % Rq
    q = np.concatenate([q, np.zeros((n_pad, 3), np.float32)])
    max_d2 = np.concatenate([max_d2, np.zeros(n_pad, np.float32)])
    qb = q.reshape(-1, Rq, 3)
    d2cap = max_d2.reshape(-1, Rq).max(axis=1)
    cs = min(cs, jbins.n_super)
    cb = min(cb, jbins.n_bins, cs * jbins.bins_per_super)
    return [np.asarray(x) for x in jcp._cp_candidates(jbins, jnp.asarray(qb), jnp.asarray(d2cap),
                                                      cs, cb)]


@pytest.mark.parametrize("case", ["room", "padded_last_block", "super_ties", "building"])
def test_cp_candidates_match_jax(case):
    """Candidate lists equal, entry for entry: ids, counts and bounds.
    "super_ties" puts each block's box around the whole room, so every super
    lies at d2 = 0 and the super-level selection cuts between equal keys
    (ties go to the lower index)."""
    name = "building" if case == "building" else "room"
    bins_kw = dict(bin_size=4, bps=2) if case == "super_ties" else {}
    mesh, _, jbins, _, tbins = _maps(name, **bins_kw)
    n = 1000 if case == "padded_last_block" else 1024
    q = _queries(mesh, n=n, seed=3, grow=-0.1)
    if case == "super_ties":
        q = q[np.random.default_rng(0).permutation(n)]  # scattered blocks: wide boxes
    max_d2 = np.full(n, 0.25, np.float32)
    cs, cb = (3, 12) if case == "super_ties" else (8, 32)
    want = _j_candidates(jbins, q, max_d2, 128, cs, cb)
    qb, d2b, *got = tcp.binned_inputs(tbins, torch.from_numpy(q), torch.from_numpy(max_d2), 128,
                                      c_super=cs, c_bin=cb)
    assert qb.shape == (-(-n // 128), 128, 3)
    if case == "padded_last_block":
        assert (qb[-1, n % 128:] == 0).all() and (d2b[-1, n % 128:] == 0).all()
    if case == "super_ties":
        assert (got[1] > 0).all()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cp_candidates_float_key_path(monkeypatch):
    """The float top-k path (taken past 2^20 bins) selects the bins of the
    packed-key path, in the same nearest-first order, with untruncated
    bounds."""
    mesh, _, _, _, tbins = _maps("building")
    q = torch.from_numpy(_queries(mesh, n=1024, seed=5, grow=-0.1))
    qb = q.reshape(8, 128, 3)
    d2cap = torch.full((8,), 4.0)
    packed = tcp._cp_candidates(tbins, qb, d2cap, 8, 512)
    monkeypatch.setattr(tcp, "_PACKED_ID_BITS", 0)
    flt = tcp._cp_candidates(tbins, qb, d2cap, 8, 512)
    assert torch.equal(packed[1], flt[1])  # counts (no list is cut at this budget)
    for b in range(8):
        n = int(packed[1][b])
        assert set(packed[0][b, :n].tolist()) == set(flt[0][b, :n].tolist())
        assert (flt[2][b, 1:n] >= flt[2][b, :n - 1]).all()  # ascending bounds
        assert (flt[2][b, :n] >= packed[2][b, :n].sort().values).all()  # untruncated >= truncated


@pytest.mark.parametrize("name,max_dist,cluster", [
    ("room", 3.0e38, True), ("room", 0.5, False), ("building", 0.5, True),
    ("sphere_room", 1.0, True),
])
def test_closest_points_binned_matches_jax(name, max_dist, cluster):
    mesh, _, jbins, _, tbins = _maps(name)
    q = _queries(mesh, n=1000, seed=4)  # 1000 queries: a padded last block
    j = jcp.closest_points_binned(jbins, jnp.asarray(q), max_dist=max_dist, c_super=8, c_bin=64,
                                  cluster=cluster)
    t = tcp.closest_points_binned(tbins, torch.from_numpy(q), max_dist=max_dist, c_super=8,
                                  c_bin=64, cluster=cluster)
    _assert_cp_agree(j, t, max_dist)


def test_closest_bins_wrapper_takes_the_plain_version():
    mesh, _, _, _, tbins = _maps("room")
    q = torch.from_numpy(_queries(mesh, n=300, seed=6))
    inputs = tcp.binned_inputs(tbins, q, torch.full((300,), 0.25), 128, c_super=8, c_bin=32)
    before = closest_bins.launches
    for a, b in zip(closest_bins(tbins.tri, *inputs),
                    closest_bins_reference(tbins.tri, *inputs)):
        assert torch.equal(a, b)
    assert closest_bins.launches == before  # no kernel ran on the CPU
    with pytest.raises(TypeError):
        closest_bins(tbins.tri, inputs[0], inputs[1], inputs[2].long(), *inputs[3:])


@pytest.mark.parametrize("name,max_dist", [("sphere_room", 3.0e38), ("building", 0.5)])
def test_closest_points_seeded_matches_jax(name, max_dist):
    mesh, jb, jbins, tb, tbins = _maps(name)
    q = _queries(mesh, n=1000, seed=7)
    j = jcp.closest_points_seeded(jb, jbins, jnp.asarray(q), max_dist=max_dist, c_super=8,
                                  c_bin=64)
    t = tcp.closest_points_seeded(tb, tbins, torch.from_numpy(q), max_dist=max_dist, c_super=8,
                                  c_bin=64)
    _assert_cp_agree(j, t, max_dist)
    # exact: the seeded result is the plain exact walk's
    e = tcp.closest_points(tb, torch.from_numpy(q), max_dist=max_dist)
    assert torch.equal(e.found, t.found)
    torch.testing.assert_close(t.dist[t.found], e.dist[e.found], rtol=D_RTOL, atol=D_ATOL)


def test_closest_point_engines_match_oracle():
    """tests/test_oracle_parity.py's check on the port: the exact, binned
    and seeded engines against the float64 brute force on the room scene."""
    mesh = jm.make_room_scene((8.0, 6.0, 3.0), n_pillars=4, seed=11)
    jb, jbins = j_build_bvh(mesh), j_build_bins(mesh, bin_size=16)
    tb = bvh_from_arrays({f: np.asarray(getattr(jb, f)) for f in
                          ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")}, device="cpu")
    tbins = bins_from_arrays(
        {f: None if getattr(jbins, f) is None else np.asarray(getattr(jbins, f))
         for f in _BIN_FIELDS}, bins_per_super=jbins.bins_per_super,
        bins_per_mid=jbins.bins_per_mid, supers_per_hyper=jbins.supers_per_hyper, device="cpu")
    q = np.random.default_rng(7).uniform([-3.8, -2.8, 0.1], [3.8, 2.8, 2.9],
                                         (3000, 3)).astype(np.float32)
    gold = oracle_closest_point(mesh.vertices, mesh.faces, q)
    tq = torch.from_numpy(q)
    for tag, out in (("exact", tcp.closest_points(tb, tq)),
                     ("binned", tcp.closest_points_binned(tbins, tq, c_super=64, c_bin=512)),
                     ("seeded", tcp.closest_points_seeded(tb, tbins, tq, c_super=64,
                                                          c_bin=512))):
        assert out.found.all(), tag
        np.testing.assert_allclose(out.dist.numpy(), gold["dist"], rtol=1e-4, atol=2e-4,
                                   err_msg=tag)
        ep = out.point.numpy()
        tie = ~np.isclose(np.linalg.norm(ep - gold["point"], axis=1), 0.0, atol=1e-3)
        np.testing.assert_allclose(np.linalg.norm(ep - q, axis=1)[tie], gold["dist"][tie],
                                   rtol=1e-4, atol=2e-4, err_msg=tag)


@pytest.mark.parametrize("bits,headings", [(7, False), (8, False), (5, True)])
def test_cluster_order_matches_jax(bits, headings):
    rng = np.random.default_rng(8)
    p = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    p[:, 2] = 1.0  # a degenerate axis quantizes to 0
    h = rng.normal(size=(2000, 2)).astype(np.float32) if headings else None
    jk = np.asarray(jorder.morton_keys_3d(jnp.asarray(p), jnp.asarray(p.min(0)),
                                          jnp.asarray(p.max(0)), bits=bits))
    tk = torder.morton_keys_3d(torch.from_numpy(p), torch.from_numpy(p.min(0)),
                               torch.from_numpy(p.max(0)), bits=bits).numpy()
    np.testing.assert_array_equal(tk, jk)
    jo, ji = jorder.cluster_order(jnp.asarray(p), None if h is None else jnp.asarray(h),
                                  pos_bits=bits)
    to, ti = torder.cluster_order(torch.from_numpy(p), None if h is None else torch.from_numpy(h),
                                  pos_bits=bits)
    assert to.dtype == torch.int32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
