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
from rmcl_tpu_torch.ops import closest_cuda
from rmcl_tpu_torch.ops.closest_cuda import (closest_bins, closest_bins_reference, cp_launch_plan,
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


def _j_candidates(jbins, q, max_d2, Rq, cs, cb, pad=None):
    """The JAX package's candidate lists for blocks of Rq queries, the last
    padded with origin queries at max_d2 = 0 as its closest_points_binned
    pads, or with ``pad`` (a query) at max_d2 = 0."""
    n_pad = (-q.shape[0]) % Rq
    fill = np.zeros((n_pad, 3), np.float32) if pad is None else np.tile(pad, (n_pad, 1))
    q = np.concatenate([q, fill])
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
    (ties go to the lower index). The port's intended difference: it pads
    the last block with copies of the last query where the JAX package pads
    with origin queries, so that block's list is JAX's list of the block
    padded the port's way (JAX's own differs where the origin widens the
    block's box: not here, where every block spans the room).""" 
    name = "building" if case == "building" else "room"
    bins_kw = dict(bin_size=4, bps=2) if case == "super_ties" else {}
    mesh, _, jbins, _, tbins = _maps(name, **bins_kw)
    n = 1000 if case == "padded_last_block" else 1024
    q = _queries(mesh, n=n, seed=3, grow=-0.1)
    if case == "super_ties":
        q = q[np.random.default_rng(0).permutation(n)]  # scattered blocks: wide boxes
    max_d2 = np.full(n, 0.25, np.float32)
    cs, cb = (3, 12) if case == "super_ties" else (8, 32)
    want = _j_candidates(jbins, q, max_d2, 128, cs, cb, pad=q[-1])
    qb, d2b, *got = tcp.binned_inputs(tbins, torch.from_numpy(q), torch.from_numpy(max_d2), 128,
                                      c_super=cs, c_bin=cb)
    assert qb.shape == (-(-n // 128), 128, 3)
    if case == "padded_last_block":
        assert (qb[-1, n % 128:] == torch.from_numpy(q[-1])).all()
        assert (d2b[-1, n % 128:] == 0).all()
        jax_own = _j_candidates(jbins, q, max_d2, 128, cs, cb)
        for w, g in zip(jax_own, got):  # the blocks of real queries alone agree
            np.testing.assert_array_equal(g[:-1].numpy(), w[:-1])
    if case == "super_ties":
        assert (got[1] > 0).all()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def _brute_cull(bins, qb, d2cap, cs, cb):
    """Per block, in numpy float32 apart from the port's code: the supers
    and the bins within the block's bound of its query box (the needs), and
    whether the budgets cut its list: more supers pass than cs keeps, or
    more bins of the cs nearest passing supers (by d2, then index) than cb
    keeps."""
    def d2(lo, hi, boxes):
        g = np.maximum(np.maximum(boxes[:, :3] - hi, lo - boxes[:, 3:]), np.float32(0))
        g = g * g
        return (g[:, 0] + g[:, 1]) + g[:, 2]

    sup, box = bins.super_aabb.numpy(), bins.bin_aabb.numpy()
    S, n_bins = bins.bins_per_super, bins.n_bins
    need_s, need_b, sat = [], [], []
    for blk, cap in zip(qb.numpy(), d2cap.numpy()):
        lo, hi = blk.min(0), blk.max(0)
        ds, db = d2(lo, hi, sup), d2(lo, hi, box)
        ok = np.flatnonzero(ds <= cap)
        kept = ok[np.lexsort((ok, ds[ok]))][:cs]
        gbin = (kept[:, None] * S + np.arange(S)).reshape(-1)
        gbin = gbin[gbin < n_bins]
        need_s.append(ok.size)
        need_b.append(int((db <= cap).sum()))
        sat.append(ok.size > cs or int((db[gbin] <= cap).sum()) > cb)
    return np.asarray(need_s), np.asarray(need_b), np.asarray(sat)


@pytest.mark.parametrize("budgets", ["whole", "supers_cut", "bins_cut", "both_cut", "one_each"])
def test_cp_sat_matches_a_brute_force_count(budgets):
    """K7's plain version flags exactly the blocks a brute-force count
    finds cut, at budgets that cut no block (the widest block's needs),
    one short of them and one entry a level; the needs
    (utils/tune.py::cp_block_need) are the brute-force counts. 1000
    clustered queries: the last block is padded (with copies of the last
    query at max_d2 = 0), its box that of its real queries."""
    from rmcl_tpu_torch.utils.tune import cp_block_need

    mesh, _, _, _, tbins = _maps("building")
    q = torch.from_numpy(_queries(mesh, n=1000, seed=8, grow=-0.1))
    q = q[torder.cluster_order(q, None)[0].long()]
    qb, d2b = tcp.query_blocks(q, torch.full((1000,), 0.25), 128)
    assert torch.equal(qb[-1].amin(0), q[896:].amin(0))
    assert torch.equal(qb[-1].amax(0), q[896:].amax(0)) and (d2b[-1, 1000 % 128:] == 0).all()
    d2cap = torch.amax(d2b, dim=1)
    need_s, need_b, _ = _brute_cull(tbins, qb, d2cap, tbins.n_super, tbins.n_bins)
    got_s, got_b = cp_block_need(tbins, qb, d2b)
    np.testing.assert_array_equal(got_s.numpy(), need_s)
    np.testing.assert_array_equal(got_b.numpy(), need_b)
    cs, cb = {"whole": (need_s.max(), need_b.max()), "supers_cut": (need_s.max() - 1, need_b.max()),
              "bins_cut": (need_s.max(), need_b.max() - 1),
              "both_cut": (need_s.max() - 1, need_b.max() - 1), "one_each": (1, 1)}[budgets]
    cs, cb = tcp.cp_budgets(tbins, int(cs), int(cb))
    *lists, sat = tcp._cp_candidates(tbins, qb, d2cap, cs, cb)
    want = _brute_cull(tbins, qb, d2cap, cs, cb)[2]
    np.testing.assert_array_equal(sat.numpy(), want)
    assert sat.any() == (budgets != "whole")
    assert (lists[1].numpy() == np.minimum(need_b, cb))[~want].all()


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
def test_closest_points_binned_matches_jax(name, max_dist, cluster, monkeypatch):
    """The port's result is JAX's where both pad the last query block with
    origin queries, as the JAX package does. The port's own padding (copies
    of the last query) keeps that block's box to its real queries, so it
    truncates no block that the origin padding leaves whole; where it
    truncates none, its result is the exact engine's."""
    mesh, _, jbins, tb, tbins = _maps(name)
    q = _queries(mesh, n=1000, seed=4)  # 1000 queries: a padded last block
    j = jcp.closest_points_binned(jbins, jnp.asarray(q), max_dist=max_dist, c_super=8, c_bin=64,
                                  cluster=cluster)
    t, sat = tcp.closest_points_binned(tbins, torch.from_numpy(q), max_dist=max_dist, c_super=8,
                                       c_bin=64, cluster=cluster, with_sat=True)
    if not sat.any():
        e = tcp.closest_points(tb, torch.from_numpy(q), max_dist=max_dist)
        assert torch.equal(e.found, t.found)
        torch.testing.assert_close(t.dist[t.found], e.dist[e.found], rtol=D_RTOL, atol=D_ATOL)

    def jax_padding(q, max_d2, block_size=128):
        n_pad = (-q.shape[0]) % block_size
        q = torch.cat([q, q.new_zeros((n_pad, 3))])
        max_d2 = torch.cat([max_d2, max_d2.new_zeros((n_pad,))])
        return q.reshape(-1, block_size, 3), max_d2.reshape(-1, block_size)

    monkeypatch.setattr(tcp, "query_blocks", jax_padding)
    t_jax, sat_jax = tcp.closest_points_binned(tbins, torch.from_numpy(q), max_dist=max_dist,
                                               c_super=8, c_bin=64, cluster=cluster,
                                               with_sat=True)
    _assert_cp_agree(j, t_jax, max_dist)
    # the port's padding never truncates a block that the origin's leaves whole
    assert not (sat & ~sat_jax).any()


def test_closest_bins_wrapper_takes_the_plain_version():
    mesh, _, _, _, tbins = _maps("room")
    q = torch.from_numpy(_queries(mesh, n=300, seed=6))
    inputs = tcp.binned_inputs(tbins, q, torch.full((300,), 0.25), 128, c_super=8,
                               c_bin=32)[:5]
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


# --- the closest-point kernels' redesign: the region-first Ericson point,
# the split walk over the BVH (K6) and the lane-group rule ---

_F = np.float32


def _ericson_region_first(q, a, ab, ac):
    """The kernels' Ericson point (csrc/ericson.cuh) as a scalar float32
    model: the region first, then only its own quotients, in the kernel's
    branch order (vertex, then bc, ac, ab, else the face)."""
    def dot(u, w):
        return u[0] * w[0] + u[1] * w[1] + u[2] * w[2]

    def safe_div(x, y):
        return x / (y if abs(y) > _F(1e-30) else _F(1e-30))

    def clip01(x):
        return min(max(x, _F(0)), _F(1))

    ap = [q[k] - a[k] for k in range(3)]
    bp = [ap[k] - ab[k] for k in range(3)]
    cp = [ap[k] - ac[k] for k in range(3)]
    d1, d2, d3, d4 = dot(ab, ap), dot(ac, ap), dot(ab, bp), dot(ac, bp)
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    in_a = d1 <= 0 and d2 <= 0
    in_b = d3 >= 0 and d4 <= d3
    in_c = d6 >= 0 and d5 <= d6
    if in_a or in_b or in_c:
        return (_F(0) if in_a or in_c else _F(1)), (_F(0) if in_a or in_b else _F(1)), "vertex"
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        t = clip01(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)))
        return _F(1) - t, t, "bc"
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        return _F(0), clip01(safe_div(d2, d2 - d6)), "ac"
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        return clip01(safe_div(d1, d1 - d3)), _F(0), "ab"
    denom = max(va + vb + vc, _F(1e-30))
    return vb / denom, vc / denom, "face"


def test_region_first_ericson_equals_the_plain_selects():
    """The kernels divide only for the region they take; the plain version
    forms all five quotients and selects. Bitwise equal on random
    triangles and on degenerate ones where several region flags hold at
    once (zero edges, collinear vertices, queries on vertices, edges and the
    face)."""
    rng = np.random.default_rng(21)
    cases = []
    for _ in range(1500):
        a, ab, ac = (rng.normal(size=3).astype(_F) for _ in range(3))
        cases.append((rng.normal(scale=1.5, size=3).astype(_F), a, ab, ac))
    z = np.zeros(3, _F)
    for _ in range(60):
        a, ab = rng.normal(size=3).astype(_F), rng.normal(size=3).astype(_F)
        q = rng.normal(size=3).astype(_F)
        for tri in ((a, z, z), (a, ab, z), (a, z, ab), (a, ab, ab * _F(2)), (a, ab, -ab),
                    (a, ab, ab)):
            b, c = tri[0] + tri[1], tri[0] + tri[2]
            for qq in (q, tri[0], b, c, (tri[0] + b) * _F(0.5), (b + c) * _F(0.5),
                       (tri[0] + b + c) / _F(3)):
                cases.append((qq.astype(_F), *tri))
    q, a, ab, ac = (np.stack([c[k] for c in cases]) for k in range(4))
    with np.errstate(all="ignore"):
        model = [_ericson_region_first(*c) for c in cases]
    v, w = ericson_vw_planes(*(torch.from_numpy(x[:, k].copy()) for x in (q, a, ab, ac)
                               for k in range(3)))
    np.testing.assert_array_equal(np.array([m[0] for m in model], _F).view(np.int32),
                                  v.numpy().view(np.int32))
    np.testing.assert_array_equal(np.array([m[1] for m in model], _F).view(np.int32),
                                  w.numpy().view(np.int32))
    regions = {m[2] for m in model}
    assert regions == {"vertex", "ab", "ac", "bc", "face"}
    # degenerate triangles where several flags hold at once: a zero triangle
    # is at every vertex (in_a, in_b and in_c)
    assert _ericson_region_first(a[0], a[0], z, z)[:2] == (_F(0), _F(0))


def _far_leaf_mesh():
    """Four triangles near the origin and one far away: the BVH's first
    split isolates the far one, a leaf above any split depth > 1."""
    from rmcl_tpu.geom.mesh import TriangleMesh

    rng = np.random.default_rng(5)
    v = np.concatenate([rng.uniform(0, 1, (12, 3)), rng.uniform(40, 41, (3, 3))])
    return TriangleMesh(v.astype(np.float32), np.arange(15, dtype=np.int32).reshape(5, 3))


SPLIT_MESHES = dict(MESHES, far_leaf=_far_leaf_mesh)


def _split_maps(name):
    if name == "far_leaf":
        jb = j_build_bvh(_far_leaf_mesh())
        tb = bvh_from_arrays({f: np.asarray(getattr(jb, f)) for f in
                              ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")},
                             device="cpu")
        return _far_leaf_mesh(), tb
    mesh, _, _, tb, _ = _maps(name)
    return mesh, tb


def _leaf_slots(tb):
    """Which slots hold leaves, from the links (a preorder walk)."""
    ni = tb.nodes.view(torch.int32)
    leaf = torch.zeros(tb.n_slots, dtype=torch.bool)
    stack = [int(tb.root_link)]
    while stack:
        link = stack.pop()
        if link < 0:
            leaf[~link] = True
            continue
        first = int(ni[link, 12])
        stack += [first, int(ni[~first if first < 0 else first, 13])]
    return leaf


def test_split_frontier_covers_the_bvh_in_preorder():
    """Lane p's subtree is the slot range [start, end); the lanes' ranges
    follow each other in preorder, hold every leaf once, and skip only the
    internal nodes above the frontier (at most P - 1); a leaf above the
    frontier's depth goes to one lane and leaves the others empty."""
    from rmcl_tpu_torch.ops.closest_cuda import split_frontier

    for name in ("room", "building", "far_leaf"):
        _, tb = _split_maps(name)
        leaf = _leaf_slots(tb)
        for P in (2, 4, 8):
            start, end = (x.tolist() for x in split_frontier(tb.nodes, tb.root_link, P))
            slot = lambda link: tb.n_slots if link == -2**31 else (~link if link < 0 else link)
            covered = torch.zeros(tb.n_slots, dtype=torch.int32)
            pos = 0
            for s, e in zip(start, end):
                if s == e:
                    continue
                assert pos <= slot(s) < slot(e)
                covered[slot(s):slot(e)] += 1
                pos = slot(e)
            assert covered.max() == 1 and bool(covered[leaf].all())
            assert not bool(leaf[covered == 0].any()) and int((covered == 0).sum()) <= P - 1
            if name == "far_leaf":
                assert any(s < 0 and s != -2**31 for s in start)  # the far leaf starts a lane
                assert P == 2 or any(s == e for s, e in zip(start, end))  # and empties others


def _tie_queries(mesh, n, seed):
    rng = np.random.default_rng(seed)
    v = mesh.vertices.astype(_F)
    f = mesh.faces[rng.integers(0, mesh.faces.shape[0], n)]
    return np.concatenate([v[rng.integers(0, v.shape[0], n)],
                           (v[f[:, 0]] + v[f[:, 1]]) * _F(0.5)])


def _leaf_and_box_d2(tb, q):
    """Per query, every leaf's d2 (the kernels' arithmetic) and the largest
    box d2 over its ancestors: (leaf slots, d2 (n_q, L), ancestor box max)."""
    ni = tb.nodes.view(torch.int32)
    nf = tb.nodes
    n = tb.n_slots
    qt = torch.from_numpy(q)
    anc = torch.zeros((q.shape[0], n))
    is_leaf = torch.zeros(n, dtype=torch.bool)
    root = int(tb.root_link)
    stack = [root]
    while stack:
        link = stack.pop()
        s = ~link if link < 0 else link
        if link < 0:
            is_leaf[s] = True
            continue
        box = nf[s]
        c = torch.clamp(qt, min=box[0:3], max=box[3:6]) - qt
        d2_box = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
        first = int(ni[s, 12])
        second = int(ni[~first if first < 0 else first, 13])
        for child in (first, second):
            cs = ~child if child < 0 else child
            anc[:, cs] = torch.maximum(anc[:, s], d2_box)
            stack.append(child)
    leaves = torch.nonzero(is_leaf).squeeze(1)
    w = nf[leaves]
    qx, qy, qz = (qt[:, k:k + 1] for k in range(3))
    ax, ay, az, abx, aby, abz, acx, acy, acz = (w[None, :, k] for k in range(9))
    v, ww = ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz)
    ex, ey, ez = (qx - (ax + v * abx + ww * acx), qy - (ay + v * aby + ww * acy),
                  qz - (az + v * abz + ww * acz))
    return leaves, ex * ex + ey * ey + ez * ez, anc[:, leaves]


@pytest.mark.parametrize("max_dist", [0.25, 2.0, 3.0e38])
@pytest.mark.parametrize("name", ["room", "sphere_room", "building", "far_leaf"])
def test_split_walk_returns_the_serial_winner(name, max_dist):
    """The plain split walk (P = 2, 4, 8) against the serial walk (P = 1),
    on scattered queries and on queries on vertices and edge midpoints,
    where several leaves tie at the least d2 (the test asserts they do).
    best_d2, point and slot are bitwise equal on every query but those
    where float rounding puts a leaf's d2 below one of its ancestors'
    box d2 near the minimum: there a walk can prune a slightly nearer
    leaf, so the two winners' distances agree within D_RTOL / D_ATOL. No
    more than 1% of the queries are such, and every mismatch is one."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh_reference

    mesh, tb = _split_maps(name)
    q = np.concatenate([_queries(mesh, n=1000, seed=12), _tie_queries(mesh, 300, 13)])
    qt = torch.from_numpy(q)
    max_d2 = torch.full((q.shape[0],), _F(max_dist)) ** 2
    serial = closest_bvh_reference(tb.nodes, tb.root_link, qt, max_d2, visits=True)
    leaves, d2, anc = _leaf_and_box_d2(tb, q)
    d2 = torch.where(d2 < max_d2[:, None], d2, torch.inf)
    least = d2.min(dim=1, keepdim=True).values
    ties = (torch.isfinite(least[:, 0]) & ((d2 == least).sum(1) > 1))
    if name != "far_leaf":
        assert int(ties[1000:].sum()) >= 20  # vertex and edge queries tie
    for P in (2, 4, 8):
        split = closest_bvh_reference(tb.nodes, tb.root_link, qt, max_d2, visits=True, split=P)
        same = (split[2] == serial[2]) & (split[0] == serial[0])
        assert torch.equal(same, (split[1] == serial[1]).all(1) & same)
        off = ~same
        hi = torch.maximum(split[0], serial[0])[:, None]
        skewed = ((anc > d2) & (d2 <= hi)).any(1)  # the rounding the walks disagree at
        assert bool(skewed[off].all())
        assert float(off.float().mean()) <= 0.01
        torch.testing.assert_close(split[0][off].sqrt(), serial[0][off].sqrt(), rtol=D_RTOL,
                                   atol=D_ATOL)
        assert bool((split[2][ties & same] == serial[2][ties & same]).all())
        # the split walk visits every query's subtrees: its visits are its own
        assert torch.equal(split[3].sum(1) > 0, serial[3].sum(1) > 0)


@pytest.mark.parametrize("split", [1, 2, 8])
def test_closest_points_at_each_split_match_jax(monkeypatch, split):
    """closest_points with the walk forced to P lanes a query (the wrapper
    takes walk_split's choice) against JAX's closest_points."""
    from rmcl_tpu_torch.ops import closest_cuda

    monkeypatch.setattr(tcp, "walk_split", lambda n, device=None: split)
    monkeypatch.setattr(closest_cuda, "walk_split", lambda n, device=None: split)
    mesh, jb, _, tb, _ = _maps("sphere_room")
    q = _queries(mesh, n=1500, seed=14)
    for max_dist in (0.3, 3.0e38):
        j = jcp.closest_points(jb, jnp.asarray(q), max_dist=max_dist)
        t = tcp.closest_points(tb, torch.from_numpy(q), max_dist=max_dist)
        _assert_cp_agree(j, t, max_dist)


def test_closest_bvh_wrapper_takes_the_split_plain_version():
    """On CPU tensors the wrapper runs the plain version at the split it
    would launch (walk_split of the query count), visits included."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh, closest_bvh_reference, walk_split

    mesh, tb = _split_maps("room")
    q = torch.from_numpy(_queries(mesh, n=700, seed=16))
    max_d2 = torch.full((700,), 4.0)
    P = walk_split(700)
    assert P == 8
    before = closest_bvh.launches
    got = closest_bvh(tb.nodes, tb.root_link, q, max_d2, visits=True)
    for a, b in zip(got, closest_bvh_reference(tb.nodes, tb.root_link, q, max_d2, visits=True,
                                               split=P)):
        assert torch.equal(a, b)
    assert closest_bvh.launches == before
    with pytest.raises(ValueError):
        closest_bvh(tb.nodes, tb.root_link, q, max_d2, split=3)


def test_closest_points_fixes_the_split_for_the_whole_batch(monkeypatch):
    """closest_points takes walk_split of the whole batch once and walks
    every CPU chunk at it, so the chunks give what one launch of all the
    queries gives. On a card of 2048 threads 700 queries take P = 2, a
    chunk of 100 alone would take P = 8."""
    from rmcl_tpu_torch.ops import closest_cuda
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh_reference, walk_split

    monkeypatch.setattr(closest_cuda, "_H100_THREADS", 2048)
    assert (walk_split(700), walk_split(100)) == (2, 8)
    splits = []

    def spy(*args, split=None, **kw):
        splits.append(split)
        return closest_cuda.closest_bvh(*args, split=split, **kw)

    monkeypatch.setattr(tcp, "closest_bvh", spy)
    mesh, tb = _split_maps("room")
    q = np.concatenate([_queries(mesh, n=400, seed=17), _tie_queries(mesh, 150, 18)])
    got = tcp.closest_points(tb, torch.from_numpy(q), max_dist=2.0, chunk_size=100)
    assert splits == [2] * 7
    d2, point, slot = closest_bvh_reference(tb.nodes, tb.root_link, torch.from_numpy(q),
                                            torch.full((700,), _F(2.0)) ** 2, split=2)
    assert torch.equal(got.prim_id >= 0, slot >= 0) and bool(got.found.any())
    assert torch.equal(got.dist[got.found], d2[slot >= 0].sqrt())
    assert torch.equal(got.point[got.found], point[slot >= 0])
    leaf_prim = tb.nodes.view(torch.int32)[slot[slot >= 0].long(), 12]
    assert torch.equal(got.prim_id[got.found], leaf_prim)


def test_fill_threads_off_the_card_is_an_h100s():
    """Off the card the launch-shape rules count an H100's resident
    threads (132 SMs x 2048), so the plain version takes the card's split."""
    from rmcl_tpu_torch.ops.closest_cuda import fill_threads

    assert fill_threads() == fill_threads("cpu") == 132 * 2048


@pytest.mark.parametrize("n_queries,limit,block,least,want", [
    (50000, 8, None, 1, 4),
    (3000, 4, 128, 1, 4),  # B = 4 caps the lanes
    (100, 32, 1024, 1, 1),  # a 1024-query CTA has no room for more lanes
    (100, 32, 1024, 2, 1),  # nor for the least asked
    (10 ** 7, 8, 128, 2, 2),  # a full card still takes the least
    (10 ** 7, 1, 128, 2, 1),  # bins of one triangle: one lane
])
def test_lane_groups_rule(n_queries, limit, block, least, want):
    from rmcl_tpu_torch.ops.closest_cuda import lane_groups

    G = lane_groups(n_queries, limit, block=block, least=least)
    assert G == want
    assert n_queries * G <= 132 * 2048 or G <= least
    assert block is None or -(-block * G // 32) * 32 <= 1024


@pytest.mark.parametrize("n_queries,want", [
    (14400, 8),  # one VLP-16 scan (chip_smoke phase 8)
    (700, 8),
    (50000, 4),
    (262144, 1),  # phase 9's slice
    (14399955, 1),  # phase 9
])
def test_walk_split_at_the_documented_sizes(n_queries, want):
    from rmcl_tpu_torch.ops.closest_cuda import walk_split

    assert walk_split(n_queries) == want


@pytest.mark.parametrize("n_blk,Rq,B,want", [
    (113, 128, 64, 8),  # phase 8: 113 blocks of 128
    (112500, 128, 64, 2),  # phase 9
    (30, 100, 8, 8),  # B = 8: one triangle a lane
    (30, 128, 4, 4),  # B = 4 caps the lanes
    (2000, 128, 64, 2),
])
def test_bins_groups_at_the_documented_sizes(n_blk, Rq, B, want):
    from rmcl_tpu_torch.ops.closest_cuda import bins_groups

    assert bins_groups(n_blk, Rq, B) == want


def test_closest_bins_refuses_groups_that_do_not_fit():
    mesh, _, _, _, tbins = _maps("room")  # bins of 16
    q = torch.from_numpy(_queries(mesh, n=256, seed=6))
    inputs = tcp.binned_inputs(tbins, q, torch.full((256,), 0.25), 128, c_super=8,
                               c_bin=32)[:5]
    want = closest_bins_reference(tbins.tri, *inputs)
    for G in (1, 2, 4, 8):
        assert all(torch.equal(a, b) for a, b in zip(closest_bins(tbins.tri, *inputs, groups=G),
                                                     want))
    for G in (3, 16, 32):  # not a power of two; 2048 threads for 128 queries; over B
        with pytest.raises(ValueError):
            closest_bins(tbins.tri, *inputs, groups=G)


# K7's launch plan: (n_blk, n_super, S, cs, cb) -> (threads, key slots,
# shared bytes). Phases 8 and 12 (113 blocks of phase 4's building, 119
# supers of 64 bins) take the wide CTA, phase 9 (112,500 blocks of the
# sphere, 244 supers of 64) the narrow one; a level's stage stops at
# 16,384 keys and a wider level is streamed, so it is never refused
@pytest.mark.parametrize("n_blk,n_super,S,cs,cb,want", [
    (113, 119, 64, 24, 96, (512, 96 + 1536, 1632 * 8 + 24 * 4)),  # phase 8
    (112500, 244, 64, 40, 835, (128, 835 + 2560, 3395 * 8 + 40 * 4)),  # phase 9
    (113, 119, 64, 84, 4000, (512, 4000 + 5376, 9376 * 8 + 84 * 4)),  # phase 12
    (113, 508, 64, 300, 2000, (512, 2000 + 16384, 18384 * 8 + 300 * 4)),  # cs x S = 19,200
    (2048, 32512, 1, 4096, 8, (128, 4096 + 16384, 20480 * 8 + 4096 * 4)),  # 32,512 supers
    (113, 10 ** 6, 64, 2000, 20000, (512, 27800, 27800 * 8 + 2000 * 4)),  # stage cut to fit
])
def test_cp_launch_plan_fits_every_level_width(n_blk, n_super, S, cs, cb, want):
    threads, slots, smem = cp_launch_plan(n_blk, n_super, S, cs, cb)
    assert (threads, slots, smem) == want
    assert slots >= max(cs, cb) and smem + closest_cuda._K7_STATIC_SMEM <= 232448


def test_cp_launch_plan_refuses_only_a_kept_list_past_shared_memory():
    """Whatever the levels' widths, the plan refuses only a kept list whose
    keys (8 B each, beside cs super ids of 4 B) do not fit one CTA."""
    cs = 500
    most = (232448 - closest_cuda._K7_STATIC_SMEM - 4 * cs) // 8
    assert 28000 < most < 29000
    for n_super, S in ((10 ** 6, 1), (4096, 1024), (100000, 64)):
        assert cp_launch_plan(113, n_super, S, cs, most)[2] <= 232448
        assert cp_launch_plan(112500, n_super, S, cs, most)[0] == 128
        with pytest.raises(ValueError, match=f"cb={most + 1} "):
            cp_launch_plan(113, n_super, S, cs, most + 1)
    # a kept super list that large (past ~19,000) is refused as well
    with pytest.raises(ValueError, match="cs=20000"):
        cp_launch_plan(113, 10 ** 6, 1, 20000, 8)
