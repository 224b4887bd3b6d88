"""The port's ``cast_rays_binned`` against the JAX package's default path,
on bins carried across so that both cast on the identical packing, at the
same budgets."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_building_scene, make_room_scene, make_sphere
from rmcl_tpu.ops.raycast_binned import TiledSweep
from rmcl_tpu.ops.raycast_binned import cast_rays_binned as j_cast
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned as t_cast

torch.set_num_threads(2)

HIT_MIN_AGREE = 0.999  # an ulp can move a grazing ray off an outer edge
PRIM_MIN_AGREE = 0.995  # ... or across a shared edge to the neighbour face
T_TOL = 1e-4  # t is re-derived from the winner's plane; neighbours' planes meet
NORMAL_TOL = 1e-4


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


def _scan(n_az, n_el, el=(-0.4, 0.3)):
    E, A = np.meshgrid(np.linspace(*el, n_el),
                       np.linspace(-np.pi, np.pi, n_az, endpoint=False), indexing="ij")
    return np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)],
                    -1).reshape(-1, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(jax bins, port bins, origins, dirs) — rays in scan-grid order."""
    if name == "room":
        jb = build_bins(make_room_scene(n_pillars=4, seed=3), bin_size=32, bins_per_super=8)
        d = _scan(360, 8)
        o = np.broadcast_to(np.float32([0.5, -0.3, 1.0]), d.shape)
    elif name == "building":
        jb = build_bins(make_building_scene(subdiv=4), bin_size=32, bins_per_super=16)
        d = _scan(400, 8)
        o = np.broadcast_to(np.float32([3.1, 2.9, 1.5]), d.shape)
    else:  # sphere, pose sweep: 8 poses x one scan, pose-major
        jb = build_bins(make_sphere(64, 64, radius=5.0), bin_size=64, bins_per_super=16)
        poses = np.random.default_rng(7).uniform(-1.5, 1.5, size=(8, 1, 3)).astype(np.float32)
        d1 = _scan(180, 8, el=(-0.26, 0.26))
        d = np.broadcast_to(d1, (8,) + d1.shape).reshape(-1, 3)
        o = np.broadcast_to(poses, (8,) + d1.shape).reshape(-1, 3)
    return jb, _carry(jb), np.ascontiguousarray(o), np.ascontiguousarray(d)


@pytest.mark.parametrize("name", ["room", "building", "sphere_sweep"])
def test_cast_matches_jax_default_path(name):
    jb, tb, o, d = _case(name)
    jh = j_cast(jb, jnp.asarray(o), jnp.asarray(d), t_min=0.1, t_max=30.0)
    th = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_min=0.1, t_max=30.0)
    j_hit, t_hit = np.asarray(jh.hit), th.hit.numpy()
    assert j_hit.mean() > 0.9
    assert (j_hit == t_hit).mean() >= HIT_MIN_AGREE
    both = j_hit & t_hit
    jt, tt = np.asarray(jh.t)[both], th.t.numpy()[both]
    np.testing.assert_allclose(tt, jt, rtol=T_TOL, atol=T_TOL)
    np.testing.assert_allclose(th.normal.numpy()[both], np.asarray(jh.normal)[both],
                               rtol=NORMAL_TOL, atol=NORMAL_TOL)
    np.testing.assert_allclose(th.point.numpy()[both], np.asarray(jh.point)[both],
                               rtol=T_TOL, atol=T_TOL)
    same_prim = np.asarray(jh.prim_id)[both] == th.prim_id.numpy()[both]
    assert same_prim.mean() >= PRIM_MIN_AGREE
    assert (np.abs(tt - jt)[~same_prim] < T_TOL).all()  # mismatches are near-ties
    np.testing.assert_array_equal(np.asarray(jh.inst_id)[both], th.inst_id.numpy()[both])
    # misses carry the no-hit record
    assert (th.prim_id.numpy()[~t_hit] == -1).all() and (th.normal.numpy()[~t_hit] == 0).all()


def test_payload_modes_agree():
    _, tb, o, d = _case("room")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    sel = t_cast(tb, o, d, payload="select")
    idx = t_cast(tb, o, d, payload="index")
    dflt = t_cast(tb, o, d)
    for f in ("t", "hit", "prim_id", "inst_id", "point", "normal"):
        assert torch.equal(getattr(sel, f), getattr(idx, f)), f
        assert torch.equal(getattr(sel, f), getattr(dflt, f)), f
    none = t_cast(tb, o, d, payload=False)
    assert torch.equal(none.hit, sel.hit)
    # the occlusion query returns the packed-key t, within 1e-5 of the plane t
    torch.testing.assert_close(none.t[none.hit], sel.t[sel.hit], rtol=1e-5, atol=1e-5)
    assert (none.prim_id == -1).all() and (none.point == 0).all()
    with pytest.raises(ValueError):
        t_cast(tb, o, d, payload="full")


def test_batch_shape_and_block_padding():
    _, tb, o, d = _case("room")
    o3, d3 = torch.from_numpy(o[:300]).reshape(3, 100, 3), torch.from_numpy(d[:300]).reshape(3, 100, 3)
    h = t_cast(tb, o3, d3, block_size=64, block_chunk=2)
    flat = t_cast(tb, o3.reshape(-1, 3), d3.reshape(-1, 3), block_size=64)
    assert h.t.shape == (3, 100) and h.point.shape == (3, 100, 3)
    assert torch.equal(h.t.reshape(-1), flat.t) and torch.equal(h.prim_id.reshape(-1), flat.prim_id)


def test_t_gates():
    mesh = make_sphere(32, 32, radius=2.0)
    tb = _carry(build_bins(mesh, bin_size=32, bins_per_super=8))
    o = torch.zeros((64, 3))
    d = torch.tensor([1.0, 0.0, 0.0]).expand(64, 3)
    h1 = t_cast(tb, o, d)
    torch.testing.assert_close(h1.t, torch.full((64,), 2.0), atol=0.01, rtol=0)
    assert not t_cast(tb, o, d, t_max=1.0).hit.any()
    assert not t_cast(tb, o, d, t_min=3.0, t_max=10.0).hit.any()
    # per-ray gates
    t_max = torch.where(torch.arange(64) % 2 == 0, 10.0, 1.0)
    assert torch.equal(t_cast(tb, o, d, t_max=t_max).hit, torch.arange(64) % 2 == 0)
    # normals face the ray
    assert (torch.sum(h1.normal * d, -1) < -0.9).all()


def _assert_hits_match_jax(jh, th):
    """The cast's hit records against JAX's at the module's tolerances."""
    j_hit, t_hit = np.asarray(jh.hit), th.hit.numpy()
    assert (j_hit == t_hit).mean() >= HIT_MIN_AGREE
    both = j_hit & t_hit
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both], rtol=T_TOL, atol=T_TOL)
    same_prim = np.asarray(jh.prim_id)[both] == th.prim_id.numpy()[both]
    assert same_prim.mean() >= PRIM_MIN_AGREE


@pytest.mark.parametrize("option", [dict(dir_groups=2, block_size=16), dict(sort_blocks=True),
                                    dict(c_mid=16), dict(c_mid=8, c_hyper=8),
                                    dict(with_lossless=True)])
def test_unported_options_raise(option):
    """No option raises any more: each ported option (dir_groups, which
    runs K2g's plain version here, sort_blocks, c_mid with and without the
    hyper level, with_lossless) casts as JAX's cast_rays_binned does with
    the same option. dir_groups casts the sphere's 8 poses in sweep order
    (JAX's TiledSweep: blocks of 2 directions x 8 poses), the rays its
    promise needs."""
    jb, tb, o, d = _case("building")
    if "dir_groups" in option:
        jb, tb, o, d = _case("sphere")
        sweep = TiledSweep(o[::o.shape[0] // 8], 180, 8, poses_per_tile=8, az_tile=2)
        o, d = (np.array(x) for x in sweep.rays(jnp.asarray(o[::o.shape[0] // 8]),
                                                 jnp.asarray(d[:180 * 8])))
    jh = j_cast(jb, jnp.asarray(o), jnp.asarray(d), t_min=0.1, t_max=30.0, **option)
    th = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_min=0.1, t_max=30.0, **option)
    if "with_lossless" in option:
        (jh, jl), (th, tl) = jh, th
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_hits_match_jax(jh, th)


@functools.lru_cache(maxsize=None)
def _mid_case():
    """The building in bins of 8 (16 a super, 4 a mid); 128 origins around
    one point x 128 beams, blocked beam-major as the MCL update blocks them
    (a block: every origin, one beam), so that small budgets truncate some
    blocks and not others."""
    jb = build_bins(make_building_scene(subdiv=4), bin_size=8, bins_per_super=16,
                    bins_per_mid=4)
    rng = np.random.default_rng(2)
    d1 = _scan(64, 2)
    o1 = (np.float32([3.1, 2.9, 1.5]) + 0.3 * rng.normal(size=(128, 3))).astype(np.float32)
    d = np.broadcast_to(d1[:, None], (d1.shape[0], 128, 3)).reshape(-1, 3)
    o = np.broadcast_to(o1[None], (d1.shape[0], 128, 3)).reshape(-1, 3)
    return jb, _carry(jb), np.ascontiguousarray(o), np.ascontiguousarray(d)


@pytest.mark.parametrize("kw", [dict(), dict(c_super=4, c_bin=24),
                                dict(c_mid=6, c_super=16, c_bin=24),
                                dict(c_mid=40, c_super=32, c_bin=160)])
def test_lossless_flags_and_block_stats_match_jax(kw):
    """with_lossless's per-ray certificate and block_cull_stats' (count,
    sat) equal JAX's, with budgets that truncate and with the mid level."""
    from rmcl_tpu.ops.raycast_binned import block_cull_stats as j_stats
    from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats as t_stats

    jb, tb, o, d = _mid_case()
    jh, jl = j_cast(jb, jnp.asarray(o), jnp.asarray(d), t_max=12.0, with_lossless=True, **kw)
    th, tl = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=12.0,
                    with_lossless=True, **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if kw == dict(c_super=4, c_bin=24):
        assert 0.0 < tl.float().mean() < 1.0  # some blocks truncate, some do not
    _assert_hits_match_jax(jh, th)
    jc, js_ = j_stats(jb, jnp.asarray(o), jnp.asarray(d), t_max=12.0, **kw)
    tc, ts_ = t_stats(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=12.0, **kw)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    # the port's cone bounds sum in the kernel's fixed order, JAX's in XLA's
    # (tests/test_torch_cull.py): a box on a cone's very edge may pass on
    # one side only, one candidate more or less in a rare block
    dc = np.abs(tc.numpy() - np.asarray(jc))
    assert dc.max() <= 1 and (dc == 0).mean() >= 0.98
    # the certificate is the block's ~sat, ray by ray
    np.testing.assert_array_equal(tl.numpy().reshape(-1, 128), ~ts_.numpy()[:, None]
                                  .repeat(128, 1))


@pytest.mark.parametrize("kw", [dict(), dict(c_mid=6, c_super=16, c_bin=24),
                                dict(c_super=4, c_bin=24)])
def test_sort_blocks_is_bitwise_no_sort(kw):
    """K1's candidate-count launch order changes no result, bit for bit."""
    _, tb, o, d = _mid_case()
    a = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=12.0, sort_blocks=True, **kw)
    b = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=12.0, **kw)
    for f in ("t", "hit", "prim_id", "inst_id", "point", "normal"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_sort_blocks_passes_the_count_order(monkeypatch):
    """sort_blocks hands K1 the stable ascending argsort of the counts."""
    import rmcl_tpu_torch.ops.raycast_binned as trb

    _, tb, o, d = _mid_case()
    seen = {}
    real = trb.intersect_bins

    def spy(tri, *inputs, order=None):
        seen["order"], seen["count"] = order, inputs[5]
        return real(tri, *inputs, order=order)

    monkeypatch.setattr(trb, "intersect_bins", spy)
    t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=12.0, sort_blocks=True)
    assert seen["order"].dtype == torch.int32
    assert torch.equal(seen["order"].long(), torch.argsort(seen["count"], stable=True))


@pytest.mark.parametrize("c_mid,c_bin", [(6, 24), (16, 64), (40, 96)])
def test_mid_cull_cast_matches_jax(c_mid, c_bin):
    """cast_rays_binned(c_mid=...) against JAX's: the same hits and the
    same lossless flags."""
    jb, tb, o, d = _mid_case()
    kw = dict(t_max=12.0, c_mid=c_mid, c_super=16, c_bin=c_bin, with_lossless=True)
    jh, jl = j_cast(jb, jnp.asarray(o), jnp.asarray(d), **kw)
    th, tl = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_hits_match_jax(jh, th)


def test_resolve_budgets_matches_jax():
    """The budget clamps and the mid level's silent switch-off: no mid level
    in the bins, one mid a super (S // M <= 1), cm raised to cover cb, cm
    capped at cs * S / M, cb capped at cm * M."""
    from rmcl_tpu.ops.raycast_binned import _resolve_budgets as j_resolve
    from rmcl_tpu_torch.ops.raycast_binned import _resolve_budgets as t_resolve

    mesh = make_building_scene(subdiv=4)
    for S, M in ((16, 4), (16, 16), (8, 8), (32, 8)):
        jb = build_bins(mesh, bin_size=8, bins_per_super=S, bins_per_mid=M)
        tb = _carry(jb)
        assert (tb.mid_aabb is None) == (jb.mid_aabb is None)
        for cs, cb, cm in ((24, 96, 0), (24, 96, 4), (24, 96, 40), (2, 96, 40), (24, 1000, 8),
                           (500, 5000, 1000)):
            assert t_resolve(tb, cs, cb, cm) == j_resolve(jb, cs, cb, cm), (S, M, cs, cb, cm)
    jb = build_bins(mesh, bin_size=8, bins_per_super=16, bins_per_mid=4)
    assert t_resolve(_carry(jb), 24, 96, 4)[2] == 24  # raised to ceil(96 / 4)
    assert t_resolve(_carry(build_bins(mesh, bin_size=8, bins_per_super=8,
                                       bins_per_mid=8)), 24, 96, 16)[2] == 0  # switched off


def test_hyper_cull_matches_jax():
    """The hyper level (c_hyper) against JAX's cast_rays_binned(c_hyper=16)
    on a pose sweep, at budgets that cover the passing hypers: the same hits,
    and the hits of the two-level cull."""
    jb = build_bins(make_sphere(60, 60, radius=20.0), bin_size=16, bins_per_super=8,
                    supers_per_hyper=4)
    assert jb.hyper_aabb is not None
    tb = _carry(jb)
    poses = np.random.default_rng(3).uniform(-2.0, 2.0, size=(6, 1, 3)).astype(np.float32)
    d1 = _scan(96, 4, el=(-0.4, 0.4))
    d = np.ascontiguousarray(np.broadcast_to(d1, (6,) + d1.shape).reshape(-1, 3))
    o = np.ascontiguousarray(np.broadcast_to(poses, (6,) + d1.shape).reshape(-1, 3))
    kw = dict(block_size=8, c_super=40, c_bin=64, block_chunk=64)
    jh = j_cast(jb, jnp.asarray(o), jnp.asarray(d), c_hyper=16, **kw)
    th = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), c_hyper=16, **kw)
    t0 = t_cast(tb, torch.from_numpy(o), torch.from_numpy(d), **kw)
    j_hit = np.asarray(jh.hit)
    assert j_hit.mean() > 0.99
    np.testing.assert_array_equal(th.hit.numpy(), j_hit)
    np.testing.assert_array_equal(th.hit.numpy(), t0.hit.numpy())
    np.testing.assert_allclose(th.t.numpy()[j_hit], np.asarray(jh.t)[j_hit],
                               rtol=T_TOL, atol=T_TOL)
