"""The block cull's plain versions (``rmcl_tpu_torch.ops.cull_cuda``): the
fixed-order bounds against the JAX package's, the fused wrappers on CPU
tensors against the composition they stand for, one unchunked cull against
the chunked one, and a model of the kernel's selection rule (compacted
keys in any order, sorted) against ``_select``."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.ops import cull_cuda as cc
from rmcl_tpu_torch.ops import raycast_binned as trb
from torch_cull_expect import fixed_test

torch.set_num_threads(2)

# bounds port vs JAX: the sums run in another order (a halving tree, 1/sqrt
# for rsqrt), so the unit axis and the reach agree to a few ulp; tan =
# sqrt(1 - ca^2) / ca of a nearly parallel bundle amplifies them (the list
# tests allow 1e-3 on tnear for the same reason), and a cosine an ulp or two
# below 1 gives tan = 3.5e-4 to 4.9e-4 where the other side has 0
AXIS_RTOL = 1e-6
TAN_RTOL = 1e-3
TAN_ATOL = 1e-3
MARGIN = 0.05
DIR_MARGIN = 0.01


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


def _bins():
    """A 10 m sphere: 13 supers of 16 bins in 4 hypers."""
    return _carry(build_bins(make_sphere(80, 80, radius=10.0), bin_size=64, bins_per_super=16,
                             supers_per_hyper=4))


def _dirs(rng, shape, spread):
    """Unit directions around one random axis per block, not normalised
    exactly (the bounds normalise locally)."""
    axis = rng.normal(size=(shape[0],) + (1,) * (len(shape) - 2) + (3,))
    d = axis / np.linalg.norm(axis, axis=-1, keepdims=True) + spread * rng.normal(size=shape)
    return (1.3 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _ray_blocks(seed=0, n_blk=12, Rb=32):
    """Coherent ray blocks with inert rays, one dead block, and 5-ray
    remainders after a split into 4 (Rb = 20 leaves a padded tree)."""
    rng = np.random.default_rng(seed)
    ob = (rng.uniform(-3, 3, size=(n_blk, 1, 3))
          + 0.2 * rng.normal(size=(n_blk, Rb, 3))).astype(np.float32)
    db = _dirs(rng, (n_blk, Rb, 3), 0.05)
    tmin = np.full((n_blk, Rb), 0.1, np.float32)
    tmax = rng.uniform(5.0, 30.0, size=(n_blk, Rb)).astype(np.float32)
    tmax[rng.uniform(size=tmax.shape) < 0.2] = 0.0  # inert rays
    tmax[3] = 0.0  # a dead block
    return ob, db, tmin, tmax


def _factored_blocks(seed=1, n_blk=10, P=16, G=8):
    rng = np.random.default_rng(seed)
    o_c = (rng.uniform(-3, 3, size=(n_blk, 1, 3))
           + 0.3 * rng.normal(size=(n_blk, P, 3))).astype(np.float32)
    d_c = _dirs(rng, (n_blk, G, 3), 0.08)
    alive = np.ones(n_blk, np.float32)
    alive[2] = 0.0
    return o_c, d_c, alive


def _assert_bounds_close(t_out, j_out, live):
    names = ("oc", "oh", "axis", "tan_th", "t_hi", "n_hi", "dead")
    t = dict(zip(names, (x.numpy() for x in t_out)))
    j = dict(zip(names, (np.asarray(x) for x in j_out)))
    np.testing.assert_array_equal(t["dead"], j["dead"])
    for name in ("oc", "oh"):
        np.testing.assert_array_equal(t[name][live], j[name][live])
    for name in ("axis", "t_hi", "n_hi"):
        np.testing.assert_allclose(t[name][live], j[name][live], rtol=AXIS_RTOL, atol=1e-7)
    np.testing.assert_allclose(t["tan_th"][live], j["tan_th"][live], rtol=TAN_RTOL,
                               atol=TAN_ATOL)


@pytest.mark.parametrize("Rb,R", [(32, 4), (20, 4), (32, 1), (32, 32)])
def test_dense_bounds_match_jax(Rb, R):
    rays = _ray_blocks(Rb=Rb)
    t_out = cc._subblock_bounds(*map(torch.from_numpy, rays), R)
    j_out = jrb._subblock_bounds(*map(jnp.asarray, rays), R)
    _assert_bounds_close(t_out, j_out, ~t_out[6].numpy())


@pytest.mark.parametrize("R", [4, 1, 128])
def test_factored_bounds_match_jax(R):
    """The factored bounds with both margins (fact_bounds for G % R == 0,
    else the expanded rays' bounds) against JAX's _subblock_bounds on the
    expanded rays, its margins applied as the JAX package applies them."""
    o_c, d_c, alive = _factored_blocks()
    n_blk, P, _ = o_c.shape
    G = d_c.shape[1]
    t_min, t_max = 0.1, 40.0
    raw = cc._factored_bounds(*map(torch.from_numpy, (o_c, d_c, alive)), t_min, t_max, R,
                              MARGIN, DIR_MARGIN)
    ob = np.broadcast_to(o_c[:, None], (n_blk, G, P, 3)).reshape(n_blk, P * G, 3)
    db = np.broadcast_to(d_c[:, :, None], (n_blk, G, P, 3)).reshape(n_blk, P * G, 3)
    tmin = np.full((n_blk, P * G), t_min, np.float32)
    tmax = np.broadcast_to((alive * np.float32(t_max))[:, None], (n_blk, P * G))
    for r in (R, 1):
        oc, oh, a, tan_th, t_hi, n_hi, dead = (np.asarray(x) for x in jrb._subblock_bounds(
            *map(jnp.asarray, (ob, db, tmin, tmax)), r))
        oh = oh + np.where(dead[..., None], 0.0, np.float32(MARGIN)).astype(np.float32)
        tan_dm = np.float32(np.tan(DIR_MARGIN))
        tan_th = (tan_th + tan_dm) / (np.float32(1.0) - tan_th * tan_dm)
        live = alive > 0
        _assert_bounds_close(raw(r), (oc, oh, a, tan_th, t_hi, n_hi, dead),
                             np.broadcast_to(live[:, None], dead.shape))


def test_tree_sum_order():
    """The halving tree over a zero-padded power of two, as the kernel sums."""
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0, 3.0]])
    # padded to 8: ((1e8 + 3) + (-1e8 + 0)) + ((1 + 0) + (1 + 0)) = 2, the 3
    # lost to 1e8's ulp of 8; left to right gives 4
    assert float(cc._tree_sum(x, 1)) == 2.0
    y = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    torch.testing.assert_close(cc._tree_sum(y, 1), y.sum(1), rtol=0, atol=0)


def _budgets(bins, ch):
    cs = min(8, bins.n_super) if not ch else min(8, ch * bins.supers_per_hyper)
    return cs, min(48, bins.n_bins, cs * bins.bins_per_super)


@pytest.mark.parametrize("ch", [0, 3])
def test_cull_rays_on_cpu_equals_the_composition(ch):
    tb = _bins()
    rays = tuple(map(torch.from_numpy, _ray_blocks(n_blk=9, Rb=20)))
    cs, cb = _budgets(tb, ch)
    before = (cc.cull_rays.launches, cc.cull_blocks.launches)
    out = cc.cull_rays(tb, *rays, 4, cs, cb, ch)
    raw = lambda r: cc._subblock_bounds(*rays, r)
    ref = cc.cull_blocks_reference(*cc._cull_args(tb, raw, 4, cs, cb, ch))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (cc.cull_rays.launches, cc.cull_blocks.launches) == before
    assert float(out[1].float().mean()) > 2  # the lists are not trivial


@pytest.mark.parametrize("R", [4, 128])
def test_cull_factored_on_cpu_equals_the_composition(R):
    tb = _bins()
    o_c, d_c, alive = map(torch.from_numpy, _factored_blocks())
    cs, cb = _budgets(tb, 3)
    before = cc.cull_factored.launches
    out = cc.cull_factored(tb, o_c, d_c, alive, 0.0, 40.0, R, cs, cb, 3, MARGIN, DIR_MARGIN)
    raw = cc._factored_bounds(o_c, d_c, alive, 0.0, 40.0, R, MARGIN, DIR_MARGIN)
    ref = cc.cull_blocks_reference(*cc._cull_args(tb, raw, R, cs, cb, 3))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert cc.cull_factored.launches == before
    assert float(out[1].float().mean()) > 2


@pytest.mark.parametrize("kind", ["rays", "factored", "expanded"])
def test_one_cull_equals_the_chunked_cull(kind, monkeypatch):
    """Culling every block at once gives what culling chunks of blocks and
    concatenating gave (the chunk loops the fused kernel replaced), also
    with the plain versions' own steps cut to two blocks."""
    tb = _bins()
    cs, cb = _budgets(tb, 3)
    if kind == "rays":
        blocked = tuple(map(torch.from_numpy, _ray_blocks(n_blk=11)))
        cull = lambda *x: cc.cull_rays(tb, *x, 4, cs, cb, 3)
    else:
        blocked = tuple(map(torch.from_numpy, _factored_blocks(n_blk=11)))
        R = 4 if kind == "factored" else 32
        cull = lambda *x: cc.cull_factored(tb, *x, 0.0, 40.0, R, cs, cb, 3, MARGIN)
    whole = cull(*blocked)
    chunked = [cull(*(x[s:s + 4] for x in blocked)) for s in range(0, 11, 4)]
    monkeypatch.setattr(cc, "_REF_RAYS_PER_STEP", 2 * blocked[0].shape[1] * 8)
    stepped = cull(*blocked)
    for i, part in enumerate(zip(*chunked)):
        assert torch.equal(whole[i], torch.cat(part))
        assert torch.equal(whole[i], stepped[i])


def _model_select(valid, tn, ids, n_ids, k, packed, rng):
    """The kernel's selection: the passing keys compacted in an arbitrary
    order (warps append as they finish), sorted ascending, the first k."""
    idm = np.uint64((1 << max(1, (n_ids - 1).bit_length())) - 1)
    out_ids = np.full(valid.shape[:1] + (k,), -1, np.int64)
    out_tn = np.full(valid.shape[:1] + (k,), 3.0e38, np.float32)
    bits = tn.view(np.uint32).astype(np.uint64)
    for b in range(valid.shape[0]):
        pos = np.flatnonzero(valid[b])
        keys = ((bits[b, pos] & ~idm) | ids[b, pos].astype(np.uint64) if packed
                else (bits[b, pos] << np.uint64(32)) | pos.astype(np.uint64))
        keys = np.sort(rng.permutation(keys))[:k]
        if packed:
            out_ids[b, :len(keys)] = keys & idm
            out_tn[b, :len(keys)] = (keys & ~idm).astype(np.uint32).view(np.float32)
        else:
            p = (keys & np.uint64(0xffffffff)).astype(np.int64)
            out_ids[b, :len(keys)] = ids[b, p]
            out_tn[b, :len(keys)] = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return out_ids, out_tn


@pytest.mark.parametrize("packed", [True, False])
def test_compact_and_sort_matches_select(packed):
    """Random keys with ties (few distinct distances, +0.0 among them),
    invalid entries and rows with fewer valid entries than k."""
    rng = np.random.default_rng(3)
    n_blk, n, k, n_ids = 40, 96, 24, 1000
    tn = rng.choice(np.float32([0.0, 0.5, 1.25, 7.0, 31.0]), size=(n_blk, n))
    tn = np.where(rng.uniform(size=tn.shape) < 0.3,
                  rng.uniform(0, 40, size=tn.shape), tn).astype(np.float32)
    valid = rng.uniform(size=(n_blk, n)) < np.linspace(0.05, 0.9, n_blk)[:, None]
    ids = np.stack([rng.permutation(n_ids)[:n] for _ in range(n_blk)]).astype(np.int32)
    t_ids, t_tn = cc._select(torch.from_numpy(valid), torch.from_numpy(tn),
                             torch.from_numpy(ids), n_ids, k, packed)
    m_ids, m_tn = _model_select(valid, tn, ids, n_ids, k, packed, rng)
    np.testing.assert_array_equal(t_ids.numpy(), m_ids)
    np.testing.assert_array_equal(t_tn.numpy(), m_tn)


def test_wrappers_reject_bad_inputs():
    tb = _bins()
    rays = tuple(map(torch.from_numpy, _ray_blocks(Rb=20)))
    with pytest.raises(ValueError):  # 20 rays do not split into 3 sub-blocks
        cc.cull_rays(tb, *rays, 3, 8, 48)
    with pytest.raises(TypeError):
        cc.cull_rays(tb, rays[0].double(), *rays[1:], 4, 8, 48)
    with pytest.raises(ValueError):  # budgets out of range
        cc.cull_rays(tb, *rays, 4, 8, 10_000)
    o_c, d_c, alive = map(torch.from_numpy, _factored_blocks())
    with pytest.raises(ValueError):  # 16 x 8 rays do not split into 3
        cc.cull_factored(tb, o_c, d_c, alive, 0.0, 40.0, 3, 8, 48)
    with pytest.raises(ValueError):  # the hyper level needs cs <= ch * H
        cc.cull_factored(tb, o_c, d_c, alive, 0.0, 40.0, 4, 13, 48, 1)
    assert trb._hyper_budget(tb, 100) == tb.n_hyper


# --- the mid level (c_mid): JAX's _chunk_cull_tests3 ---

def _mid_bins():
    """The 10 m sphere in 198 bins of 64: 13 supers of 16 bins, each 4 mids
    of 4 bins (the last super partly padding), 4 hypers."""
    jb = build_bins(make_sphere(80, 80, radius=10.0), bin_size=64, bins_per_super=16,
                    bins_per_mid=4, supers_per_hyper=4)
    return jb, _carry(jb)


def _mid_lists_close(j_out, t_out):
    """JAX's lists and the port's: the same bins, counts and flags; tnear to
    TAN_RTOL (the bounds' rounding, see above); the order may differ only
    between entries whose tnear agree to it."""
    jc, jn, jt, js_ = (np.asarray(x) for x in j_out)
    tc, tn, tt, ts_ = (x.numpy() for x in t_out)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(js_, ts_)
    for i, k in enumerate(jn):
        j_near = dict(zip(jc[i, :k].tolist(), jt[i, :k].tolist()))
        t_near = dict(zip(tc[i, :k].tolist(), tt[i, :k].tolist()))
        assert set(j_near) == set(t_near), i
        for b, v in j_near.items():
            np.testing.assert_allclose(t_near[b], v, rtol=TAN_RTOL, atol=1e-7)


@pytest.mark.parametrize("ch,cm", [(0, 12), (0, 40), (2, 12), (2, 40)])
def test_mid_cull_matches_jax(ch, cm):
    """cull_rays with the mid level against JAX's _chunk_cull_tests3 +
    _chunk_select (through _chunk_candidates), at a mid budget that
    truncates (12) and one that keeps every passing mid (40, clamped to
    the 32 mids of the 8 kept supers), with and without the hyper level;
    packed mid keys (the ids fit 20 bits)."""
    jb, tb = _mid_bins()
    rays = _ray_blocks(n_blk=12, Rb=32)
    cs, cb, cm_ = trb._resolve_budgets(tb, 8, 48, cm)
    assert cm_ == min(cm, cs * 4)
    j_out = jrb._chunk_candidates(jb, *map(jnp.asarray, rays), cs, cb, 4, cm_, ch)
    t_out = cc.cull_rays(tb, *map(torch.from_numpy, rays), 4, cs, cb, ch, cm_)
    assert float(t_out[1].float().mean()) > 2
    if cm == 12:
        assert bool(t_out[3].any())  # the mid budget truncates some block
    _mid_lists_close(j_out, t_out)


def test_mid_cull_float_keys(monkeypatch):
    """The float keys of large maps (mid ids past 20 bits), forced here:
    the lists hold JAX's bins (their order may differ only between equal
    tnear, the rule float keys break by position, packed ones by id), and
    the plain version's selection is the kernel's model (compacted keys
    sorted, ties to the lower position)."""
    jb, tb = _mid_bins()
    rays = tuple(map(torch.from_numpy, _ray_blocks(n_blk=12, Rb=32)))
    cs, cb, cm = trb._resolve_budgets(tb, 8, 48, 40)
    packed = cc.cull_rays(tb, *rays, 4, cs, cb, 0, cm)
    monkeypatch.setattr(cc, "_packs", lambda n: False)
    flt = cc.cull_rays(tb, *rays, 4, cs, cb, 0, cm)
    j_out = jrb._chunk_candidates(jb, *(jnp.asarray(x.numpy()) for x in rays), cs, cb, 4, cm, 0)
    _mid_lists_close(j_out, flt)
    assert torch.equal(packed[1], flt[1]) and torch.equal(packed[3], flt[3])


@pytest.mark.parametrize("cm", [12, 40])
def test_mid_cull_wrappers_equal_the_composition(cm):
    """The fused wrappers with the mid level on CPU tensors: the bounds,
    then cull_blocks_reference with the mid arguments; the test count adds
    the mids of the kept supers."""
    _, tb = _mid_bins()
    rays = tuple(map(torch.from_numpy, _ray_blocks(n_blk=9, Rb=20)))
    cs, cb, cm_ = trb._resolve_budgets(tb, 8, 48, cm)
    out = cc.cull_rays(tb, *rays, 4, cs, cb, 0, cm_)
    args = cc._cull_args(tb, lambda r: cc._subblock_bounds(*rays, r), 4, cs, cb, 0, cm_)
    ref = cc.cull_blocks_reference(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    o_c, d_c, alive = map(torch.from_numpy, _factored_blocks())
    fout = cc.cull_factored(tb, o_c, d_c, alive, 0.0, 40.0, 4, cs, cb, 2, MARGIN, DIR_MARGIN, cm_)
    raw = cc._factored_bounds(o_c, d_c, alive, 0.0, 40.0, 4, MARGIN, DIR_MARGIN)
    for a, b in zip(fout, cc.cull_blocks_reference(*cc._cull_args(tb, raw, 4, cs, cb, 2, cm_))):
        assert torch.equal(a, b)
    two = cc.cull_tests(*args[:2], *args[3:10])
    three = cc.cull_tests(*args[:2], *args[3:10], *args[11:])
    # the mid level tests each kept super's mids, then only the kept mids' bins
    assert bool((three != two).any())
    assert args[11] is tb.mid_aabb and args[12] == tb.bins_per_mid and args[13] == cm_


def test_mid_level_rejects_bad_budgets():
    _, tb = _mid_bins()
    rays = tuple(map(torch.from_numpy, _ray_blocks(Rb=20)))
    with pytest.raises(ValueError):  # cb exceeds what cm mids hold
        cc.cull_rays(tb, *rays, 4, 8, 48, 0, 4)
    bad = dataclasses.replace(tb, mid_aabb=None)
    with pytest.raises(ValueError):  # no mid level to cull with
        cc.cull_rays(bad, *rays, 4, 8, 48, 0, 12)


# --- the flat-bin fix: the cone-box test held axial against axial ---

def _unit(v):
    return v / np.linalg.norm(v)


def _cone_rays(rng, oc, oh, axis, theta, n):
    """n rays of a block: origins in the box oc +- oh, directions at most
    theta (a little less) off the unit axis (float64)."""
    o = oc + oh * rng.uniform(-1.0, 1.0, (n, 3))
    u = _unit(np.cross(axis, [1.0, 0.0, 0.0] if abs(axis[0]) < 0.9 else [0.0, 1.0, 0.0]))
    v = np.cross(axis, u)
    alpha = theta * (1.0 - 1e-4) * np.sqrt(rng.uniform(size=(n, 1)))
    phi = rng.uniform(0.0, 2.0 * np.pi, (n, 1))
    d = np.cos(alpha) * axis + np.sin(alpha) * (np.cos(phi) * u + np.sin(phi) * v)
    return o, d


def _entry_lengths(o, d, bmin, bmax, shrink=1e-4):
    """Each ray's entry length into the box (float64 slab; the box shrunk by
    ``shrink`` in every axis it has width in, so the hit is no rounding
    away from a face), or inf where it misses the box or runs parallel to a
    zero-width axis."""
    width = bmax - bmin
    lo = np.where(width > 2 * shrink, bmin + shrink, bmin)
    hi = np.where(width > 2 * shrink, bmax - shrink, bmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (lo - o) / d, (hi - o) / d
    t_in = np.nanmax(np.minimum(t0, t1), axis=1)
    t_out = np.nanmin(np.maximum(t0, t1), axis=1)
    bad = ((width[None] <= 2 * shrink) & (np.abs(d) < 1e-6)).any(1)
    return np.where((t_in <= t_out) & (t_out >= 0.0) & ~bad, np.maximum(t_in, 0.0), np.inf)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1))
def test_fixed_cone_box_test_never_false_culls(seed):
    """An origin box (some axes of zero width), a cone (zero spread among
    them) and a reach; a target box around a point of one of the block's
    rays, often of zero thickness in one axis (a flat bin), and a scene box
    holding both. Wherever a sampled ray of the block enters the target box
    within its reach, the fixed test passes the box, with the bare reach and
    with the reach capped at the scene's exit (_scene_exit_cap's t_hi along
    the axis and t_len along a ray)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32).astype(np.float64)
    oc = f32(rng.uniform(-2.0, 2.0, 3))
    oh = f32(rng.uniform(0.0, 0.5, 3) * (rng.uniform(size=3) < 0.7))
    axis = f32(_unit(rng.normal(size=3)))
    theta = 0.0 if rng.uniform() < 0.2 else rng.uniform(0.01, 1.2)
    tan_th = f32(np.tan(theta))
    reach = f32(rng.uniform(2.0, 30.0))
    o, d = _cone_rays(rng, oc, oh, axis, theta, 64)
    k = rng.integers(64)
    p = o[k] + rng.uniform(0.05, 1.0) * reach * d[k]
    half = rng.uniform(0.0, 1.5, 3)
    if rng.uniform() < 0.6:
        half[rng.integers(3)] = 0.0
    bmin, bmax = f32(p - half), f32(p + half)
    reached = _entry_lengths(o, d, bmin, bmax) <= reach * (1.0 - 1e-4)
    if not reached.any():
        return
    t = lambda x: torch.tensor(np.asarray(x, np.float32))
    cone = (t(oc)[None], t(oh)[None], t(axis)[None], t(tan_th)[None], t(reach)[None])
    ok, _, _ = cc._cone_box_test(*cone, t(bmin)[None], t(bmax)[None])
    assert bool(ok[0])
    scene = types.SimpleNamespace(
        aabb_min=t(np.minimum(bmin, oc - oh) - rng.uniform(0.0, 3.0, 3)),
        aabb_max=t(np.maximum(bmax, oc + oh) + rng.uniform(0.0, 3.0, 3)))
    t_hi, t_len = cc._scene_exit_cap(scene, *(x[None] for x in cone))
    ok, _, _ = cc._cone_box_test(*cone[:4], t_hi[0], t(bmin)[None], t(bmax)[None], t_len[0])
    assert bool(ok[0])


def test_probe_case_jax_rejects_and_the_port_passes():
    """The flat-bin case that CHANGES.md records: a flat wall bin
    (zero thickness along the cone's axis) at a slab exit of 4.8725 m whose
    nearest point lies 4.8748 m from the origin, off-axis inside a 6.2
    degree cone. A ray of the block crosses it. JAX's test holds the
    Euclidean 4.8748 against the axial 4.8725 and rejects the box; the
    port's holds 4.8748 x cos(6.2 deg) and passes it, with JAX's entry
    distance. This is the stated difference between the two packages."""
    x = 4.8725
    y0 = float(np.sqrt(4.8748**2 - x**2))
    bmin = np.float32([[x, y0, -0.5]])
    bmax = np.float32([[x, y0 + 0.3, 0.5]])
    cone = [np.float32([[0.0, 0.0, 0.0]]), np.float32([[0.0, 0.0, 0.0]]),
            np.float32([[1.0, 0.0, 0.0]]), np.float32([np.tan(np.radians(6.2))]),
            np.float32([10.0])]
    # a ray of the block, 2.9 degrees off the axis, crosses the wall
    ray = np.array([x, y0 + 0.1, 0.0])
    assert np.degrees(np.arccos(ray[0] / np.linalg.norm(ray))) < 6.2
    assert np.isfinite(_entry_lengths(np.zeros((1, 3)), ray[None] / np.linalg.norm(ray),
                                      bmin[0].astype(np.float64), bmax[0].astype(np.float64)))
    j_ok, j_tn, j_tf = (np.asarray(v) for v in jrb._cone_box_test(
        *map(jnp.asarray, cone), jnp.asarray(bmin), jnp.asarray(bmax)))
    t_ok, t_tn, t_tf = cc._cone_box_test(*map(torch.from_numpy, cone), torch.from_numpy(bmin),
                                         torch.from_numpy(bmax))
    np.testing.assert_allclose(j_tn, 4.8748, atol=1e-4)  # d_near
    np.testing.assert_allclose(j_tf, 4.8725, atol=1e-4)  # the slab's axial exit
    assert not bool(j_ok[0]) and bool(t_ok[0])
    assert t_tn.numpy().view(np.uint32)[0] == j_tn.view(np.uint32)[0]
    assert t_tf.numpy()[0] == j_tf[0]


def test_every_box_jax_passes_keeps_its_entry_bits():
    """Random cones against random boxes, flat ones among them: every box
    JAX's test passes, the port's passes, at the same reach along a ray and
    at a longer one (the scene cap's t_len >= t_hi), and some that JAX's
    rejects. The entry distance is JAX's: the port sums its norms in the
    kernel's fixed order, so its bits are JAX's to 1 ulp (as before the
    fix), and they are exactly the bits that JAX's clauses, evaluated on the
    port's own tn and tf, pass: every such box passes the fixed test. The
    port passes exactly the boxes that the fixed clause restated in numpy
    passes (tests/torch_cull_expect.py), with its entry bits to 1 ulp
    (torch's float32 sqrt on the CPU is not always correctly rounded,
    numpy's is), and the boxes it adds to JAX's stay a small share: 2.0% of
    all at the axial reach (flat boxes seen off-axis), 5.1% at the longer
    one, where a test that passed every box would add 77%."""
    rng = np.random.default_rng(11)
    n = 20000
    oc = rng.uniform(-3, 3, (n, 1, 3))
    oh = rng.uniform(0, 0.4, (n, 1, 3)) * (rng.uniform(size=(n, 1, 3)) < 0.7)
    a = rng.normal(size=(n, 1, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    tan_th = np.where(rng.uniform(size=(n, 1)) < 0.1, 0.0, np.tan(rng.uniform(0, 1.3, (n, 1))))
    t_hi = rng.uniform(1.0, 20.0, (n, 1))
    c = rng.uniform(-8, 8, (n, 1, 3))
    half = rng.uniform(0, 1.0, (n, 1, 3))
    flat = rng.uniform(size=n) < 0.5
    half[flat, 0, rng.integers(3, size=int(flat.sum()))] = 0.0
    args = [x.astype(np.float32) for x in (oc, oh, a, tan_th, t_hi, c - half, c + half)]
    j_ok, j_tn, _ = (np.asarray(v) for v in jrb._cone_box_test(*map(jnp.asarray, args)))
    t_args = [torch.from_numpy(x) for x in args]
    for t_len in (t_args[4], t_args[4] * 1.5):
        t_ok, t_tn, t_tf = (x.numpy() for x in cc._cone_box_test(*t_args, t_len))
        assert t_ok[j_ok].all()
        ulps = np.abs(t_tn.view(np.int32).astype(np.int64) - j_tn.view(np.int32))
        assert ulps[j_ok].max() <= 1
        unfixed = (t_tn <= t_tf) & (t_tf >= 0.0) & (t_tn <= args[4])
        assert t_ok[unfixed].all() and (unfixed == j_ok).mean() > 0.999
        cones = np.concatenate([*args[:3], args[3][..., None], args[4][..., None],
                                t_len.numpy()[..., None]], -1)
        r_ok, r_tn = (x[:, 0] for x in fixed_test(cones, args[5], args[6]))
        np.testing.assert_array_equal(t_ok, r_ok)
        ulps = np.abs(t_tn.view(np.int32).astype(np.int64) - r_tn.view(np.int32))
        assert ulps[t_ok].max() <= 1
        added = (t_ok & ~j_ok).mean()
        assert 0 < added <= (0.025 if t_len is t_args[4] else 0.06)


def test_no_exact_winner_bin_left_out():
    """A building floor (bins of 16 in supers of 8) scanned by 16 x 360
    beams from one pose, 128-ray blocks of 4 cones at budgets that truncate
    no block: every ray's exact winner (the BVH cast) lies in a bin of its
    block's list in the port; JAX's lists leave 3 rays' winners out (the
    flat-bin fault)."""
    from rmcl_tpu.geom.mesh import make_building_scene
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.mesh import make_building_scene as t_building
    from rmcl_tpu_torch.ops.raycast import cast_rays

    jb = build_bins(make_building_scene(subdiv=6), bin_size=16, bins_per_super=8)
    tb = _carry(jb)
    az = np.linspace(-np.pi, np.pi, 360, endpoint=False) + 0.5436249914654229
    E, A = np.meshgrid(np.radians(np.linspace(-15, 15, 16)), az, indexing="ij")
    d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1)
    d = d.reshape(-1, 128, 3).astype(np.float32)
    o = np.broadcast_to(np.float32([4.639815, 5.3769794, 1.5]), d.shape).copy()
    tmin, tmax = np.zeros(d.shape[:2], np.float32), np.full(d.shape[:2], 30.0, np.float32)
    hits = cast_rays(build_bvh(t_building(subdiv=6), device="cpu"),
                     torch.from_numpy(o.reshape(-1, 3)), torch.from_numpy(d.reshape(-1, 3)),
                     t_max=30.0)
    prim = tb.tri[:, 12, :].reshape(-1).long()
    bin_of = torch.full((int(prim.max()) + 1,), -1, dtype=torch.long)
    bin_of[prim[prim >= 0]] = torch.nonzero(prim >= 0).squeeze(1) // tb.bin_size
    blk = torch.arange(hits.hit.numel()) // 128
    want = bin_of[hits.prim_id.long().clamp(min=0)]

    def left_out(cand, count):
        cand, count = torch.tensor(np.asarray(cand)), torch.tensor(np.asarray(count))
        slot = torch.arange(cand.shape[1])
        listed = ((cand[blk] == want[:, None]) & (slot[None] < count[blk][:, None])).any(1)
        return int((hits.hit & ~listed).sum())

    cs, cb = jb.n_super, jb.n_bins
    t_out = trb._chunk_candidates(tb, *map(torch.from_numpy, (o, d, tmin, tmax)), cs, cb, 4)
    j_out = jrb._chunk_candidates(jb, *map(jnp.asarray, (o, d, tmin, tmax)), cs, cb, 4)
    assert not t_out[3].any() and hits.hit.float().mean() > 0.9
    assert left_out(*t_out[:2]) == 0
    assert left_out(*j_out[:2]) == 3


# --- K3's launch plan: shared memory by the kept lists ---

@pytest.mark.parametrize("n_super,S,cs,cb", [
    (476, 64, 300, 4000),  # the building at 16 faces a bin: 19,200 keys at level 1
    (30409, 1, 96, 96),  # supers of one bin: 30,409 keys at level 0
])
def test_launch_plan_fits_levels_past_the_old_cap(n_super, S, cs, cb):
    """Levels past 16,384 keys, which the kernel refused while it sized its
    key region by the widest level (a power of two of 8-byte keys), plan
    within the 232,448 bytes a CTA may hold: the kept lists and a stage,
    the rest streamed (the build with the streamed passes)."""
    widest = max(n_super, cs * S)
    assert (1 << (widest - 1).bit_length()) * 8 > cc._SMEM_CAP
    threads, slots, smem, stream = cc.cull_launch_plan(113, 4, 128, n_super, S, cs, cb)
    assert threads == cc.K3_THREADS and stream
    assert smem + cc._K3_STATIC_SMEM <= 232448
    assert max(cs, cb) <= slots <= max(cs, cb) + cc._K3_STAGE_MAX < max(cs, cb) + widest
    assert cc.cull_launch_plan(204800, 8, 128, n_super, S, cs, cb)[0] == cc.K3_BIG_GRID_THREADS


def test_launch_plan_sizes_every_level_and_names_a_list_too_long():
    # with the hyper and mid levels: the widest kept list (cb) sets the slots
    threads, slots, smem, stream = cc.cull_launch_plan(51200, 8, 128, 183, 64, 192, 3072,
                                                       ch=12, n_hyper=12, H=16, cm=384, M=16)
    assert slots == 3072 + 384 * 16 and smem <= cc._SMEM_CAP - cc._K3_STATIC_SMEM
    assert not stream  # every level fits its stage: the build without streamed passes
    # precomputed cones carry no bounds tree; the widest level's stage (8
    # supers' 128 bins) past its kept list
    assert cc.cull_launch_plan(10, 4, 0, 13, 16, 8, 48)[1] == 48 + 8 * 16
    with pytest.raises(ValueError, match="bin level's kept list of 40000"):
        cc.cull_launch_plan(113, 4, 128, 476, 64, 300, 40000)
