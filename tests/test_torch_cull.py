"""The block cull's plain versions (``rmcl_tpu_torch.ops.cull_cuda``): the
fixed-order bounds against the JAX package's, the fused wrappers on CPU
tensors against the composition they stand for, one unchunked cull against
the chunked one, and a model of the kernel's selection rule (compacted
keys in any order, sorted) against ``_select``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.ops import cull_cuda as cc
from rmcl_tpu_torch.ops import raycast_binned as trb

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
