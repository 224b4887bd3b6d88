"""The port's factored engine against the JAX package's: Morton codes, the
pose-sweep orders, the hyper-level cull, factored_candidates, every payload
of cast_rays_binned_factored (paired, dead blocks, candidate reuse), the
in-port reuse-equals-fresh contract, and one correction of the sweep
benchmark. Bins are carried across so that both cast on the same packing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.bvh.builder import morton_codes_3d as j_morton
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu.math.gaussian import CrossStatistics as JStats
from rmcl_tpu.math.stats import umeyama_transform as j_umeyama
from rmcl_tpu.sensors.models import SphericalModel
import rmcl_tpu_torch.ops.raycast_binned as trb
from rmcl_tpu_torch.bench import SweepBench
from rmcl_tpu_torch.bvh.builder import morton_codes_3d
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.geom import mesh as tmesh
from rmcl_tpu_torch.ops.cull_cuda import cull_blocks, cull_blocks_reference
from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored, intersect_factored_reference

torch.set_num_threads(2)

# candidate lists: the same bins, counts and saturation flags; tnear to this
# relative tolerance, and the order may differ only between entries whose
# tnear agree to it. tan = sqrt(1 - ca^2) / ca of a nearly parallel bundle
# amplifies the frameworks' ulp differences in rsqrt and the direction sums
# (measured up to 1.9e-4).
TNEAR_RTOL = 1e-3
# t: the plane t of the winner; one ulp of arithmetic apart, or a near-tie
# winner on a shared edge; the packed-key t of payload "none" carries the
# lane index in its low log2(B) = 6 mantissa bits (7.6e-6)
T_RTOL = 1e-5
# every hyper and super kept: the hyper level culls but truncates nothing
CULL_KW = dict(c_bin=64, block_chunk=512, c_hyper=4, c_super=13, sub_blocks=4)
CAST_KW = dict(CULL_KW, sort_blocks=True)
MARGIN = 0.05


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


@functools.lru_cache(maxsize=None)
def _world():
    """tests/test_candidate_reuse.py's world: 64 poses x VLP-16 (60 wide)
    in a 10 m sphere, 16-pose x 8-direction blocks; 4 supers per hyper, so
    that its 13 supers form 4 hypers and the hyper level culls."""
    jb = build_bins(make_sphere(80, 80, radius=10.0), bin_size=64, bins_per_super=16,
                    supers_per_hyper=4)
    assert jb.n_hyper == 4
    model = SphericalModel.vlp16(width=60)
    dirs = np.asarray(model.rays()[1])
    trans = np.random.default_rng(7).uniform(-2, 2, size=(64, 3)).astype(np.float32)
    jsweep = jrb.TiledSweep(trans, model.width, model.height, 16, 8, 1)
    tsweep = trb.TiledSweep(trans, model.width, model.height, 16, 8, 1)
    return jb, _carry(jb), model, dirs, trans, jsweep, tsweep


def _blocks(trans, jit=None):
    jb, tb, model, dirs, _, jsweep, tsweep = _world()
    tr = trans if jit is None else trans + jit
    jo, jd = jsweep.factored_rays(jnp.asarray(tr), jnp.asarray(dirs))
    to, td = tsweep.factored_rays(torch.from_numpy(tr), torch.from_numpy(dirs))
    return (jo, jd), (to, td)


def _assert_same_lists(j_out, t_out):
    jc, jn, jt = (np.asarray(x) for x in j_out[:3])
    tc, tn, tt = (x.numpy() for x in t_out[:3])
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(jc < 0, tc < 0)
    for i, k in enumerate(jn):
        j_near = dict(zip(jc[i, :k].tolist(), jt[i, :k].tolist()))
        t_near = dict(zip(tc[i, :k].tolist(), tt[i, :k].tolist()))
        assert set(j_near) == set(t_near), i
        for b, tj in j_near.items():
            np.testing.assert_allclose(t_near[b], tj, rtol=TNEAR_RTOL, atol=1e-7)
        for a, b in zip(jc[i, :k], tc[i, :k]):
            if a != b:
                np.testing.assert_allclose(j_near[a], j_near[b], rtol=TNEAR_RTOL, atol=1e-7)


def test_morton_codes_match_jax():
    pts = np.random.default_rng(0).uniform(-0.1, 1.1, size=(5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(morton_codes_3d(pts), j_morton(pts))


@pytest.mark.parametrize("shape", [(64, 60, 16, 16, 8, 1), (37, 25, 5, 8, 4, 2)],
                         ids=["bench_tiles", "ragged"])
def test_tiled_sweep_matches_jax(shape):
    n_poses, width, height, pt, at, et = shape
    rng = np.random.default_rng(1)
    trans = rng.uniform(-3, 3, size=(n_poses, 3)).astype(np.float32)
    dirs = rng.normal(size=(width * height, 3)).astype(np.float32)
    js = jrb.TiledSweep(trans, width, height, pt, at, et)
    ts = trb.TiledSweep(trans, width, height, pt, at, et)
    assert (ts.n_rays, ts.block_size, ts.dir_groups) == (js.n_rays, js.block_size, js.dir_groups)
    for name in ("rays", "factored_rays"):
        for j, t in zip(getattr(js, name)(jnp.asarray(trans), jnp.asarray(dirs)),
                        getattr(ts, name)(torch.from_numpy(trans), torch.from_numpy(dirs))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    data = rng.normal(size=(n_poses, width * height, 2)).astype(np.float32)
    np.testing.assert_array_equal(ts.permute(torch.from_numpy(data)).numpy(),
                                  np.asarray(js.permute(jnp.asarray(data))))
    flat = rng.normal(size=(ts.n_rays, 2)).astype(np.float32)
    np.testing.assert_array_equal(ts.unpermute(torch.from_numpy(flat)).numpy(),
                                  np.asarray(js.unpermute(jnp.asarray(flat))))
    np.testing.assert_allclose(ts.pose_sums(torch.from_numpy(flat)).numpy(),
                               np.asarray(js.pose_sums(jnp.asarray(flat))), rtol=1e-5, atol=1e-4)
    # unpermute inverts permute
    np.testing.assert_array_equal(ts.unpermute(ts.permute(torch.from_numpy(data))).numpy(), data)


@pytest.mark.parametrize("dir_major", [False, True])
def test_sweep_orders_match_jax(dir_major):
    trans = np.random.default_rng(2).uniform(-1, 1, size=(21, 3)).astype(np.float32)
    jp, ji = jrb.tiled_sweep_order(trans, 12, 3, 8, 5, 2, dir_major=dir_major)
    tp_, ti = trb.tiled_sweep_order(trans, 12, 3, 8, 5, 2, dir_major=dir_major, device="cpu")
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jp, ji = jrb.direction_major_order(7, 11)
    tp_, ti = trb.direction_major_order(7, 11, device="cpu")
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_hyper_chunk_cull_matches_jax():
    """The c_hyper branch of the chunk cull on expanded sweep rays, on
    tests/test_raycast_factored.py's hyper map (57 supers in 15 hypers)."""
    jb = build_bins(make_sphere(60, 60, radius=20.0), bin_size=16, bins_per_super=8,
                    supers_per_hyper=4)
    tb = _carry(jb)
    _, _, _, dirs, trans, jsweep, _ = _world()
    o, d = (np.asarray(x) for x in jsweep.rays(jnp.asarray(trans), jnp.asarray(dirs)))
    Rb = jsweep.block_size
    o, d = o.reshape(-1, Rb, 3)[::4], d.reshape(-1, Rb, 3)[::4]
    tmin = np.zeros(o.shape[:2], np.float32)
    tmax = np.full(o.shape[:2], 100.0, np.float32)
    args = (32, 64, 4)
    j_cull = jax.jit(jrb._chunk_candidates, static_argnums=(5, 6, 7), static_argnames="c_hyper")
    j_out = j_cull(jb, *map(jnp.asarray, (o, d, tmin, tmax)), *args, c_hyper=8)
    t_out = trb._chunk_candidates(tb, *map(torch.from_numpy, (o, d, tmin, tmax)), *args,
                                  c_hyper=8)
    assert float(t_out[1].float().mean()) > 5
    _assert_same_lists(j_out, t_out)
    np.testing.assert_array_equal(np.asarray(j_out[3]), t_out[3].numpy())


@pytest.mark.parametrize("margins", [(0.0, 0.0), (MARGIN, 0.0), (0.0, 0.01)],
                         ids=["none", "origin_0.05m", "dir_0.01rad"])
def test_factored_candidates_match_jax(margins):
    jb, tb, *_, trans, _, _ = _world()
    (jo, jd), (to, td) = _blocks(trans)
    kw = dict(CULL_KW, origin_margin=margins[0], dir_margin=margins[1])
    j_out = jrb.factored_candidates(jb, jo, jd, **kw)
    t_out = trb.factored_candidates(tb, to, td, **kw)
    assert float(t_out[1].float().mean()) > 5  # the lists are not trivial
    _assert_same_lists(j_out, t_out)


def _assert_same_hits(jh, th, payload):
    j_hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(th.hit.numpy(), j_hit)
    assert th.t.shape == tuple(jh.t.shape) and th.point.shape == tuple(jh.point.shape)
    np.testing.assert_allclose(th.t.numpy()[j_hit], np.asarray(jh.t)[j_hit], rtol=T_RTOL)
    assert (th.t.numpy()[~j_hit] == np.asarray(jh.t)[~j_hit]).all()
    if payload != "none":
        np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal), rtol=0, atol=1e-5)
        np.testing.assert_allclose(th.point.numpy(), np.asarray(jh.point), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_array_equal(th.inst_id.numpy(), np.asarray(jh.inst_id))


@pytest.mark.parametrize("payload", ["plane", "index", "full", "none"])
def test_factored_cast_matches_jax(payload):
    jb, tb, *_, trans, _, _ = _world()
    (jo, jd), (to, td) = _blocks(trans)
    jh = jrb.cast_rays_binned_factored(jb, jo, jd, payload=payload, **CAST_KW)
    th = trb.cast_rays_binned_factored(tb, to, td, payload=payload, **CAST_KW)
    assert np.asarray(jh.hit).mean() > 0.999  # every pose is inside the sphere
    _assert_same_hits(jh, th, payload)


def test_factored_cast_paired_dead_blocks_match_jax():
    """The paired layout (one origin per direction) with every third block
    dead: dead blocks give no hits and disturb no live block."""
    jb, tb, *_ = _world()
    rng = np.random.default_rng(4)
    n_blk, G = 40, 64
    o = rng.uniform(-1, 1, size=(n_blk, G, 3)).astype(np.float32)
    axis = rng.normal(size=(n_blk, 1, 3)).astype(np.float32)
    d = axis + 0.1 * rng.normal(size=(n_blk, G, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = np.arange(n_blk) % 3 != 1
    kw = dict(CAST_KW, paired=True, payload="index", block_chunk=16, c_bin=200)
    jh = jrb.cast_rays_binned_factored(jb, jnp.asarray(o), jnp.asarray(d),
                                       alive=jnp.asarray(alive), **kw)
    th = trb.cast_rays_binned_factored(tb, torch.from_numpy(o), torch.from_numpy(d),
                                       alive=torch.from_numpy(alive), **kw)
    _assert_same_hits(jh, th, "index")
    assert not th.hit.numpy()[~alive].any() and th.hit.numpy()[alive].mean() > 0.999


@pytest.mark.parametrize("payload", ["plane", "index", "none"])
def test_reuse_matches_jax_and_fresh_bitwise(payload):
    """tests/test_candidate_reuse.py's contract in the port: casts through
    lists culled with a 0.05 m margin equal fresh-cull casts BITWISE for
    origins jittered by up to 0.03 m — and match JAX's reused casts."""
    jb, tb, *_, trans, _, _ = _world()
    (jo, jd), (to, td) = _blocks(trans)
    j_c = jrb.factored_candidates(jb, jo, jd, origin_margin=MARGIN, **CULL_KW)
    t_c = trb.factored_candidates(tb, to, td, origin_margin=MARGIN, **CULL_KW)
    rng = np.random.default_rng(11)
    for _ in range(2):
        jit = rng.uniform(-0.03, 0.03, size=trans.shape).astype(np.float32)
        (jo2, jd2), (to2, td2) = _blocks(trans, jit)
        fresh = trb.cast_rays_binned_factored(tb, to2, td2, payload=payload, **CAST_KW)
        reuse = trb.cast_rays_binned_factored(tb, to2, td2, payload=payload, candidates=t_c,
                                              **CAST_KW)
        for f in ("t", "hit", "normal", "prim_id", "point"):
            assert torch.equal(getattr(fresh, f), getattr(reuse, f)), f
        jh = jrb.cast_rays_binned_factored(jb, jo2, jd2, payload=payload, candidates=j_c,
                                           **CAST_KW)
        _assert_same_hits(jh, reuse, payload)


def test_zero_margin_lists_equal_the_in_cast_cull():
    jb, tb, *_, trans, _, _ = _world()
    _, (to, td) = _blocks(trans)
    base = trb.cast_rays_binned_factored(tb, to, td, **CAST_KW)
    cands = trb.factored_candidates(tb, to, td, **CULL_KW)
    reuse = trb.cast_rays_binned_factored(tb, to, td, candidates=cands, **CAST_KW)
    assert torch.equal(base.t, reuse.t) and torch.equal(base.hit, reuse.hit)
    with pytest.raises(ValueError):  # lists of other blocks or budgets
        trb.cast_rays_binned_factored(tb, to, td, candidates=tuple(x[:-1] for x in cands),
                                      **CAST_KW)


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the K3 and K4 wrappers return their plain versions'
    results and count no launch."""
    jb, tb, *_, trans, _, _ = _world()
    _, (to, td) = _blocks(trans)
    k3, k4 = cull_blocks.launches, intersect_factored.launches
    o_p, d_p, alive, *_ = trb._pad_factored_blocks(to, td, None, 512)
    cand, count, tnear, _ = trb._factored_block_candidates(
        tb, o_p, d_p, alive, 0.0, 100.0, 12, 64, 3, 4, 0.0)
    args = (tb.tri, o_p, d_p, alive, 0.0, 100.0, cand, count, tnear)
    for a, b in zip(intersect_factored(*args), intersect_factored_reference(*args)):
        assert torch.equal(a, b)
    cones = torch.rand((3, 4, 12))
    cones[..., 6:9] = torch.nn.functional.normalize(cones[..., 6:9], dim=-1)
    boxes = (tb.bin_aabb, tb.super_aabb, tb.hyper_aabb)
    for ch in (0, 3):
        fat = cones[:, 0].contiguous()
        a = cull_blocks(cones, fat, torch.ones(3), *boxes, 16, 4, ch, 12, 64)
        b = cull_blocks_reference(cones, fat, torch.ones(3), *boxes, 16, 4, ch, 12, 64)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert (cull_blocks.launches, intersect_factored.launches) == (k3, k4)


@pytest.mark.parametrize("bad", ["t_min", "paired_shape", "payload", "c_mid"])
def test_factored_cast_rejects_bad_arguments(bad):
    jb, tb, *_, trans, _, _ = _world()
    _, (to, td) = _blocks(trans)
    kw = dict(CAST_KW)
    err = ValueError
    if bad == "t_min":
        kw["t_min"] = -0.1
    elif bad == "paired_shape":
        kw["paired"] = True
    elif bad == "payload":
        kw["payload"] = "select"
    else:
        # c_mid is ported: no longer refused, the cast is JAX's at the
        # same mid budget
        kw["c_mid"] = 8
        (jo, jd), _ = _blocks(trans)
        _assert_same_hits(jrb.cast_rays_binned_factored(jb, jo, jd, payload="index", **kw),
                          trb.cast_rays_binned_factored(tb, to, td, payload="index", **kw),
                          "index")
        return
    with pytest.raises(err):
        trb.cast_rays_binned_factored(tb, to, td, **kw)


@pytest.mark.parametrize("c_mid", [2, 8, 26])
def test_factored_mid_cull_matches_jax(c_mid):
    """factored_candidates and the cast with the mid level (16-bin supers of
    2 mids of 8) against JAX's: the same lists (the mid budget 2 is raised
    to cover c_bin, 26 keeps every mid of the kept supers) and hits."""
    jb, tb, *_, trans, _, _ = _world()
    assert tb.mid_aabb is not None and tb.bins_per_super // tb.bins_per_mid == 2
    (jo, jd), (to, td) = _blocks(trans)
    kw = dict(CULL_KW, c_mid=c_mid)
    j_out = jrb.factored_candidates(jb, jo, jd, **kw)
    t_out = trb.factored_candidates(tb, to, td, **kw)
    assert float(t_out[1].float().mean()) > 3  # the mids cull: shorter lists, not trivial
    _assert_same_lists(j_out, t_out)
    jh = jrb.cast_rays_binned_factored(jb, jo, jd, payload="full", **dict(CAST_KW, c_mid=c_mid))
    th = trb.cast_rays_binned_factored(tb, to, td, payload="full", **dict(CAST_KW, c_mid=c_mid))
    _assert_same_hits(jh, th, "full")


def test_sweep_correction_matches_jax():
    """One correction of rmcl_tpu_torch.bench (32 poses x VLP-16 at 180
    wide, a 20k-face sphere) against the same composition of JAX library
    calls: the same dataset hits, increments within 2e-5 m, and three
    iterations that end where JAX's do."""
    mesh_args = (100, 100)
    bench = SweepBench(n_poses=32, width=180, mesh=tmesh.make_sphere(*mesh_args, radius=50.0),
                       sub_blocks=8, device="cpu")
    jb = build_bins(make_sphere(*mesh_args, radius=50.0), bin_size=64, bins_per_super=16,
                    supers_per_hyper=16)
    bench.bins = _carry(jb)  # the same packing on both sides
    trans = bench.trans_true_np
    dirs = jnp.asarray(bench.dirs.numpy())
    sweep = jrb.TiledSweep(trans, 180, 16, 16, 8, 1)
    kw = dict(bench.corrector.cull_kw, sort_blocks=True, payload="plane")

    def j_cast(tr):
        o, d = sweep.factored_rays(tr, dirs)
        h = jrb.cast_rays_binned_factored(jb, o, d, **kw)
        n = sweep.n_rays
        up = sweep.unpermute(jnp.concatenate(
            [h.normal.reshape(n, 3), h.t.reshape(n, 1), h.hit.reshape(n, 1).astype(jnp.float32)],
            1))
        return tr[:, None] + up[..., 3:4] * dirs[None], up[..., 0:3], up[..., 4] > 0.5

    def j_correction(dp, dm, est):
        sp, sn, sh = j_cast(est)
        d_map = dp + est[:, None]
        s = jnp.sum(sn * (d_map - sp), -1)
        ok = dm & sh & (jnp.abs(s) <= 2.0)
        return j_umeyama(JStats.from_masked_points(d_map, d_map - s[..., None] * sn, ok))

    tj = jnp.asarray(trans)
    jp, _, jm = j_cast(tj)
    tp_, tm = bench.make_dataset(bench.trans_true)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.float().mean() > 0.999
    jdp = jp - tj[:, None]
    est_j = tj + jnp.asarray([0.0, 0.0, 0.2])
    est_t = bench.trans_true + torch.tensor([0.0, 0.0, 0.2])
    dj = j_correction(jdp, jm, est_j)
    dt, n_meas = bench.correction(tp_, tm, est_t)
    np.testing.assert_allclose(dt.trans.numpy(), np.asarray(dj.trans), rtol=0, atol=2e-5)
    assert float(n_meas.min()) > 0.9 * 180 * 16
    for _ in range(3):
        est_j = j_correction(jdp, jm, est_j).apply(est_j)
    err_j = np.median(np.linalg.norm(np.asarray(est_j) - trans, axis=1))
    est_t = bench.iterate(tp_, tm, bench.trans_true + torch.tensor([0.0, 0.0, 0.2]), 3)
    err_t = np.median(np.linalg.norm(est_t.numpy() - trans, axis=1))
    np.testing.assert_allclose(err_t, err_j, rtol=0, atol=1e-4)
    assert err_t < 0.19  # the iteration contracts (slowly: ~3% a step here)
