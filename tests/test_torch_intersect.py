"""The module that holds the intersection kernel: ``ops/raycast_cuda.py``.

On the CPU ``intersect_bins`` runs its plain PyTorch version; it is held
against the JAX package's Pallas kernel in interpret mode on candidates
that JAX's own cull built and that are carried across as numpy arrays. The
port's cull is held against JAX's at budgets that do not truncate. The
kernel itself is compared with its plain version on the card by
``tests/test_torch_cuda.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_building_scene, make_room_scene
from rmcl_tpu.ops import raycast_binned as jrb
from rmcl_tpu.ops.raycast_pallas import intersect_bins_pallas
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.ops import raycast_binned as trb
from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference, winner_t

torch.set_num_threads(2)

# t_best is the packed-key t, rounded up in its low log2(B) mantissa bits;
# the two frameworks' float32 arithmetic may differ by an ulp before that
T_RTOL = 1e-6
# where an ulp moves a ray across a shared edge, the other triangle may win
REF_MIN_AGREE = 0.999
# a winner flip is a near-tie: both triangles' t agree to this (relative)
TIE_RTOL = 1e-5
# the cull's entry distances: same formulas, float32 reductions in another order
TNEAR_RTOL = 1e-5


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


def _scan_blocks(origin, Rb, n_az=256, el=(-0.35, 0.25), n_el=6, t_min=0.0, t_max=30.0):
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    E, A = np.meshgrid(np.linspace(*el, n_el), az, indexing="ij")
    d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1)
    d = d.reshape(-1, Rb, 3).astype(np.float32)
    o = np.broadcast_to(np.asarray(origin, np.float32), d.shape).copy()
    tmin = np.full(d.shape[:2], t_min, np.float32)
    tmax = np.full(d.shape[:2], t_max, np.float32)
    return o, d, tmin, tmax


SCENES = {
    "room_b32": (lambda: make_room_scene(n_pillars=3, seed=5), 32, 8, (0.4, -0.2, 1.1)),
    "room_b8": (lambda: make_room_scene(n_pillars=4, seed=3), 8, 4, (0.5, -0.3, 1.0)),
    "building_b16": (lambda: make_building_scene(subdiv=3), 16, 8, (3.1, 2.9, 1.5)),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    make, B, S, origin = SCENES[name]
    jb = build_bins(make(), bin_size=B, bins_per_super=S)
    return jb, _carry(jb), origin


@pytest.fixture(params=sorted(SCENES))
def scene(request):
    return _scene(request.param)


# The Pallas kernel writes the barycentric test as three comparisons
# (u >= -eps, v >= -eps, u + v <= 1 + eps); the XLA loop that the JAX library
# runs, and so the port, as one min3 >= -eps. The two round apart for rays
# through a shared edge, exactly; the building's 45-degree rays meet such
# edges, so the Pallas comparison runs on the room scenes, and the building
# is held against the library's own path in test_torch_raycast_binned.
@pytest.mark.parametrize("name", ["room_b32", "room_b8"])
def test_intersect_matches_pallas_interpret(name):
    jb, tb, origin = _scene(name)
    Rb = 64
    o, d, tmin, tmax = _scan_blocks(origin, Rb)
    cs, cb = jb.n_super, min(96, jb.n_bins)
    cand, count, tnear = jrb._build_candidates(
        jb, *map(jnp.asarray, (o, d, tmin, tmax)), cs, cb)
    tri = jnp.concatenate([jb.tri, jnp.zeros((1,) + jb.tri.shape[1:], jnp.float32)], 0)
    jt, jref = intersect_bins_pallas(tri, *map(jnp.asarray, (o, d, tmin, tmax)),
                                     cand, count, tnear, block_size=Rb, interpret=True)
    t_tri = torch.from_numpy(np.array(tri))
    tt, tref = intersect_bins(t_tri, *map(torch.from_numpy, (o, d, tmin, tmax)),
                              *(torch.from_numpy(np.array(x)) for x in (cand, count, tnear)))
    jt, jref, tt, tref = np.asarray(jt), np.asarray(jref), tt.numpy(), tref.numpy()
    assert (tref >= 0).mean() > 0.9  # the scan really hits geometry
    np.testing.assert_allclose(tt, jt, rtol=T_RTOL)
    agree = jref == tref
    assert agree.mean() >= REF_MIN_AGREE, agree.mean()
    # every other ray is a near-tie: the triangle the port chose is hit at
    # the t that Pallas recorded for its own winner
    mis = ~agree
    tie_t = winner_t(t_tri, *(torch.from_numpy(x[mis]) for x in (o, d, tmin, tref)))
    np.testing.assert_allclose(tie_t.numpy(), jt[mis], rtol=TIE_RTOL)


def _assert_same_candidates(j_out, t_out):
    jc, jn, jt = (np.asarray(x) for x in j_out[:3])
    tc, tn, tt = (x.numpy() for x in t_out[:3])
    np.testing.assert_array_equal(jn, tn)
    for i, k in enumerate(jn):
        j_near = dict(zip(jc[i, :k].tolist(), jt[i, :k].tolist()))
        t_near = dict(zip(tc[i, :k].tolist(), tt[i, :k].tolist()))
        assert set(j_near) == set(t_near), i
        for b, tj in j_near.items():
            np.testing.assert_allclose(t_near[b], tj, rtol=TNEAR_RTOL, atol=1e-7)
        # the order may differ only between entries whose tnear agree
        for a, b in zip(jc[i, :k], tc[i, :k]):
            if a != b:
                np.testing.assert_allclose(j_near[a], j_near[b], rtol=TNEAR_RTOL, atol=1e-7)
    np.testing.assert_array_equal(jc[:, jn.max():], tc[:, tn.max():])


def test_chunk_candidates_match_jax(scene):
    jb, tb, origin = scene
    o, d, tmin, tmax = _scan_blocks(origin, 128)
    cs, cb = jb.n_super, jb.n_bins  # budgets that cannot truncate
    j_out = jrb._chunk_candidates(jb, *map(jnp.asarray, (o, d, tmin, tmax)), cs, cb, 4)
    t_out = trb._chunk_candidates(tb, *map(torch.from_numpy, (o, d, tmin, tmax)), cs, cb, 4)
    np.testing.assert_array_equal(np.asarray(j_out[3]), t_out[3].numpy())
    assert not t_out[3].any()
    _assert_same_candidates(j_out, t_out)


def test_build_candidates_and_stats_match_jax(scene):
    jb, tb, origin = scene
    o, d, tmin, tmax = _scan_blocks(origin, 64)
    cs, cb = jb.n_super, jb.n_bins
    _assert_same_candidates(
        jrb._build_candidates(jb, *map(jnp.asarray, (o, d, tmin, tmax)), cs, cb),
        trb._build_candidates(tb, *map(torch.from_numpy, (o, d, tmin, tmax)), cs, cb))
    flat = lambda x: x.reshape(-1, 3)
    np.testing.assert_array_equal(
        np.asarray(jrb.candidate_stats(jb, jnp.asarray(flat(o)), jnp.asarray(flat(d)),
                                       t_max=30.0, block_size=96)),
        trb.candidate_stats(tb, torch.from_numpy(flat(o)), torch.from_numpy(flat(d)),
                            t_max=30.0, block_size=96).numpy())


def _small_inputs(B=8, n_blk=3, Rb=32, cb=4):
    rng = np.random.default_rng(0)
    tri = torch.from_numpy(rng.normal(size=(5, 14, B)).astype(np.float32))
    ob = torch.from_numpy(rng.normal(size=(n_blk, Rb, 3)).astype(np.float32))
    db = torch.from_numpy(rng.normal(size=(n_blk, Rb, 3)).astype(np.float32))
    tmin = torch.zeros((n_blk, Rb))
    tmax = torch.full((n_blk, Rb), 100.0)
    cand = torch.from_numpy(rng.integers(0, 5, size=(n_blk, cb)).astype(np.int32))
    count = torch.full((n_blk,), cb, dtype=torch.int32)
    tnear = torch.zeros((n_blk, cb))
    return [tri, ob, db, tmin, tmax, cand, count, tnear]


@pytest.mark.parametrize("arg,bad,err", [
    (0, lambda x: x[..., :6].contiguous(), ValueError),  # bin size not a power of two
    (1, lambda x: x.double(), TypeError),
    (3, lambda x: x[:, :5], ValueError),
    (5, lambda x: x.long(), TypeError),
    (7, lambda x: x.t().contiguous().t(), ValueError),  # not contiguous
])
def test_intersect_bins_rejects_bad_inputs(arg, bad, err):
    args = _small_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises(err):
        intersect_bins(*args)


@pytest.mark.parametrize("name", ["room_b32", "room_b8"])
def test_winner_t_recomputes_the_recorded_t(name):
    """winner_t is what the near-tie checks stand on: for each ray's own
    winner it gives back t_best bitwise, for a neighbouring triangle of the
    same bin it mostly does not."""
    jb, tb, origin = _scene(name)
    o, d, tmin, tmax = map(torch.from_numpy, _scan_blocks(origin, 64))
    inputs, _ = trb._kernel_inputs(tb, o.reshape(-1, 3), d.reshape(-1, 3), tmin.reshape(-1),
                                   tmax.reshape(-1), 64, 24, 96, 256, 4)
    t_best, ref = intersect_bins(tb.tri, *inputs)
    hit = ref >= 0
    assert hit.float().mean() > 0.9
    ob, db, t_min_b = inputs[:3]
    own = winner_t(tb.tri, ob[hit], db[hit], t_min_b[hit], ref[hit])
    assert torch.equal(own, t_best[hit])
    B = tb.bin_size
    other = (ref[hit] // B) * B + (ref[hit] + 1) % B
    moved = winner_t(tb.tri, ob[hit], db[hit], t_min_b[hit], other)
    assert (moved != t_best[hit]).float().mean() > 0.9
    no_ref = torch.full_like(ref[hit], -1)
    assert bool((winner_t(tb.tri, ob[hit], db[hit], t_min_b[hit], no_ref) > 1e38).all())


def test_intersect_bins_cpu_takes_plain_version():
    args = _small_inputs()
    before = intersect_bins.launches
    for a, b in zip(intersect_bins(*args), intersect_bins_reference(*args)):
        assert torch.equal(a, b)
    assert intersect_bins.launches == before  # no kernel launch on the CPU
