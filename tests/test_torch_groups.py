"""The dense engine's ``dir_groups`` intersection (K2g) against the JAX
package's on the CPU: ``cast_rays_binned(..., dir_groups=G)`` on pose-sweep
rays (``TiledSweep`` blocks of G directions x P poses, JAX's own setups of
``tests/test_raycast_binned.py``) on bins carried across, against the K1
path of the port, and the wrapper's plain version on CPU tensors."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.ops import raycast_binned as trb
from rmcl_tpu_torch.ops import raycast_cuda as rc
from rmcl_tpu_torch.ops.raycast_cuda import (intersect_bins, intersect_groups,
                                             intersect_groups_reference)

torch.set_num_threads(2)

# JAX and the port run the same hoisted arithmetic; XLA may round a product
# or a sum differently (its CPU fusions), which can move a grazing ray off
# an edge or across a shared one. t is re-derived from the winner's plane.
HIT_MIN_AGREE = 0.999
PRIM_MIN_AGREE = 0.999
T_TOL = 1e-4


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


@functools.lru_cache(maxsize=None)
def _world():
    """JAX's test_dir_groups_fast_path world: a 48 x 48 sphere of 20 m in
    bins of 32, 32 poses in +-2 m, a 64 x 4 scan grid (row-major)."""
    jb = build_bins(make_sphere(48, 48, radius=20.0), bin_size=32, bins_per_super=16)
    W, H = 64, 4
    E, A = np.meshgrid(np.linspace(-0.2, 0.2, H),
                       np.linspace(-np.pi, np.pi, W, endpoint=False), indexing="ij")
    dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)],
                    -1).reshape(-1, 3).astype(np.float32)
    trans = np.random.default_rng(0).uniform(-2, 2, size=(32, 3)).astype(np.float32)
    return jb, _carry(jb), trans, dirs, W, H


@functools.lru_cache(maxsize=None)
def _sweep(pt, at, et):
    """Sweep-ordered rays (JAX's TiledSweep.rays): blocks of at * et
    directions x pt poses. Returns (o, d) numpy and the block size."""
    _, _, trans, dirs, W, H = _world()
    sweep = jrb.TiledSweep(trans, W, H, poses_per_tile=pt, az_tile=at, el_tile=et)
    o, d = sweep.rays(jnp.asarray(trans), jnp.asarray(dirs))
    assert sweep.dir_groups == at * et
    return np.array(o), np.array(d), sweep.block_size


def _assert_close_hits(a_hit, a_t, a_prim, b_hit, b_t, b_prim):
    assert (a_hit == b_hit).mean() >= HIT_MIN_AGREE
    both = a_hit & b_hit
    assert both.mean() > 0.9  # the rays really hit the sphere
    np.testing.assert_allclose(b_t[both], a_t[both], rtol=T_TOL, atol=T_TOL)
    assert (a_prim[both] == b_prim[both]).mean() >= PRIM_MIN_AGREE


def _cast_both(tiles, **kw):
    jb, tb, *_ = _world()
    o, d, Rb = _sweep(*tiles)
    kw = dict(block_size=Rb, t_min=0.1, t_max=60.0, **kw)
    jh = jrb.cast_rays_binned(jb, jnp.asarray(o), jnp.asarray(d), **kw)
    th = trb.cast_rays_binned(tb, torch.from_numpy(o), torch.from_numpy(d), **kw)
    return jh, th


def _compare(jh, th):
    _assert_close_hits(np.asarray(jh.hit), np.asarray(jh.t), np.asarray(jh.prim_id),
                       th.hit.numpy(), th.t.numpy(), th.prim_id.numpy())
    both = np.asarray(jh.hit) & th.hit.numpy()
    np.testing.assert_allclose(th.normal.numpy()[both], np.asarray(jh.normal)[both], atol=1e-4)


@pytest.mark.parametrize("G,tiles", [(1, (32, 1, 1)), (4, (16, 2, 2)), (8, (16, 8, 1))])
def test_dir_groups_match_jax(G, tiles):
    """K2g's plain version through the cast, against JAX's dir_groups path."""
    jh, th = _cast_both(tiles, dir_groups=G)
    _compare(jh, th)


def test_shared_dir_matches_jax():
    """shared_dir=True is dir_groups=1 in both packages."""
    jh, th = _cast_both((32, 1, 1), shared_dir=True)
    _compare(jh, th)
    th1 = _cast_both((32, 1, 1), dir_groups=1)[1]
    assert torch.equal(th.t, th1.t) and torch.equal(th.prim_id, th1.prim_id)


@pytest.mark.parametrize("option", [dict(sort_blocks=True), dict(c_mid=16),
                                    dict(with_lossless=True, c_bin=8),
                                    dict(payload="none")])
def test_dir_groups_options_match_jax(option):
    """The options the dir_groups path shares with the K1 path: the launch
    order, the mid level, the lossless flag (at a budget that truncates)
    and the occlusion query."""
    jh, th = _cast_both((16, 8, 1), dir_groups=8, **option)
    if "with_lossless" in option:
        (jh, jl), (th, tl) = jh, th
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert 0 < tl.float().mean() < 1  # the budget truncates some blocks
    if option.get("payload") == "none":
        _assert_close_hits(np.asarray(jh.hit), np.asarray(jh.t), np.zeros(jh.t.shape, int),
                           th.hit.numpy(), th.t.numpy(), np.zeros(th.t.shape, int))
        return
    _compare(jh, th)


@pytest.mark.parametrize("G,tiles", [(1, (32, 1, 1)), (4, (16, 2, 2)), (8, (16, 8, 1))])
def test_dir_groups_match_the_k1_path(G, tiles):
    """dir_groups=G against dir_groups=0 in the port: the hoisted terms
    round apart from Moller-Trumbore's, so t agrees to the tolerance and
    the winners but at near-ties."""
    _, tb, *_ = _world()
    o, d, Rb = _sweep(*tiles)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    a = trb.cast_rays_binned(tb, o, d, block_size=Rb, dir_groups=G)
    b = trb.cast_rays_binned(tb, o, d, block_size=Rb)
    _assert_close_hits(b.hit.numpy(), b.t.numpy(), b.prim_id.numpy(),
                       a.hit.numpy(), a.t.numpy(), a.prim_id.numpy())


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors intersect_groups is its plain version, bitwise, with
    and without a launch order, and launches nothing; it refuses a G that
    does not divide the block, and the cast refuses it too."""
    _, tb, *_ = _world()
    o, d, Rb = _sweep(16, 8, 1)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    lim = (torch.full((o.shape[0],), 0.1), torch.full((o.shape[0],), 60.0))
    inputs, _ = trb._kernel_inputs(tb, o, d, *lim, Rb, 24, 96, 4)
    before = (intersect_groups.launches, intersect_bins.launches)
    order = torch.argsort(inputs[5], stable=True).to(torch.int32)
    got = intersect_groups(tb.tri, *inputs, 8)
    got_o = intersect_groups(tb.tri, *inputs, 8, order=order)
    want = intersect_groups_reference(tb.tri, *inputs, 8)
    assert (intersect_groups.launches, intersect_bins.launches) == before
    for x in (got, got_o):
        assert torch.equal(x[0], want[0]) and torch.equal(x[1], want[1])
    assert (want[1] >= 0).float().mean() > 0.9
    with pytest.raises(ValueError, match="divide"):
        intersect_groups(tb.tri, *inputs, 3)
    with pytest.raises(ValueError, match="multiple of dir_groups"):
        trb.cast_rays_binned(tb, o, d, block_size=Rb, dir_groups=3)


def test_plain_version_steps_and_groups_of_one_ray(monkeypatch):
    """The plain version in steps of blocks equals it in one step; with one
    ray a group (G = Rb) every ray uses its own direction, so any ray
    order is a valid promise and the result is K1's within rounding."""
    _, tb, trans, dirs, *_ = _world()
    o = torch.from_numpy(np.repeat(trans[:4], 64, 0))
    d = torch.from_numpy(np.tile(dirs[::4], (4, 1)))
    lim = (torch.zeros(o.shape[0]), torch.full((o.shape[0],), 60.0))
    inputs, _ = trb._kernel_inputs(tb, o, d, *lim, 32, 24, 256, 4)  # no budget truncates
    whole = intersect_groups_reference(tb.tri, *inputs, 32)
    monkeypatch.setattr(rc, "_GROUP_PAIRS_PER_STEP", 3 * 32 * 32)  # three blocks a step
    stepped = intersect_groups_reference(tb.tri, *inputs, 32)
    assert torch.equal(whole[0], stepped[0]) and torch.equal(whole[1], stepped[1])
    k1 = rc.intersect_bins_reference(tb.tri, *inputs)
    hit = (whole[1] >= 0) & (k1[1] >= 0)
    assert hit.float().mean() > 0.9 and torch.equal(whole[1] >= 0, k1[1] >= 0)
    torch.testing.assert_close(whole[0][hit], k1[0][hit], rtol=T_TOL, atol=0.0)
