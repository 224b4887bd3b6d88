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


@pytest.mark.parametrize("option", [dict(dir_groups=2), dict(sort_blocks=True),
                                    dict(c_mid=16), dict(c_hyper=8),
                                    dict(with_lossless=True)])
def test_unported_options_raise(option):
    _, tb, o, d = _case("room")
    with pytest.raises(NotImplementedError):
        t_cast(tb, torch.from_numpy(o[:128]), torch.from_numpy(d[:128]), **option)
