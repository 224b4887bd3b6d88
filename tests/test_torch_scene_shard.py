"""The port's scene-partitioned casts (``rmcl_tpu_torch.parallel.scene_shard``)
against the JAX package's, on 4 ranks.

The cases of ``tests/test_scene_shard.py`` at 4 shards: a ``("scene",)``
mesh of 4 ranks and a ``("rays", "scene")`` mesh of 2 x 2, on its room and
sphere scenes with its rays and tolerances. The JAX side runs on 4 devices
of the 8-device CPU mesh; the port's on 4 spawned ranks of a gloo group
(one launch for the file). ``partition_bins`` is held bitwise to JAX's, and
the election's collective count to no more than JAX's seven."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_room_scene, make_sphere
from rmcl_tpu.ops.raycast_binned import cast_rays_binned
from rmcl_tpu.parallel import scene_shard as jss
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.parallel import programs as pg
from rmcl_tpu_torch.parallel import scene_shard as tss
from rmcl_tpu_torch.parallel.mesh import launch

torch.set_num_threads(2)

N = 4
LAYOUTS = {"1d": ((4,), ("scene",)), "2d": ((2, 2), ("rays", "scene"))}
TIMEOUT = 240.0
JAX_COLLECTIVES = 7  # the JAX election: one pmin and six psums


def _port_bins(jb):
    return bins_from_arrays(
        {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
         for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb",
                   "hyper_aabb")},
        bins_per_super=jb.bins_per_super, bins_per_mid=jb.bins_per_mid,
        supers_per_hyper=jb.supers_per_hyper, device="cpu")


def rays_in_room(n=1024, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    o[:, 2] = np.abs(o[:, 2]) * 0.4 + 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jax_mesh(layout):
    shape, names = LAYOUTS[layout]
    return Mesh(np.array(jax.devices()[:N]).reshape(shape), names)


@functools.lru_cache(maxsize=None)
def world():
    room = build_bins(make_room_scene(n_pillars=6), bin_size=16, bins_per_super=8)
    sphere = build_bins(make_sphere(40, 40, radius=2.0), bin_size=16, bins_per_super=8)
    outside = np.stack([np.full(64, -8.0), np.linspace(-1.5, 1.5, 64), np.zeros(64)],
                       -1).astype(np.float32)
    return dict(
        room=room, sphere=sphere,
        rays={"matches": rays_in_room(seed=3), "forwarded": rays_in_room(seed=11),
              "away": (np.full((64, 3), 10.0, np.float32),
                       np.tile(np.float32([1.0, 0.0, 0.0]), (64, 1))),
              "outside": (outside, np.tile(np.float32([1.0, 0.0, 0.0]), (64, 1)))})


# (name, layout, scene, rays, forwarded)
CASES = [(f"{kind}_{layout}", layout, "room", kind, kind == "forwarded")
         for kind in ("matches", "forwarded") for layout in LAYOUTS]
CASES += [("away_sharded", "1d", "sphere", "away", False),
          ("away_forwarded", "1d", "sphere", "away", True),
          ("outside_forwarded", "1d", "sphere", "outside", True)]


@pytest.fixture(scope="module")
def runs():
    w = world()
    jobs = []
    for name, layout, scene, rays, forwarded in CASES:
        n_scene = LAYOUTS[layout][0][-1]
        sbins = pg.to_host(tss.partition_bins(_port_bins(w[scene]), n_scene))
        o, d = w["rays"][rays]
        jobs.append((name, LAYOUTS[layout], pg.scene_job, dict(
            sbins=sbins, orig=o, dirs=d, forwarded=forwarded, cast_kw=dict(block_size=64))))
    return launch(pg.run_jobs, N, "gloo", ("cpu", jobs), timeout=TIMEOUT)


def _port_hits(runs, name, layout):
    """The port's global hits: on the 2 x 2 mesh the scene-0 ranks' ray
    shards in order; on the 1-D mesh every rank holds all rays (and all
    agree)."""
    if layout == "2d":
        return {k: pg.assemble([r[name] for r in runs], k, ranks=[0, 2])
                for k in ("t", "hit", "prim_id", "normal")}
    for r in runs[1:]:
        for k in ("t", "hit", "prim_id", "normal"):
            np.testing.assert_array_equal(r[name][k], runs[0][name][k])
    return runs[0][name]


def _check_against(h, href, ids=True):
    np.testing.assert_array_equal(h["hit"], np.asarray(href.hit))
    m = np.asarray(href.hit)
    np.testing.assert_allclose(h["t"][m], np.asarray(href.t)[m], rtol=1e-5, atol=1e-5)
    if not ids:
        return
    np.testing.assert_array_equal(h["prim_id"][m], np.asarray(href.prim_id)[m])
    np.testing.assert_allclose(h["normal"][m], np.asarray(href.normal)[m], atol=1e-5)


@pytest.mark.parametrize("kind", ["matches", "forwarded"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_scene_sharded_matches_replicated(runs, kind, layout):
    """test_scene_shard.py:31 (the sharded cast) and :90 (ray forwarding):
    the port on the (4,) and (2, 2) meshes against JAX's replicated cast and
    JAX's own scene-sharded cast of the same rays."""
    w = world()
    o, d = (jnp.asarray(x) for x in w["rays"][kind])
    href = cast_rays_binned(w["room"], o, d, block_size=64)
    mesh = _jax_mesh(layout)
    sb = jss.partition_bins(w["room"], mesh.shape["scene"])
    sbins = jss.put_scene_sharded(sb, mesh)
    if kind == "forwarded":
        hj = jss.cast_rays_scene_forwarded(sbins, o, d, mesh, jss.shard_boxes(sb),
                                           block_size=64)
    else:
        hj = jss.cast_rays_scene_sharded(sbins, o, d, mesh, block_size=64)
    h = _port_hits(runs, f"{kind}_{layout}", layout)
    _check_against(h, href)
    _check_against(h, hj)


@pytest.mark.parametrize("n_shards", [3, 4, 8])
def test_partition_bins_bitwise_and_covers_everything(n_shards):
    """test_scene_shard.py:60: every real triangle lands in exactly one shard
    and padding never passes a slab test; and every array is JAX's, bit for
    bit."""
    sphere = make_sphere(40, 40, radius=5.0)
    jb = build_bins(sphere, bin_size=16, bins_per_super=8)
    jsb = jss.partition_bins(jb, n_shards)
    sb = tss.partition_bins(_port_bins(jb), n_shards)
    for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(sb, f).numpy(), np.asarray(getattr(jsb, f)),
                                      err_msg=f)
    assert sb.bins_per_super == jsb.bins_per_super
    tri = sb.tri.numpy()
    assert int(np.sum(np.abs(tri[:, :, 3:6]).max(axis=2) > 0)) == sphere.n_faces
    pad = sb.bin_aabb[..., 0].numpy() > sb.bin_aabb[..., 3].numpy()
    real = np.abs(tri[:, :, 3:6]).max(axis=(2, 3)) > 0
    assert not (pad & real).any()
    np.testing.assert_array_equal(tss.shard_boxes(sb).numpy(), np.asarray(jss.shard_boxes(jsb)))


@pytest.mark.parametrize("name", ["away_sharded", "away_forwarded"])
def test_scene_sharded_miss_semantics(runs, name):
    """test_scene_shard.py:75 and :132: rays from outside pointing away miss
    everywhere, with prim -1 and t > 1e30."""
    h = _port_hits(runs, name, "1d")
    assert not h["hit"].any()
    assert (h["prim_id"] == -1).all()
    assert (h["t"] > 1e30).all()


def test_scene_forwarded_outside_rays(runs):
    """test_scene_shard.py:132: rays from outside aimed at the sphere cross
    several shard boxes; forwarding and escalation find the first surface,
    as the replicated cast and JAX's forwarded cast do (hits and t, as that
    test holds them: two of the rays take another triangle at the same t)."""
    w = world()
    o, d = (jnp.asarray(x) for x in w["rays"]["outside"])
    href = cast_rays_binned(w["sphere"], o, d, block_size=64)
    mesh = _jax_mesh("1d")
    sb = jss.partition_bins(w["sphere"], N)
    hj = jss.cast_rays_scene_forwarded(jss.put_scene_sharded(sb, mesh), o, d, mesh,
                                       jss.shard_boxes(sb), block_size=64)
    h = _port_hits(runs, "outside_forwarded", "1d")
    assert h["hit"].any()
    _check_against(h, href, ids=False)
    _check_against(h, hj, ids=False)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_scene_collective_budget(runs, name):
    """The election is one integer pmin and one payload sum (two
    all-reduces, JAX spends seven); forwarding adds the round-1 distances'
    all-reduce."""
    forwarded = dict((c[0], c[4]) for c in CASES)[name]
    for r in runs:
        c = r[name]["counts"]
        assert c == {"all_reduce": 3 if forwarded else 2, "all_gather": 0, "permute": 0}
        assert c["all_reduce"] <= JAX_COLLECTIVES
