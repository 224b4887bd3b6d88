"""Parity of the port's host-side geometry with the JAX package: meshes,
triangle bins (bitwise), the map container and the sensor models' rays.

Both packages' ``build_bins`` take the native C++ kd order where its
library builds (g++ at first use) and the numpy order otherwise; the two
split ties differently (``std::nth_element`` against ``np.argpartition``),
so even the per-bin triangle sets differ. The default path is compared
with both packages on the native order; the numpy path with both forced
onto it from inside the test (nothing in the JAX package changes)."""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmcl_tpu.bvh.native
from rmcl_tpu.bvh.bins import build_bins as j_build_bins
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.sensors import models as jmodels
from rmcl_tpu_torch.bvh import native as t_native
from rmcl_tpu_torch.bvh.bins import build_bins as t_build_bins
from rmcl_tpu_torch.bvh.builder import validate_bvh
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.sensors import models as tmodels

torch.set_num_threads(2)

# rays: float32 sin/cos in the two frameworks may differ in the last bit
RAY_TOL = 1e-6


def _no_native_order(*_args, **_kwargs):
    raise RuntimeError("native bin order disabled: compare against the numpy path")


@pytest.fixture
def numpy_bin_order(monkeypatch):
    """Both packages on the numpy order: JAX's native call raises (its
    build_bins then falls to numpy), the port's library reads as
    unavailable (its rule for taking numpy)."""
    monkeypatch.setattr(rmcl_tpu.bvh.native, "bin_order", _no_native_order)
    monkeypatch.setattr(t_native, "bin_order", _no_native_order)
    monkeypatch.setattr(t_native, "available", lambda: False)


@pytest.mark.parametrize("scene", ["room", "building", "sphere"])
def test_meshes_match_jax(scene):
    make = {
        "room": lambda m: m.make_room_scene(n_pillars=4, seed=3),
        "building": lambda m: m.make_building_scene(subdiv=4),
        "sphere": lambda m: m.make_sphere(16, 24, radius=2.0, center=(0.5, 0.0, -1.0)),
    }[scene]
    a, b = make(jm), make(tm)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.name == b.name


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4 -2 -1\n")
    a, b = jm.load_mesh(str(path)), tm.load_mesh(str(path))
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert b.name == "quad.obj" and b.n_faces == 3
    with pytest.raises(ValueError, match="unsupported mesh format '.xyz'"):
        tm.load_mesh(str(tmp_path / "x.xyz"))


BIN_CASES = [("room", 32, 8), ("room", 8, 4), ("building", 32, 16), ("building", 64, 8)]


def _scene(scene):
    return (jm.make_room_scene(n_pillars=4, seed=3) if scene == "room"
            else jm.make_building_scene(subdiv=4))


def _assert_same_bins(jb, tb):
    for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb", "hyper_aabb"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    for f in ("bins_per_super", "bins_per_mid", "supers_per_hyper", "n_bins", "n_super",
              "bin_size", "n_mid", "n_hyper"):
        assert getattr(jb, f) == getattr(tb, f), f


def _both(mesh, **kw):
    return (j_build_bins(mesh, **kw),
            t_build_bins(tm.TriangleMesh(mesh.vertices, mesh.faces), device="cpu", **kw))


@pytest.mark.parametrize("scene,bin_size,bps", BIN_CASES)
def test_build_bins_bitwise(numpy_bin_order, scene, bin_size, bps):
    """The numpy kd order, both packages forced onto it."""
    _assert_same_bins(*_both(_scene(scene), bin_size=bin_size, bins_per_super=bps,
                             supers_per_hyper=2))


@pytest.mark.parametrize("scene,bin_size,bps", BIN_CASES + [("sphere", 64, 16)])
def test_default_build_bins_matches_jax(scene, bin_size, bps):
    """Each package's default, as users call it: the native order on both
    sides wherever g++ builds the libraries."""
    mesh = jm.make_sphere(60, 60) if scene == "sphere" else _scene(scene)
    _assert_same_bins(*_both(mesh, bin_size=bin_size, bins_per_super=bps, supers_per_hyper=2))


@pytest.mark.parametrize("scene,bin_size,bps", BIN_CASES[::2])
def test_morton_build_bins_bitwise(scene, bin_size, bps):
    _assert_same_bins(*_both(_scene(scene), bin_size=bin_size, bins_per_super=bps,
                             supers_per_hyper=2, method="morton"))
    with pytest.raises(ValueError, match="bin order"):
        t_build_bins(tm.make_room_scene(), method="hilbert", device="cpu")


def test_native_library_builds_where_gpp_is():
    """A broken build must fail here rather than quietly change the bins:
    the library is available wherever g++ is on PATH, and its source is
    the JAX package's, byte for byte."""
    assert t_native.available() == (shutil.which("g++") is not None), \
        t_native.unavailable_reason()
    jax_src = Path(rmcl_tpu.bvh.native.__file__).parent / "builder.cpp"
    assert t_native.SOURCE.read_bytes() == jax_src.read_bytes()
    if t_native.available():
        assert t_native.library_path().is_file()


def test_mesh_map_bins_and_device_rule(monkeypatch):
    mesh = tm.make_room_scene(n_pillars=2, seed=1)
    mm = MeshMap.from_mesh(mesh, device="cpu")
    assert mm.name == "room"
    # the map carries the exact engine's BVH too: every face a leaf
    assert mm.bvh.n_slots == 2 * mesh.n_faces - 1 and int(mm.bvh.n_tris) == mesh.n_faces
    assert mm.bvh.nodes.device.type == "cpu"
    assert validate_bvh(mm.bvh)["n_leaves"] == mesh.n_faces
    assert mm.bins.bin_size == 64 and mm.bins.tri.device.type == "cpu"
    # with no card, the default device raises instead of falling to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshMap.from_mesh(mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.SphericalModel.vlp16().rays()


@pytest.mark.parametrize("model", ["vlp16", "spherical_endpoints", "pinhole", "o1dn", "ondn"])
def test_sensor_rays_match_jax(rng, model):
    if model == "vlp16":
        a, b = jmodels.SphericalModel.vlp16(), tmodels.SphericalModel.vlp16()
        args = ("cpu",)
    elif model == "spherical_endpoints":
        kw = dict(width=37, height=5, theta_min=-1.0, theta_max=2.0, phi_min=-0.4,
                  phi_max=0.3, theta_endpoint=True, range_max=30.0)
        a, b = jmodels.SphericalModel.create(**kw), tmodels.SphericalModel.create(**kw)
        args = ("cpu",)
    elif model == "pinhole":
        kw = dict(width=64, height=48, fx=50.0, fy=52.0, cx=31.5, cy=23.5)
        a, b = jmodels.PinholeModel.create(**kw), tmodels.PinholeModel.create(**kw)
        args = ("cpu",)
    elif model == "o1dn":
        d = rng.normal(size=(100, 3)).astype(np.float32)
        o = np.asarray([0.1, 0.2, 0.3], np.float32)
        a = jmodels.O1DnModel.create(jnp.asarray(d), orig=jnp.asarray(o))
        b = tmodels.O1DnModel.create(d, orig=o, device="cpu")
        args = ()
    else:
        o = rng.normal(size=(100, 3)).astype(np.float32)
        d = rng.normal(size=(100, 3)).astype(np.float32)
        a = jmodels.OnDnModel.create(jnp.asarray(o), jnp.asarray(d))
        b = tmodels.OnDnModel.create(o, d, device="cpu")
        args = ()
    assert a.n_rays == b.n_rays
    assert float(a.range.min) == b.range.min and float(a.range.max) == b.range.max
    for x, y in zip(a.rays(), b.rays(*args)):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=RAY_TOL, atol=RAY_TOL)
