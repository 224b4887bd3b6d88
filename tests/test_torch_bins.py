"""Parity of the port's host-side geometry with the JAX package: meshes,
triangle bins (bitwise), the map container and the sensor models' rays.

The JAX ``build_bins`` prefers its native C++ kd order when that library
is built; its ``std::nth_element`` splits ties differently from numpy's
``argpartition``, so even the per-bin triangle sets differ. The port copies
the numpy order, so the bitwise test forces the JAX package onto its numpy
path from inside the test (nothing in the JAX package changes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmcl_tpu.bvh.native
from rmcl_tpu.bvh.bins import build_bins as j_build_bins
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.sensors import models as jmodels
from rmcl_tpu_torch.bvh.bins import build_bins as t_build_bins
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
    monkeypatch.setattr(rmcl_tpu.bvh.native, "bin_order", _no_native_order)


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
    with pytest.raises(NotImplementedError):
        tm.load_mesh(str(tmp_path / "x.ply"))


@pytest.mark.parametrize("scene,bin_size,bps", [
    ("room", 32, 8),
    ("room", 8, 4),
    ("building", 32, 16),
    ("building", 64, 8),
])
def test_build_bins_bitwise(numpy_bin_order, scene, bin_size, bps):
    mesh = (jm.make_room_scene(n_pillars=4, seed=3) if scene == "room"
            else jm.make_building_scene(subdiv=4))
    jb = j_build_bins(mesh, bin_size=bin_size, bins_per_super=bps, supers_per_hyper=2)
    tb = t_build_bins(tm.TriangleMesh(mesh.vertices, mesh.faces), bin_size=bin_size,
                      bins_per_super=bps, supers_per_hyper=2, device="cpu")
    for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb", "hyper_aabb"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    for f in ("bins_per_super", "bins_per_mid", "supers_per_hyper", "n_bins", "n_super",
              "bin_size", "n_mid", "n_hyper"):
        assert getattr(jb, f) == getattr(tb, f), f


def test_mesh_map_bins_and_device_rule(monkeypatch):
    mesh = tm.make_room_scene(n_pillars=2, seed=1)
    mm = MeshMap.from_mesh(mesh, device="cpu")
    assert mm.bvh is None and mm.name == "room"
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
