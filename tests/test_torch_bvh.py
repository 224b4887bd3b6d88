"""The threaded BVH: the port's ``build_bvh`` and ``build_bvh_sah`` against
the JAX package's, bit for bit, their validation, and the BVH carried
across as arrays.

The slot tables are compared as int32 views: words 12-14 hold int32 bit
patterns (links, ids) that are NaN or denormal as floats, so only a bitwise
comparison means anything there."""

import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.builder import build_bvh as j_build_bvh
from rmcl_tpu.bvh.builder import build_bvh_auto as j_build_bvh_auto
from rmcl_tpu.bvh.builder import build_bvh_sah as j_build_bvh_sah
from rmcl_tpu.bvh.builder import validate_bvh as j_validate_bvh
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu_torch.bvh import builder as tb
from rmcl_tpu_torch.bvh import native
from rmcl_tpu_torch.bvh.types import SENTINEL_LINK, decode_link
from rmcl_tpu_torch.convert import bvh_from_arrays
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.geom.map import MeshMap

torch.set_num_threads(2)

MESHES = {
    "room": lambda: jm.make_room_scene(n_pillars=4, seed=3),
    "building": lambda: jm.make_building_scene(subdiv=4),
    "sphere": lambda: jm.make_sphere(24, 32, radius=5.0),
    "one_triangle": lambda: jm.TriangleMesh(np.eye(3, dtype=np.float32),
                                            np.array([[0, 1, 2]], np.int32)),
    "two_triangles": lambda: jm.make_plane((2.0, 2.0)),
    # many triangles sharing a centroid: runs of equal Morton codes split at
    # their midpoint
    "duplicates": lambda: jm.make_box().concat(jm.make_box()).concat(jm.make_box()),
}


def _t_mesh(m):
    return tm.TriangleMesh(m.vertices, m.faces)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_bitwise(name):
    mesh = MESHES[name]()
    a = j_build_bvh(mesh, as_numpy=True)
    b = tb.build_bvh(_t_mesh(mesh), device="cpu")
    assert b.nodes.dtype == torch.float32 and b.nodes.shape == (2 * mesh.n_faces - 1, 16)
    np.testing.assert_array_equal(np.asarray(a.nodes).view(np.int32),
                                  b.nodes.view(torch.int32).numpy())
    assert int(b.root_link) == int(a.root_link) and b.root_link.dtype == torch.int32
    assert int(b.n_tris) == int(a.n_tris) == mesh.n_faces
    np.testing.assert_array_equal(np.asarray(a.aabb_min), b.aabb_min.numpy())
    np.testing.assert_array_equal(np.asarray(a.aabb_max), b.aabb_max.numpy())
    assert b.n_slots == a.n_slots and b.nbytes() == a.nbytes()


def test_build_bvh_ids_bitwise():
    """prim_ids/inst_ids written into the leaves, as the scene flattener
    passes them."""
    mesh = MESHES["building"]()
    rng = np.random.default_rng(1)
    prim = rng.permutation(mesh.n_faces).astype(np.int32)
    inst = rng.integers(0, 5, mesh.n_faces).astype(np.int32)
    a = j_build_bvh(mesh, prim_ids=prim, inst_ids=inst, as_numpy=True)
    b = tb.build_bvh(_t_mesh(mesh), prim_ids=prim, inst_ids=inst, device="cpu")
    np.testing.assert_array_equal(np.asarray(a.nodes).view(np.int32),
                                  b.nodes.view(torch.int32).numpy())


@pytest.mark.parametrize("name", ["room", "building", "one_triangle", "duplicates"])
def test_validate_bvh_matches_jax(name):
    mesh = MESHES[name]()
    want = j_validate_bvh(j_build_bvh(mesh, as_numpy=True))
    got = tb.validate_bvh(tb.build_bvh(_t_mesh(mesh), device="cpu"))
    assert got == want
    assert got["n_leaves"] == mesh.n_faces


def test_validate_bvh_catches_a_broken_link():
    bvh = tb.build_bvh(_t_mesh(MESHES["room"]()), device="cpu")
    nodes_i = bvh.nodes.view(torch.int32)
    assert int(nodes_i[-1, 13]) == int(SENTINEL_LINK)  # the last leaf in preorder ends the walk
    nodes_i[-1, 13] = 0  # its miss link back to the root: a cycle
    with pytest.raises(AssertionError):
        tb.validate_bvh(bvh)


def test_bvh_from_arrays_copies_bits():
    a = j_build_bvh(MESHES["building"](), as_numpy=True)
    arrays = {f: np.asarray(getattr(a, f))
              for f in ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")}
    b = bvh_from_arrays(arrays, device="cpu")
    np.testing.assert_array_equal(arrays["nodes"].view(np.int32),
                                  b.nodes.view(torch.int32).numpy())
    assert int(b.root_link) == 0 and int(b.n_tris) == int(a.n_tris)
    with pytest.raises(ValueError, match="unknown"):
        bvh_from_arrays(dict(arrays, extra=np.zeros(1)), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        bvh_from_arrays(dict(arrays, nodes=arrays["nodes"].astype(np.float64)), device="cpu")


def test_mesh_map_bvh_and_device_rule(monkeypatch):
    mesh = jm.make_room_scene(n_pillars=2, seed=1)
    mm = MeshMap.from_mesh(_t_mesh(mesh), device="cpu")
    want = j_build_bvh(mesh, as_numpy=True)
    np.testing.assert_array_equal(np.asarray(want.nodes).view(np.int32),
                                  mm.bvh.nodes.view(torch.int32).numpy())
    assert mm.bvh.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.build_bvh(_t_mesh(mesh))


def test_native_builders_raise(monkeypatch):
    """Without the native library, build_bvh_sah raises as JAX's does and
    build_bvh_auto takes the LBVH; with it, auto is the SAH build."""
    mesh = MESHES["room"]()
    if native.available():
        np.testing.assert_array_equal(_bits(tb.build_bvh_auto(_t_mesh(mesh), device="cpu")),
                                      _bits(tb.build_bvh_sah(_t_mesh(mesh), device="cpu")))
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="native builder library unavailable"):
        tb.build_bvh_sah(_t_mesh(mesh), device="cpu")
    np.testing.assert_array_equal(_bits(tb.build_bvh_auto(_t_mesh(mesh), device="cpu")),
                                  np.asarray(j_build_bvh(mesh, as_numpy=True).nodes).view(np.int32))


def _bits(bvh):
    return bvh.nodes.view(torch.int32).numpy()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_sah_bitwise(name):
    """The native binned-SAH build, slot for slot as JAX's (its threads
    build subtrees in parallel, but the preorder slots depend only on the
    tree), a valid threaded tree; build_bvh_auto picks as JAX's does."""
    mesh = MESHES[name]()
    want = j_build_bvh_sah(mesh, as_numpy=True)
    got = tb.build_bvh_sah(_t_mesh(mesh), device="cpu")
    np.testing.assert_array_equal(_bits(got), np.asarray(want.nodes).view(np.int32))
    assert int(got.root_link) == int(want.root_link) and int(got.n_tris) == mesh.n_faces
    np.testing.assert_array_equal(got.aabb_min.numpy(), np.asarray(want.aabb_min))
    np.testing.assert_array_equal(got.aabb_max.numpy(), np.asarray(want.aabb_max))
    assert tb.validate_bvh(got)["n_leaves"] == mesh.n_faces
    np.testing.assert_array_equal(_bits(tb.build_bvh_auto(_t_mesh(mesh), device="cpu")),
                                  np.asarray(j_build_bvh_auto(mesh, as_numpy=True).nodes)
                                  .view(np.int32))


def test_decode_link():
    link = torch.tensor([0, 5, ~0, ~7, int(SENTINEL_LINK)], dtype=torch.int32)
    is_leaf, idx = decode_link(link)
    assert is_leaf.tolist() == [False, False, True, True, True]
    assert idx.tolist()[:4] == [0, 5, 0, 7]
