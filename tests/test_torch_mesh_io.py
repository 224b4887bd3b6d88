"""The port's mesh loaders and map registry against the JAX package's, on
the same file bytes.

Every loader is host-side numpy in both packages, so the arrays must agree
bit for bit: vertices float32 and faces int32, exactly. The cases are the
files that ``tests/test_mesh_io.py`` writes (each of its tests runs with
its loaders replaced by a twin that loads the same path through both
packages, compares, and hands the JAX mesh back to the test's own
assertions), plus files written here for what it does not write: STL
(ASCII, binary, binary under a 'solid' header), OFF, COLLADA
polygons/rotate/scale/X_UP, and glTF side buffers, strips, fans, matrices
and every index width."""

import base64
import json
import struct

import numpy as np
import pytest
import torch

import test_mesh_io
from rmcl_tpu.geom import map as jmap
from rmcl_tpu.geom import mesh as jm
from rmcl_tpu_torch.geom import map as tmap
from rmcl_tpu_torch.geom import mesh as tm

torch.set_num_threads(2)

_LOADERS = [n for n in dir(jm) if n.startswith("load_")]


def _assert_same_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype == np.float32
    assert a.faces.dtype == b.faces.dtype == np.int32
    np.testing.assert_array_equal(a.vertices.view(np.int32), b.vertices.view(np.int32))
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.name == b.name


@pytest.fixture
def twins(monkeypatch):
    """Replace every loader that ``tests/test_mesh_io.py`` calls by a twin
    that loads through both packages and compares; returns the list of
    paths compared."""
    compared = []

    def twin(name):
        def both(path, *args, **kw):
            a = getattr(jm, name)(path, *args, **kw)
            b = getattr(tm, name)(path, *args, **kw)
            _assert_same_mesh(a, b)
            compared.append(str(path))
            return a
        return both

    for name in _LOADERS:
        if hasattr(test_mesh_io, name):
            monkeypatch.setattr(test_mesh_io, name, twin(name))
    return compared, twin("load_mesh")


# -- files the JAX tests do not write ------------------------------------------


def _box():
    return jm.make_box(size=(2.0, 1.0, 3.0), center=(0.5, -0.25, 1.0))


def _write_stl_ascii(path):
    tris = _box().triangles()
    with open(path, "w") as f:
        f.write("solid box\n")
        for t in tris:
            f.write("  facet normal 0 0 0\n    outer loop\n")
            for v in t:
                f.write(f"      vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
            f.write("    endloop\n  endfacet\n")
        f.write("endsolid box\n")
    return path


def _write_stl_binary(path, header=b"binary stl"):
    tris = _box().triangles().astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.ljust(80, b" "))
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0.0, 0.0, 0.0) + t.tobytes() + b"\0\0")
    return path


def _write_off(path):
    verts = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1.25]]
    faces = [[0, 1, 2, 3], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]
    with open(path, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
        f.writelines(f"{v[0]} {v[1]} {v[2]}\n" for v in verts)
        f.writelines(f"{len(fc)} {' '.join(map(str, fc))}\n" for fc in faces)
    return path


_DAE_POLYGONS = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><unit meter="0.5"/><up_axis>X_UP</up_axis></asset>
 <library_geometries>
  <geometry id="g"><mesh>
   <source id="p"><float_array id="a" count="15">0 0 0 1 0 0 1 1 0 0 1 0 0.5 0.5 1</float_array>
    <technique_common><accessor source="#a" count="5" stride="3"/></technique_common></source>
   <vertices id="v"><input semantic="POSITION" source="#p"/></vertices>
   <polygons count="2"><input semantic="VERTEX" source="#v" offset="0"/>
    <p>0 1 2 3</p><p>0 1 4</p></polygons>
  </mesh></geometry>
 </library_geometries>
 <library_visual_scenes><visual_scene id="s">
  <node><rotate>0 0 1 30</rotate><scale>1 2 0.5</scale><translate>1 2 3</translate>
   <instance_geometry url="#g"/></node>
 </visual_scene></library_visual_scenes>
</COLLADA>
"""


def _write_dae_polygons(path):
    path.write_text(_DAE_POLYGONS)
    return path


def _gltf_modes(path, side_buffer):
    """One glTF with a strip (uint8 indices), a fan (uint32), a non-indexed
    triangle list under a matrix node and a TRS node; its buffer inline
    (.gltf, data URI) or beside it (a URL-quoted .bin name)."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [2, 0, 0], [2, 1, 0.5]],
                     np.float32)
    strip = np.asarray([0, 1, 2, 3, 4, 5], np.uint8)
    fan = np.asarray([0, 1, 3, 2, 5], np.uint32)
    chunks = [pos.tobytes(), strip.tobytes().ljust(8, b"\0"), fan.tobytes()]
    offs = np.cumsum([0] + [len(c) for c in chunks])
    buf = b"".join(chunks)
    doc = {
        "asset": {"version": "2.0"},
        "bufferViews": [{"buffer": 0, "byteOffset": int(o), "byteLength": len(c)}
                        for o, c in zip(offs, chunks)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 6, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5125, "count": 5, "type": "SCALAR"},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1, "mode": 5},
            {"attributes": {"POSITION": 0}, "indices": 2, "mode": 6},
            {"attributes": {"POSITION": 0}},
            {"attributes": {"POSITION": 0}, "mode": 1},  # lines: skipped
        ]}],
        "nodes": [
            {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 3, 2, 1, 1]},
            {"mesh": 0, "translation": [0.5, 0, 0], "rotation": [0, 0, 0.38268343, 0.9238795],
             "scale": [1, 2, 1]},
        ],
        "scenes": [{"nodes": [0, 1]}],
    }
    if side_buffer:
        (path.parent / "side buffer.bin").write_bytes(buf)
        doc["buffers"] = [{"byteLength": len(buf), "uri": "side%20buffer.bin"}]
    else:
        doc["buffers"] = [{"byteLength": len(buf), "uri": "data:application/octet-stream;"
                           "base64," + base64.b64encode(buf).decode()}]
    path.write_text(json.dumps(doc))
    return path


_WRITTEN = {
    "stl_ascii": lambda d: _write_stl_ascii(d / "box.stl"),
    "stl_binary": lambda d: _write_stl_binary(d / "box_bin.stl"),
    "stl_binary_solid_header": lambda d: _write_stl_binary(d / "solid.stl", b"solid but binary"),
    "off": lambda d: _write_off(d / "pyramid.off"),
    "dae_polygons_x_up": lambda d: _write_dae_polygons(d / "polygons.dae"),
    "gltf_modes_inline": lambda d: _gltf_modes(d / "modes.gltf", side_buffer=False),
    "gltf_modes_side_buffer": lambda d: _gltf_modes(d / "side.gltf", side_buffer=True),
}
_JAX_CASES = sorted(n for n in dir(test_mesh_io) if n.startswith("test_"))


@pytest.mark.parametrize("case", _JAX_CASES + sorted(_WRITTEN))
def test_loaders_match_jax_bitwise(case, twins, tmp_path):
    """Each file, loaded by both packages, gives bitwise-equal arrays."""
    compared, load_both = twins
    if case in _WRITTEN:
        load_both(str(_WRITTEN[case](tmp_path)))
    else:
        getattr(test_mesh_io, case)(tmp_path)
    assert compared, f"{case} loaded no file"


def test_load_mesh_refuses_what_jax_refuses(tmp_path):
    path = str(tmp_path / "cloud.xyz")
    for pkg in (jm, tm):
        with pytest.raises(ValueError, match="unsupported mesh format '.xyz'"):
            pkg.load_mesh(path)


def test_map_container_matches_jax(tmp_path):
    """The registry loads a file once per name; its map's bins and BVH are
    bitwise the JAX map's."""
    path = str(tmp_path / "ball.ply")
    mesh = jm.make_sphere(16, 16)
    test_mesh_io._write_ply_binary(path, mesh.vertices, mesh.faces.tolist(), ">")
    jc, tc = jmap.MapContainer(), tmap.MapContainer(device="cpu")
    a, b = jc.load("world", path), tc.load("world", path)
    assert tc.get("world") is b and "world" in tc and "other" not in tc
    assert tc.load("world", mesh) is b  # a loaded name is not replaced
    _assert_same_mesh(a.mesh, b.mesh)
    np.testing.assert_array_equal(np.asarray(a.bvh.nodes).view(np.int32),
                                  b.bvh.nodes.view(torch.int32).numpy())
    np.testing.assert_array_equal(np.asarray(a.bins.tri), b.bins.tri.numpy())
    m = tc.load("mem", tm.make_sphere(16, 16))
    assert m.name == "mem" and m.bins.device.type == "cpu"
    assert torch.equal(m.bins.tri, b.bins.tri)
