"""Triangle meshes: host-side container, file loaders, procedural meshes.

Counterpart of ``rmcl_tpu.geom.mesh``, kept as host-side numpy so that the
two packages emit identical arrays, bit for bit. File formats (self-contained
parsers on ``struct``, ``json``, ``base64``, ``zipfile`` and ``xml.etree``):
OBJ, ASCII/binary STL, ASCII/binary PLY, OFF, COLLADA DAE, glTF/GLB, 3MF,
X3D, 3DS. The procedural generators are the ones the tests and the chip
smoke use (sphere, box, plane, room, building).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """Host-side indexed triangle mesh.

    vertices: (V, 3) float32
    faces:    (F, 3) int32
    """

    vertices: np.ndarray
    faces: np.ndarray
    name: str = "mesh"

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be (V,3), got {self.vertices.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be (F,3), got {self.faces.shape}")

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) expanded triangle vertices."""
        return self.vertices[self.faces]

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(0), self.vertices.max(0)

    def concat(self, other: "TriangleMesh") -> "TriangleMesh":
        return TriangleMesh(
            np.concatenate([self.vertices, other.vertices]),
            np.concatenate([self.faces, other.faces + self.n_vertices]),
            self.name,
        )


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def load_mesh(path: str) -> TriangleMesh:
    """Load a mesh by file extension (.obj/.stl/.ply/.off/.dae/.gltf/.glb/
    .3mf/.x3d/.3ds), dispatching as the JAX package does."""
    ext = os.path.splitext(path)[1].lower()
    loaders = {
        ".obj": load_obj, ".stl": load_stl, ".ply": load_ply,
        ".off": load_off, ".dae": load_dae,
        ".gltf": load_gltf, ".glb": load_gltf,
        ".3mf": load_3mf, ".x3d": load_x3d, ".3ds": load_3ds,
    }
    if ext not in loaders:
        raise ValueError(f"unsupported mesh format '{ext}' (have {sorted(loaders)})")
    mesh = loaders[ext](path)
    mesh.name = os.path.basename(path)
    return mesh


def _fan_triangulate(idx: list[int]) -> list[list[int]]:
    return [[idx[0], idx[i], idx[i + 1]] for i in range(1, len(idx) - 1)]


def _strip_triangulate(idx: list[int]) -> list[list[int]]:
    """Triangle-strip expansion with alternating winding and -1 restart
    markers (PLY `tristrips` convention: VTK/Stanford exports)."""
    out: list[list[int]] = []
    run: list[int] = []
    for v in idx:
        if v < 0:  # restart marker
            run = []
            continue
        run.append(v)
        if len(run) >= 3:
            a, b, c = run[-3], run[-2], run[-1]
            if a != b and b != c and a != c:
                # alternate winding so normals stay consistent
                if (len(run) - 3) % 2 == 0:
                    out.append([a, b, c])
                else:
                    out.append([b, a, c])
    return out


def load_obj(path: str) -> TriangleMesh:
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                faces.extend(_fan_triangulate(idx))
    return TriangleMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def load_stl(path: str) -> TriangleMesh:
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # could still be binary with a 'solid' header; try ascii first
            try:
                return _load_stl_ascii(path)
            except Exception:
                pass
        return _load_stl_binary(f.read())


def _load_stl_ascii(path: str) -> TriangleMesh:
    tris = []
    with open(path, "r") as f:
        cur: list[list[float]] = []
        for line in f:
            line = line.strip()
            if line.startswith("vertex"):
                parts = line.split()
                cur.append([float(parts[1]), float(parts[2]), float(parts[3])])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError("no triangles in ascii stl")
    return _mesh_from_triangle_soup(np.asarray(tris, np.float32))


def _load_stl_binary(data: bytes) -> TriangleMesh:
    n = struct.unpack("<I", data[80:84])[0]
    rec = np.frombuffer(data[84 : 84 + n * 50], dtype=np.uint8).reshape(n, 50)
    floats = rec[:, :48].copy().view(np.float32).reshape(n, 4, 3)
    return _mesh_from_triangle_soup(floats[:, 1:4])


def _mesh_from_triangle_soup(tris: np.ndarray) -> TriangleMesh:
    """De-duplicate vertices of a (T,3,3) triangle soup."""
    flat = tris.reshape(-1, 3)
    uniq, inverse = np.unique(flat.round(7), axis=0, return_inverse=True)
    return TriangleMesh(uniq.astype(np.float32), inverse.reshape(-1, 3).astype(np.int32))


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriangleMesh:
    """PLY loader: ascii, binary_little_endian and binary_big_endian,
    arbitrary vertex properties, fan-triangulated n-gon faces
    (reference loads via Assimp — rmagine import_embree_map et al.)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", "replace")

    fmt = "ascii"
    endian = "<"
    # elements: list of (name, count, props) where props is a list of
    # ("scalar", pname, dtype) or ("list", pname, count_dtype, item_dtype)
    elements: list[tuple[str, int, list]] = []
    for ln in (x.strip() for x in header.splitlines()):
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == "format":
            if parts[1] == "ascii":
                fmt = "ascii"
            elif parts[1] == "binary_little_endian":
                fmt, endian = "binary", "<"
            elif parts[1] == "binary_big_endian":
                fmt, endian = "binary", ">"
            else:
                raise ValueError(f"unknown PLY format {parts[1]}")
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[4], _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]]))
            else:
                elements[-1][2].append(("scalar", parts[2], _PLY_TYPES[parts[1]]))

    verts = None
    faces: list[list[int]] = []

    if fmt == "ascii":
        body = data[header_end:].decode("ascii").split()
        pos = 0
        for name, cnt, props in elements:
            if name == "vertex":
                k = len(props)
                vals = np.asarray(body[pos : pos + cnt * k], np.float64).reshape(cnt, k)
                cols = [i for i, p in enumerate(props) if p[1] in ("x", "y", "z")]
                verts = vals[:, cols[:3]].astype(np.float32)
                pos += cnt * k
            elif name in ("face", "tristrips"):
                tris = _strip_triangulate if name == "tristrips" else _fan_triangulate
                for _ in range(cnt):
                    k = int(body[pos])
                    idx = [int(x) for x in body[pos + 1 : pos + 1 + k]]
                    faces.extend(tris(idx))
                    pos += 1 + k
            else:  # skip foreign elements (only possible when scalar-only)
                if any(p[0] == "list" for p in props):
                    raise ValueError(f"cannot skip PLY list element {name!r}")
                pos += cnt * len(props)
        if verts is None:
            raise ValueError(f"{path}: PLY file without a vertex element")
        return TriangleMesh(verts, np.asarray(faces, np.int32).reshape(-1, 3))

    # --- binary ----------------------------------------------------------
    buf = data[header_end:]
    off = 0
    for name, cnt, props in elements:
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(p[1], endian + p[2]) for p in props])
            arr = np.frombuffer(buf, dtype=dt, count=cnt, offset=off)
            off += dt.itemsize * cnt
            if name == "vertex":
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=1
                ).astype(np.float32)
            continue
        # list element (faces): fast path assumes a uniform list length,
        # verified against the consumed byte count; falls back to a scan
        if name != "face" and name != "tristrips":
            raise ValueError(f"unsupported PLY list element {name!r}")
        p = props[0]
        cdt = np.dtype(endian + p[2])
        idt = np.dtype(endian + p[3])
        if cnt == 0:
            continue
        first_k = int(np.frombuffer(buf, dtype=cdt, count=1, offset=off)[0])
        stride = cdt.itemsize + first_k * idt.itemsize
        uniform = off + stride * cnt <= len(buf)
        if uniform:
            rows = np.frombuffer(buf, np.uint8, count=stride * cnt, offset=off).reshape(cnt, stride)
            ks = rows[:, : cdt.itemsize].copy().view(cdt)[:, 0]
            uniform = bool((ks == first_k).all())
        tris = _strip_triangulate if name == "tristrips" else _fan_triangulate
        if uniform and name != "tristrips":
            idx = rows[:, cdt.itemsize :].copy().view(idt).reshape(cnt, first_k)
            if first_k == 3:
                new = idx.astype(np.int32)
            else:
                new = np.concatenate(
                    [np.stack([idx[:, 0], idx[:, i], idx[:, i + 1]], 1)
                     for i in range(1, first_k - 1)], 0
                ).astype(np.int32)
            off += stride * cnt
        else:  # ragged lists / tristrips: per-row scan
            out: list[list[int]] = []
            for _ in range(cnt):
                k = int(np.frombuffer(buf, dtype=cdt, count=1, offset=off)[0])
                idx1 = np.frombuffer(buf, dtype=idt, count=k, offset=off + cdt.itemsize)
                out.extend(tris([int(x) for x in idx1]))
                off += cdt.itemsize + k * idt.itemsize
            new = np.asarray(out, np.int32).reshape(-1, 3)
        # accumulate: a file may carry both `face` and `tristrips` elements
        if len(faces):
            faces = np.concatenate(
                [np.asarray(faces, np.int32).reshape(-1, 3), new], 0
            )
        else:
            faces = new
    if verts is None:
        raise ValueError(f"{path}: PLY file without a vertex element")
    return TriangleMesh(verts, np.asarray(faces, np.int32).reshape(-1, 3))


def load_off(path: str) -> TriangleMesh:
    with open(path, "r") as f:
        toks = f.read().split()
    if not toks or toks[0] != "OFF":
        raise ValueError(f"{path} is not an OFF file (missing the OFF header)")
    nv, nf = int(toks[1]), int(toks[2])
    pos = 4
    verts = np.asarray(toks[pos : pos + nv * 3], np.float32).reshape(nv, 3)
    pos += nv * 3
    faces: list[list[int]] = []
    for _ in range(nf):
        k = int(toks[pos])
        idx = [int(x) for x in toks[pos + 1 : pos + 1 + k]]
        faces.extend(_fan_triangulate(idx))
        pos += 1 + k
    return TriangleMesh(verts, np.asarray(faces, np.int32))


def load_dae(path: str) -> TriangleMesh:
    """COLLADA (.dae) triangle-mesh loader — the common ROS/Gazebo map
    format the reference imports through Assimp (rmagine import_*_map).

    Supports: <triangles>, <polylist> and <polygons> primitives (n-gons
    fan-triangulated), multi-input index strides, instance_geometry nodes
    with <matrix>/<translate>/<rotate>/<scale> transform stacks (baked to
    world space), <instance_node> references into <library_nodes>
    (SketchUp/Gazebo component instancing), <unit meter=...> scaling, and
    Y_UP -> Z_UP conversion (ROS convention is Z-up). Geometries not
    referenced by any visual scene are appended untransformed."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    q = lambda tag: f"{ns}{tag}"

    # --- asset: unit scale + up axis --------------------------------------
    scale = 1.0
    up = "Z_UP"
    asset = root.find(q("asset"))
    if asset is not None:
        unit = asset.find(q("unit"))
        if unit is not None and unit.get("meter"):
            scale = float(unit.get("meter"))
        up_el = asset.find(q("up_axis"))
        if up_el is not None and up_el.text:
            up = up_el.text.strip()

    # --- geometries -------------------------------------------------------
    def parse_geometry(geom) -> Optional[TriangleMesh]:
        mesh_el = geom.find(q("mesh"))
        if mesh_el is None:  # splines / convex_mesh unsupported
            return None
        sources = {}
        for src in mesh_el.findall(q("source")):
            arr = src.find(q("float_array"))
            if arr is None or arr.text is None:
                continue
            vals = np.asarray((arr.text or "").split(), dtype=np.float64)
            stride = 3
            tc = src.find(f"{q('technique_common')}/{q('accessor')}")
            if tc is not None and tc.get("stride"):
                stride = int(tc.get("stride"))
            sources["#" + src.get("id", "")] = vals.reshape(-1, stride)
        # <vertices> indirection: position input by reference
        vert_map = {}
        for v in mesh_el.findall(q("vertices")):
            for inp in v.findall(q("input")):
                if inp.get("semantic") == "POSITION":
                    vert_map["#" + v.get("id", "")] = inp.get("source")
        verts_out, faces_out = [], []
        v_off = 0
        for prim_tag in ("triangles", "polylist", "polygons"):
            for prim in mesh_el.findall(q(prim_tag)):
                inputs = prim.findall(q("input"))
                stride = 1
                v_offset, v_source = 0, None
                for inp in inputs:
                    off = int(inp.get("offset", 0))
                    stride = max(stride, off + 1)
                    if inp.get("semantic") == "VERTEX":
                        v_offset = off
                        v_source = vert_map.get(inp.get("source"), inp.get("source"))
                if v_source is None or v_source not in sources:
                    continue
                pos = sources[v_source][:, :3]
                p_els = prim.findall(q("p"))
                if not p_els:
                    continue
                idx_all = []
                if prim_tag == "triangles":
                    p = np.asarray((p_els[0].text or "").split(), dtype=np.int64)
                    vi = p.reshape(-1, 3 * stride)[:, v_offset::stride]
                    idx_all = vi.reshape(-1, 3).tolist()
                elif prim_tag == "polylist":
                    vc_el = prim.find(q("vcount"))
                    vcount = np.asarray((vc_el.text or "").split(), dtype=np.int64)
                    p = np.asarray((p_els[0].text or "").split(), dtype=np.int64)
                    vi = p[v_offset::stride]
                    c = 0
                    for k in vcount:
                        idx_all.extend(_fan_triangulate(list(vi[c : c + k])))
                        c += k
                else:  # polygons: one <p> per polygon
                    for p_el in p_els:
                        p = np.asarray((p_el.text or "").split(), dtype=np.int64)
                        idx_all.extend(_fan_triangulate(list(p[v_offset::stride])))
                if not idx_all:
                    continue
                verts_out.append(pos)
                faces_out.append(np.asarray(idx_all, np.int64) + v_off)
                v_off += pos.shape[0]
        if not verts_out:
            return None
        return TriangleMesh(
            np.concatenate(verts_out, 0).astype(np.float32),
            np.concatenate(faces_out, 0).astype(np.int32),
            name=geom.get("id", "geometry"),
        )

    geoms = {}
    lib = root.find(q("library_geometries"))
    if lib is not None:
        for geom in lib.findall(q("geometry")):
            m = parse_geometry(geom)
            if m is not None:
                geoms["#" + geom.get("id", "")] = m

    # --- visual scene: node transform stacks ------------------------------
    def node_matrix(node) -> np.ndarray:
        M = np.eye(4)
        for el in node:
            tag = el.tag.replace(ns, "")
            txt = (el.text or "").strip()
            if tag == "matrix":
                M = M @ np.asarray(txt.split(), dtype=np.float64).reshape(4, 4)
            elif tag == "translate":
                T = np.eye(4)
                T[:3, 3] = np.asarray(txt.split(), dtype=np.float64)[:3]
                M = M @ T
            elif tag == "rotate":
                x, y, z, deg = np.asarray(txt.split(), dtype=np.float64)[:4]
                a = np.deg2rad(deg)
                axis = np.asarray([x, y, z])
                n = np.linalg.norm(axis)
                if n > 0:
                    axis = axis / n
                    K = np.asarray([
                        [0, -axis[2], axis[1]],
                        [axis[2], 0, -axis[0]],
                        [-axis[1], axis[0], 0],
                    ])
                    Rm = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
                    R4 = np.eye(4)
                    R4[:3, :3] = Rm
                    M = M @ R4
            elif tag == "scale":
                S = np.diag(np.append(np.asarray(txt.split(), dtype=np.float64)[:3], 1.0))
                M = M @ S
        return M

    placed, used = [], set()

    # <library_nodes> definitions, addressable via <instance_node url="#id">
    # (SketchUp/Gazebo component instancing)
    lib_nodes = {}
    ln = root.find(q("library_nodes"))
    if ln is not None:
        for node in ln.findall(q("node")):
            nid = node.get("id")
            if nid:
                lib_nodes["#" + nid] = node

    def walk(node, M, depth=0):
        if depth > 64:  # cyclic instance_node guard
            return
        M = M @ node_matrix(node)
        for ig in node.findall(q("instance_geometry")):
            url = ig.get("url", "")
            if url in geoms:
                used.add(url)
                g = geoms[url]
                v = g.vertices @ M[:3, :3].T + M[:3, 3]
                placed.append((v, g.faces))
        for inode in node.findall(q("instance_node")):
            target = lib_nodes.get(inode.get("url", ""))
            if target is not None:
                walk(target, M, depth + 1)
        for child in node.findall(q("node")):
            walk(child, M, depth)

    scenes = root.find(q("library_visual_scenes"))
    if scenes is not None:
        for vs in scenes.findall(q("visual_scene")):
            for node in vs.findall(q("node")):
                walk(node, np.eye(4))
    # geometries never instanced: append untransformed (matches Assimp's
    # flat import of scene-less files)
    for url, g in geoms.items():
        if url not in used:
            placed.append((g.vertices.astype(np.float64), g.faces))

    if not placed:
        raise ValueError(f"no triangle geometry found in {path}")
    v_off = 0
    verts, faces = [], []
    for v, f in placed:
        verts.append(v)
        faces.append(f.astype(np.int64) + v_off)
        v_off += v.shape[0]
    V = np.concatenate(verts, 0) * scale
    F = np.concatenate(faces, 0)
    if up == "Y_UP":  # (x, y, z)_yup -> (x, -z, y)_zup
        V = np.stack([V[:, 0], -V[:, 2], V[:, 1]], -1)
    elif up == "X_UP":  # cyclic permutation keeps handedness: z_up = x_file
        V = np.stack([V[:, 1], V[:, 2], V[:, 0]], -1)
    return TriangleMesh(V.astype(np.float32), F.astype(np.int32))


def load_gltf(path: str) -> TriangleMesh:
    """glTF 2.0 (.gltf JSON + external/embedded buffers, .glb binary)
    triangle-mesh loader — rounds out the Assimp format breadth the
    reference relies on (rmagine import_*_map via AssimpIO).

    Supports: GLB container (BIN chunk), external .bin buffers, base64
    data-URI buffers; POSITION accessors (float VEC3, incl. byteStride
    interleaving); indexed + non-indexed primitives; TRIANGLES /
    TRIANGLE_STRIP / TRIANGLE_FAN modes; uint8/16/32 indices; the full
    node hierarchy with per-node ``matrix`` or TRS, baked to world space.
    glTF is Y-up by convention -> converted to Z-up (ROS convention),
    matching the load_dae behavior. Sparse accessors and Draco/meshopt
    compression are not supported (raise)."""
    import base64
    import json
    import struct

    ext = os.path.splitext(path)[1].lower()
    glb_bin = None
    if ext == ".glb":
        with open(path, "rb") as f:
            data = f.read()
        magic, version, _length = struct.unpack_from("<III", data, 0)
        if magic != 0x46546C67:  # 'glTF'
            raise ValueError(f"{path}: not a GLB container")
        if version != 2:
            raise ValueError(f"{path}: unsupported GLB version {version}")
        off = 12
        doc = None
        while off + 8 <= len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # 'JSON'
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # 'BIN\0'
                glb_bin = chunk
            # chunks are 4-byte aligned; well-formed writers include the
            # padding in clen, but tolerate unpadded ones
            off += 8 + clen
            off += (-off) % 4
        if doc is None:
            raise ValueError(f"{path}: GLB has no JSON chunk")
        g = doc
    else:
        with open(path, "r") as f:
            g = json.load(f)

    for ex in g.get("extensionsRequired", []):
        raise ValueError(f"{path}: required glTF extension '{ex}' unsupported")

    base_dir = os.path.dirname(os.path.abspath(path))
    buffers: list[bytes] = []
    for buf in g.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise ValueError(f"{path}: buffer without uri outside GLB")
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            from urllib.parse import unquote

            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(f.read())

    views = g.get("bufferViews", [])
    accessors = g.get("accessors", [])
    _CTYPE = {
        5120: np.int8, 5121: np.uint8, 5122: np.int16,
        5123: np.uint16, 5125: np.uint32, 5126: np.float32,
    }
    _NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
              "MAT3": 9, "MAT4": 16}

    def read_accessor(ai: int) -> np.ndarray:
        acc = accessors[ai]
        if "sparse" in acc:
            raise ValueError(f"{path}: sparse accessors unsupported")
        dt = np.dtype(_CTYPE[acc["componentType"]])
        nc = _NCOMP[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:  # zero-initialized per spec
            return np.zeros((count, nc), dt)
        view = views[acc["bufferView"]]
        raw = buffers[view["buffer"]]
        base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dt.itemsize * nc
        if stride == dt.itemsize * nc:
            out = np.frombuffer(raw, dt, count * nc, base).reshape(count, nc)
        else:  # interleaved: strided window per element. A spec-valid tight
            # bufferView only guarantees (count-1)*stride + elemSize bytes
            # (the final stride may be cut after the last attribute), so
            # read exactly that and stride over it.
            elem = dt.itemsize * nc
            nbytes = (count - 1) * stride + elem if count else 0
            flat = np.frombuffer(raw, np.uint8, nbytes, base)
            rowbytes = np.lib.stride_tricks.as_strided(
                flat, shape=(count, elem), strides=(stride, 1)
            )
            out = np.ascontiguousarray(rowbytes).view(dt)
        return out.reshape(count, nc)

    placed: list[tuple[np.ndarray, np.ndarray]] = []

    def add_mesh(mi: int, M: np.ndarray) -> None:
        for prim in g["meshes"][mi].get("primitives", []):
            mode = prim.get("mode", 4)
            if mode not in (4, 5, 6):  # triangles / strip / fan only
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = read_accessor(attrs["POSITION"]).astype(np.float64)[:, :3]
            if "indices" in prim:
                idx = read_accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            if mode == 4:
                faces = idx[: idx.size - idx.size % 3].reshape(-1, 3)
            elif mode == 5:  # strip, no restart markers in glTF
                faces = np.asarray(
                    _strip_triangulate(idx.tolist()), np.int64
                ).reshape(-1, 3)
            else:  # fan
                faces = np.asarray(
                    _fan_triangulate(idx.tolist()), np.int64
                ).reshape(-1, 3)
            if faces.size == 0:
                continue
            placed.append((pos @ M[:3, :3].T + M[:3, 3], faces))

    def node_matrix(node: dict) -> np.ndarray:
        if "matrix" in node:  # column-major per spec
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        M = np.eye(4)
        t = node.get("translation")
        r = node.get("rotation")  # (x, y, z, w)
        s = node.get("scale")
        if t is not None:
            M[:3, 3] = t
        if r is not None:
            x, y, z, w = r
            M[:3, :3] = np.asarray([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
        if s is not None:
            M[:3, :3] = M[:3, :3] @ np.diag(np.asarray(s, np.float64))
        return M

    nodes = g.get("nodes", [])

    def walk(ni: int, M: np.ndarray, depth: int = 0) -> None:
        if depth > 256:
            return
        node = nodes[ni]
        M = M @ node_matrix(node)
        if "mesh" in node:
            add_mesh(node["mesh"], M)
        for ci in node.get("children", []):
            walk(ci, M, depth + 1)

    scenes = g.get("scenes", [])
    scene_roots: list[int] = []
    if scenes:
        scene_roots = scenes[g.get("scene", 0)].get("nodes", [])
    if scene_roots:
        for ni in scene_roots:
            walk(ni, np.eye(4))
    elif nodes:
        # no scene: every node is a root (spec allows scene-less assets)
        child_set = {c for n in nodes for c in n.get("children", [])}
        for ni in range(len(nodes)):
            if ni not in child_set:
                walk(ni, np.eye(4))
    else:
        for mi in range(len(g.get("meshes", []))):
            add_mesh(mi, np.eye(4))

    if not placed:
        raise ValueError(f"no triangle geometry found in {path}")
    v_off = 0
    verts, faces = [], []
    for v, f in placed:
        verts.append(v)
        faces.append(f + v_off)
        v_off += v.shape[0]
    V = np.concatenate(verts, 0)
    F = np.concatenate(faces, 0)
    # glTF is +Y up / -Z forward; ROS maps are Z-up
    V = np.stack([V[:, 0], -V[:, 2], V[:, 1]], -1)
    return TriangleMesh(V.astype(np.float32), F.astype(np.int32))


def load_3mf(path: str) -> TriangleMesh:
    """3MF (.3mf) loader — OPC zip container with a core-spec model XML.

    Widens the Assimp format set the reference's map import accepts
    (micp_localization.cpp:320-332 inspects arbitrary assimp scenes).
    Supports: `<object type="model">` meshes, `<components>` instancing
    (recursive, with 4x3 row-major 3MF transforms), and `<build>` items;
    objects unreferenced by the build are appended untransformed. 3MF is
    Z-up already (printing convention) — no axis swap."""
    import io
    import xml.etree.ElementTree as ET
    import zipfile

    with zipfile.ZipFile(path) as z:
        model_name = None
        # OPC: the root model part is named by the package relationships
        # (_rels/.rels, relationship type .../3dmodel); fall back to the
        # first *.model member only when the rels part is absent/unreadable
        try:
            rels = ET.parse(io.BytesIO(z.read("_rels/.rels"))).getroot()
            for rel in rels:
                if rel.get("Type", "").endswith("3dmodel"):
                    target = rel.get("Target", "").lstrip("/")
                    if target in z.namelist():
                        model_name = target
                        break
        except (KeyError, ET.ParseError):
            pass
        if model_name is None:
            for n in z.namelist():
                if n.lower().endswith(".model"):
                    model_name = n
                    break
        if model_name is None:
            raise ValueError(f"no .model part in 3MF archive {path}")
        root = ET.parse(io.BytesIO(z.read(model_name))).getroot()

    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    q = lambda tag: f"{ns}{tag}"

    # 3MF core spec: model/@unit defaults to MILLIMETER. Scale to the
    # metre-based map frame (same policy as load_dae's <unit meter=.../>).
    unit_scale = {
        "micron": 1e-6,
        "millimeter": 1e-3,
        "centimeter": 1e-2,
        "inch": 0.0254,
        "foot": 0.3048,
        "meter": 1.0,
    }.get((root.get("unit") or "millimeter").lower(), 1e-3)

    def parse_transform(attr: Optional[str]) -> np.ndarray:
        """3MF transform: 12 floats, 4x3 row-major (rows = basis + origin,
        row-vector convention). Return a 4x4 column-vector matrix."""
        M = np.eye(4)
        if attr:
            v = np.asarray(attr.split(), np.float64)
            if v.size != 12:
                raise ValueError(f"3MF transform needs 12 floats, got {v.size}")
            M[:3, :3] = v.reshape(4, 3)[:3].T
            M[:3, 3] = v.reshape(4, 3)[3]
        return M

    objects: dict[str, ET.Element] = {}
    resources = root.find(q("resources"))
    if resources is not None:
        for obj in resources.findall(q("object")):
            objects[obj.get("id", "")] = obj

    placed: list[tuple[np.ndarray, np.ndarray]] = []
    used: set[str] = set()

    def emit(oid: str, M: np.ndarray, depth: int = 0, skip_used: bool = False) -> None:
        if depth > 64 or oid not in objects:
            return
        if skip_used and oid in used:
            return  # fallback pass: object already placed via build/earlier fallback
        used.add(oid)
        obj = objects[oid]
        mesh_el = obj.find(q("mesh"))
        if mesh_el is not None:
            vs = [
                [float(v.get("x", 0)), float(v.get("y", 0)), float(v.get("z", 0))]
                for v in mesh_el.find(q("vertices")).findall(q("vertex"))
            ]
            ts = [
                [int(t.get("v1")), int(t.get("v2")), int(t.get("v3"))]
                for t in mesh_el.find(q("triangles")).findall(q("triangle"))
            ]
            if vs and ts:
                V = np.asarray(vs, np.float64)
                V = V @ M[:3, :3].T + M[:3, 3]
                placed.append((V, np.asarray(ts, np.int64)))
        comps = obj.find(q("components"))
        if comps is not None:
            for c in comps.findall(q("component")):
                emit(
                    c.get("objectid", ""),
                    M @ parse_transform(c.get("transform")),
                    depth + 1,
                    skip_used,
                )

    build = root.find(q("build"))
    if build is not None:
        for item in build.findall(q("item")):
            emit(item.get("objectid", ""), parse_transform(item.get("transform")))
    for oid in objects:  # resources never built (spec allows it); skip_used
        # prevents re-emitting objects already placed (directly or as a
        # component) when a later unbuilt assembly references them
        if oid not in used:
            emit(oid, np.eye(4), skip_used=True)

    if not placed:
        raise ValueError(f"no triangle geometry found in {path}")
    v_off, verts, faces = 0, [], []
    for V, F in placed:
        verts.append(V * unit_scale)
        faces.append(F + v_off)
        v_off += V.shape[0]
    return TriangleMesh(
        np.concatenate(verts, 0).astype(np.float32),
        np.concatenate(faces, 0).astype(np.int32),
    )


def load_x3d(path: str) -> TriangleMesh:
    """X3D (.x3d) loader — XML-encoded successor of VRML.

    Supports: `IndexedFaceSet` (coordIndex with -1 separators, n-gons
    fan-triangulated), `IndexedTriangleSet` (index triples), `Coordinate`
    point arrays with DEF/USE reuse, and nested `Transform` nodes
    (translation / center / rotation axis-angle / scale). X3D is Y-up
    (VRML convention) — converted to the Z-up ROS map frame like the
    glTF loader."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""

    def local(el) -> str:
        return el.tag.rsplit("}", 1)[-1]

    def floats(attr: Optional[str]) -> np.ndarray:
        return np.asarray((attr or "").replace(",", " ").split(), np.float64)

    def ints(attr: Optional[str]) -> np.ndarray:
        toks = (attr or "").replace(",", " ").split()
        return np.asarray(toks, np.int64) if toks else np.zeros((0,), np.int64)

    def transform_matrix(el) -> np.ndarray:
        t = floats(el.get("translation")) if el.get("translation") else np.zeros(3)
        c = floats(el.get("center")) if el.get("center") else np.zeros(3)
        s = floats(el.get("scale")) if el.get("scale") else np.ones(3)
        R = np.eye(3)
        if el.get("rotation"):
            x, y, z, ang = floats(el.get("rotation"))
            axis = np.asarray([x, y, z], np.float64)
            n = np.linalg.norm(axis)
            if n > 0 and ang != 0.0:
                axis /= n
                K = np.array(
                    [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
                )
                R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        # X3D: P' = T * C * R * S * -C  (scaleOrientation omitted)
        M = np.eye(4)
        M[:3, :3] = R @ np.diag(s)
        M[:3, 3] = t + c - M[:3, :3] @ c
        return M

    defs: dict[str, np.ndarray] = {}
    placed: list[tuple[np.ndarray, np.ndarray]] = []

    def coord_points(geom_el) -> Optional[np.ndarray]:
        for ch in geom_el:
            if local(ch) == "Coordinate":
                if ch.get("USE"):
                    return defs.get(ch.get("USE"))
                pts = floats(ch.get("point")).reshape(-1, 3)
                if ch.get("DEF"):
                    defs[ch.get("DEF")] = pts
                return pts
        return None

    def walk(el, M: np.ndarray, depth: int = 0) -> None:
        if depth > 256:
            return
        tag = local(el)
        if tag == "Transform":
            M = M @ transform_matrix(el)
        if tag in ("IndexedFaceSet", "IndexedTriangleSet"):
            pts = coord_points(el)
            if pts is not None and pts.size:
                if tag == "IndexedTriangleSet":
                    tris = ints(el.get("index")).reshape(-1, 3).tolist()
                else:
                    tris, run = [], []
                    for i in ints(el.get("coordIndex")).tolist():
                        if i < 0:
                            if len(run) >= 3:
                                tris.extend(_fan_triangulate(run))
                            run = []
                        else:
                            run.append(i)
                    if len(run) >= 3:
                        tris.extend(_fan_triangulate(run))
                if tris:
                    V = pts @ M[:3, :3].T + M[:3, 3]
                    placed.append((V, np.asarray(tris, np.int64)))
        for ch in el:
            walk(ch, M, depth + 1)

    scene = root.find(f"{ns}Scene")
    walk(scene if scene is not None else root, np.eye(4))
    if not placed:
        raise ValueError(f"no triangle geometry found in {path}")
    v_off, verts, faces = 0, [], []
    for V, F in placed:
        verts.append(V)
        faces.append(F + v_off)
        v_off += V.shape[0]
    V = np.concatenate(verts, 0)
    F = np.concatenate(faces, 0)
    V = np.stack([V[:, 0], -V[:, 2], V[:, 1]], -1)  # Y-up -> Z-up
    return TriangleMesh(V.astype(np.float32), F.astype(np.int32))


def load_3ds(path: str) -> TriangleMesh:
    """3D Studio (.3ds) loader — legacy binary chunk format still common
    for CAD-exported building shells.

    Walks MAIN(0x4D4D) -> EDITOR(0x3D3D) -> OBJECT(0x4000) ->
    TRIMESH(0x4100) chunks and reads POINT_ARRAY(0x4110) +
    FACE_ARRAY(0x4120). Vertices in a .3ds are stored in world space
    (the 0x4160 local-axis chunk only matters for the keyframer), and
    the format is Z-up — both match the ROS map frame, so no transform
    is applied."""
    data = open(path, "rb").read()
    if len(data) < 6 or struct.unpack_from("<H", data, 0)[0] != 0x4D4D:
        raise ValueError(f"{path} is not a 3DS file (missing 0x4D4D magic)")

    placed: list[tuple[np.ndarray, np.ndarray]] = []

    def walk(start: int, end: int, depth: int = 0) -> None:
        pos = start
        while pos + 6 <= end:
            cid, clen = struct.unpack_from("<HI", data, pos)
            if clen < 6 or pos + clen > end:
                break  # malformed tail: stop scanning this level
            body = pos + 6
            if cid in (0x4D4D, 0x3D3D) and depth < 8:
                walk(body, pos + clen, depth + 1)
            elif cid == 0x4000 and depth < 8:  # named object: skip cstr name
                nul = data.find(b"\x00", body, pos + clen)
                if nul < 0:
                    break  # malformed: name never terminates in this chunk
                walk(nul + 1, pos + clen, depth + 1)
            elif cid == 0x4100 and depth < 8:  # triangle mesh
                V = F = None
                p = body
                while p + 6 <= pos + clen:
                    sid, slen = struct.unpack_from("<HI", data, p)
                    if slen < 6 or p + slen > pos + clen:
                        break
                    if sid == 0x4110:  # point array
                        (n,) = struct.unpack_from("<H", data, p + 6)
                        V = np.frombuffer(data, np.float32, n * 3, p + 8).reshape(-1, 3)
                    elif sid == 0x4120:  # face array: v1 v2 v3 flags
                        (n,) = struct.unpack_from("<H", data, p + 6)
                        F = np.frombuffer(data, np.uint16, n * 4, p + 8).reshape(-1, 4)[:, :3]
                    p += slen
                if V is not None and F is not None and len(V) and len(F):
                    placed.append((np.array(V, np.float64), np.array(F, np.int64)))
            pos += clen

    walk(0, len(data))
    if not placed:
        raise ValueError(f"no triangle geometry found in {path}")
    v_off, verts, faces = 0, [], []
    for V, F in placed:
        verts.append(V)
        faces.append(F + v_off)
        v_off += V.shape[0]
    return TriangleMesh(
        np.concatenate(verts, 0).astype(np.float32),
        np.concatenate(faces, 0).astype(np.int32),
    )


def save_obj(mesh: TriangleMesh, path: str) -> None:
    """Write ``mesh`` as an OBJ file (the JAX package's writer: numpy's
    shortest float repr, so :func:`load_obj` reads the vertices back bit
    for bit)."""
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------
# Procedural meshes
# ---------------------------------------------------------------------------


def make_sphere(
    n_lat: int = 100, n_lon: int = 100, radius: float = 1.0, center=(0.0, 0.0, 0.0)
) -> TriangleMesh:
    """UV sphere with ~2*n_lat*n_lon faces — the reference benchmark's
    synthetic parametric sphere."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = radius * np.sin(theta) * np.cos(phi)
    y = radius * np.sin(theta) * np.sin(phi)
    z = radius * np.cos(theta)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) + np.asarray(center, np.float32)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append([a, c, b])
            if i < n_lat - 1:
                faces.append([b, c, d])
    return TriangleMesh(verts.astype(np.float32), np.asarray(faces, np.int32), "sphere")


def make_box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0), inward: bool = False) -> TriangleMesh:
    """Axis-aligned box. ``inward=True`` flips winding so normals face the
    interior."""
    sx, sy, sz = np.asarray(size, np.float32) * 0.5
    cx, cy, cz = center
    verts = np.asarray(
        [
            [cx - sx, cy - sy, cz - sz],
            [cx + sx, cy - sy, cz - sz],
            [cx + sx, cy + sy, cz - sz],
            [cx - sx, cy + sy, cz - sz],
            [cx - sx, cy - sy, cz + sz],
            [cx + sx, cy - sy, cz + sz],
            [cx + sx, cy + sy, cz + sz],
            [cx - sx, cy + sy, cz + sz],
        ],
        np.float32,
    )
    quads = [
        [0, 3, 2, 1],  # bottom (outward -z)
        [4, 5, 6, 7],  # top
        [0, 1, 5, 4],  # front
        [2, 3, 7, 6],  # back
        [1, 2, 6, 5],  # right
        [3, 0, 4, 7],  # left
    ]
    faces = []
    for q in quads:
        faces.extend(_fan_triangulate(q))
    faces = np.asarray(faces, np.int32)
    if inward:
        faces = faces[:, [0, 2, 1]]
    return TriangleMesh(verts, faces, "box")


def _grid_faces(subdiv: int) -> list[list[int]]:
    faces = []
    for i in range(subdiv):
        for j in range(subdiv):
            a = i * (subdiv + 1) + j
            b = a + 1
            c = a + subdiv + 1
            d = c + 1
            faces.append([a, c, b])
            faces.append([b, c, d])
    return faces


def make_plane(size=(10.0, 10.0), center=(0.0, 0.0, 0.0), subdiv: int = 1) -> TriangleMesh:
    """Z-up ground plane with optional subdivision."""
    sx, sy = np.asarray(size, np.float32) * 0.5
    xs = np.linspace(-sx, sx, subdiv + 1)
    ys = np.linspace(-sy, sy, subdiv + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3) + np.asarray(
        center, np.float32
    )
    return TriangleMesh(verts.astype(np.float32),
                        np.asarray(_grid_faces(subdiv), np.int32), "plane")


def make_room_scene(size=(10.0, 8.0, 3.0), n_pillars: int = 4, seed: int = 0) -> TriangleMesh:
    """An inward-facing room with random box pillars."""
    rng = np.random.default_rng(seed)
    mesh = make_box(size, (0, 0, size[2] / 2), inward=True)
    for _ in range(n_pillars):
        pos = rng.uniform([-size[0] / 2 + 1, -size[1] / 2 + 1], [size[0] / 2 - 1, size[1] / 2 - 1])
        dims = rng.uniform(0.3, 1.0, 2)
        h = rng.uniform(0.5, size[2])
        pillar = make_box((dims[0], dims[1], h), (pos[0], pos[1], h / 2))
        mesh = mesh.concat(pillar)
    mesh.name = "room"
    return mesh


def _wall_panel(p0, p1, height, z0=0.0, subdiv=1) -> TriangleMesh:
    """Vertical rectangular panel from p0 (x,y) to p1 (x,y), subdivided.
    Ray casting treats triangles as two-sided."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    ts = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    zs = np.linspace(z0, z0 + height, subdiv + 1, dtype=np.float32)
    line = p0[None] + ts[:, None] * (p1 - p0)[None]  # (s+1, 2)
    verts = np.concatenate(
        [
            np.repeat(line, subdiv + 1, axis=0),
            np.tile(zs, subdiv + 1)[:, None],
        ],
        axis=1,
    ).astype(np.float32)
    return TriangleMesh(verts, np.asarray(_grid_faces(subdiv), np.int32), "wall")


def make_building_scene(
    rooms_x: int = 4,
    rooms_y: int = 3,
    room_size: float = 6.0,
    height: float = 3.0,
    door_width: float = 1.2,
    subdiv: int = 4,
    n_clutter: int = 2,
    seed: int = 0,
    door_t: float | None = None,
) -> TriangleMesh:
    """Multi-room building floor: a grid of rooms joined by door openings,
    cluttered with random boxes (rooms 4x3: subdiv 14 ≈ 47k tris, subdiv
    45 ≈ 480k tris). ``door_t`` fixes every door at that fractional wall
    position; None keeps random doors."""
    rng = np.random.default_rng(seed)
    W, H = rooms_x * room_size, rooms_y * room_size
    parts = []

    # floor + ceiling
    parts.append(
        make_plane((W, H), (W / 2, H / 2, 0.0), subdiv=subdiv * max(rooms_x, rooms_y))
    )
    parts.append(
        make_plane((W, H), (W / 2, H / 2, height), subdiv=subdiv * max(rooms_x, rooms_y))
    )

    def wall_with_door(p0, p1, door_center_t):
        """Wall from p0 to p1 with a door gap around fractional position t."""
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        length = float(np.linalg.norm(p1 - p0))
        half = door_width / 2.0 / length
        t0, t1 = door_center_t - half, door_center_t + half
        segs = []
        if t0 > 1e-3:
            segs.append(_wall_panel(p0, p0 + t0 * (p1 - p0), height, subdiv=subdiv))
        if t1 < 1.0 - 1e-3:
            segs.append(_wall_panel(p0 + t1 * (p1 - p0), p1, height, subdiv=subdiv))
        # lintel above the door (door height = 2/3 of wall height)
        segs.append(
            _wall_panel(
                p0 + t0 * (p1 - p0),
                p0 + t1 * (p1 - p0),
                height / 3.0,
                z0=height * 2.0 / 3.0,
                subdiv=max(1, subdiv // 2),
            )
        )
        return segs

    # outer walls (no doors)
    parts.append(_wall_panel((0, 0), (W, 0), height, subdiv=subdiv * rooms_x))
    parts.append(_wall_panel((0, H), (W, H), height, subdiv=subdiv * rooms_x))
    parts.append(_wall_panel((0, 0), (0, H), height, subdiv=subdiv * rooms_y))
    parts.append(_wall_panel((W, 0), (W, H), height, subdiv=subdiv * rooms_y))

    # inner walls with doors
    for ix in range(1, rooms_x):
        x = ix * room_size
        for iy in range(rooms_y):
            y0, y1 = iy * room_size, (iy + 1) * room_size
            parts.extend(
                wall_with_door((x, y0), (x, y1),
                               door_t if door_t is not None
                               else float(rng.uniform(0.25, 0.75)))
            )
    for iy in range(1, rooms_y):
        y = iy * room_size
        for ix in range(rooms_x):
            x0, x1 = ix * room_size, (ix + 1) * room_size
            parts.extend(
                wall_with_door((x0, y), (x1, y),
                               door_t if door_t is not None
                               else float(rng.uniform(0.25, 0.75)))
            )

    # clutter boxes per room
    for ix in range(rooms_x):
        for iy in range(rooms_y):
            for _ in range(n_clutter):
                cx = ix * room_size + rng.uniform(1.0, room_size - 1.0)
                cy = iy * room_size + rng.uniform(1.0, room_size - 1.0)
                dims = rng.uniform(0.3, 1.2, 2)
                h = rng.uniform(0.4, height * 0.8)
                parts.append(make_box((dims[0], dims[1], h), (cx, cy, h / 2)))

    # single concatenate (pairwise concat over ~80 parts is O(parts^2))
    offsets = np.cumsum([0] + [p.n_vertices for p in parts[:-1]])
    return TriangleMesh(
        np.concatenate([p.vertices for p in parts], 0),
        np.concatenate([p.faces + o for p, o in zip(parts, offsets)], 0),
        "building",
    )
