"""Triangle meshes: host-side container, the OBJ loader, procedural meshes.

Counterpart of ``rmcl_tpu.geom.mesh``, kept as host-side numpy so that the
two packages emit identical arrays. Of the file loaders only OBJ is ported
so far; the procedural generators are the ones the tests and the chip smoke
use (sphere, box, plane, room, building).
"""

from __future__ import annotations

import dataclasses
import os

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
    """Load a mesh by file extension. Only ``.obj`` is ported so far."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".obj":
        raise NotImplementedError(
            f"mesh format '{ext}' is not ported yet (have ['.obj'])"
        )
    mesh = load_obj(path)
    mesh.name = os.path.basename(path)
    return mesh


def _fan_triangulate(idx: list[int]) -> list[list[int]]:
    return [[idx[0], idx[i], idx[i + 1]] for i in range(1, len(idx) - 1)]


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
