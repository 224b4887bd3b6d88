"""The benchmark's frozen world: the building, the VLP-16's rays and the loop.

The building generator is a copy of the port's ``geom/mesh.py``
``make_building_scene`` (with ``make_plane``, ``make_box`` and the wall
panels) as it stood when the benchmark was written, so that a later edit to
the program cannot change the inputs. Everything here is numpy or plain
torch and imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _grid_faces(subdiv: int) -> np.ndarray:
    faces = []
    for i in range(subdiv):
        for j in range(subdiv):
            a = i * (subdiv + 1) + j
            b, c = a + 1, a + subdiv + 1
            faces.append([a, c, b])
            faces.append([b, c, c + 1])
    return np.asarray(faces, np.int32).reshape(-1, 3)


def _plane(size, center, subdiv):
    sx, sy = np.asarray(size, np.float32) * 0.5
    gx, gy = np.meshgrid(np.linspace(-sx, sx, subdiv + 1), np.linspace(-sy, sy, subdiv + 1),
                         indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3) + np.asarray(
        center, np.float32)
    return verts.astype(np.float32), _grid_faces(subdiv)


def _box(size, center):
    sx, sy, sz = np.asarray(size, np.float32) * 0.5
    cx, cy, cz = center
    verts = np.asarray([[cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
                        [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
                        [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
                        [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz]], np.float32)
    quads = [[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4], [2, 3, 7, 6], [1, 2, 6, 5], [3, 0, 4, 7]]
    faces = [[q[0], q[i], q[i + 1]] for q in quads for i in range(1, 3)]
    return verts, np.asarray(faces, np.int32)


def _wall(p0, p1, height, z0=0.0, subdiv=1):
    p0, p1 = np.asarray(p0, np.float32), np.asarray(p1, np.float32)
    ts = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    zs = np.linspace(z0, z0 + height, subdiv + 1, dtype=np.float32)
    line = p0[None] + ts[:, None] * (p1 - p0)[None]
    verts = np.concatenate([np.repeat(line, subdiv + 1, axis=0),
                            np.tile(zs, subdiv + 1)[:, None]], axis=1).astype(np.float32)
    return verts, _grid_faces(subdiv)


def building(rooms_x=4, rooms_y=3, room_size=6.0, height=3.0, door_width=1.2, subdiv=45,
             n_clutter=2, seed=0, door_t=0.5):
    """A grid of rooms joined by door openings and cluttered with boxes:
    (vertices (V, 3) float32, faces (F, 3) int32). ``door_t`` None draws
    each door's place from the seed, as the program's generator does."""
    rng = np.random.default_rng(seed)
    W, H = rooms_x * room_size, rooms_y * room_size
    n = subdiv * max(rooms_x, rooms_y)
    parts = [_plane((W, H), (W / 2, H / 2, 0.0), n), _plane((W, H), (W / 2, H / 2, height), n)]

    def wall_with_door(p0, p1, t):
        p0, p1 = np.asarray(p0, np.float32), np.asarray(p1, np.float32)
        half = door_width / 2.0 / float(np.linalg.norm(p1 - p0))
        t0, t1 = t - half, t + half
        if t0 > 1e-3:
            parts.append(_wall(p0, p0 + t0 * (p1 - p0), height, subdiv=subdiv))
        if t1 < 1.0 - 1e-3:
            parts.append(_wall(p0 + t1 * (p1 - p0), p1, height, subdiv=subdiv))
        parts.append(_wall(p0 + t0 * (p1 - p0), p0 + t1 * (p1 - p0), height / 3.0,
                           z0=height * 2.0 / 3.0, subdiv=max(1, subdiv // 2)))

    parts.append(_wall((0, 0), (W, 0), height, subdiv=subdiv * rooms_x))
    parts.append(_wall((0, H), (W, H), height, subdiv=subdiv * rooms_x))
    parts.append(_wall((0, 0), (0, H), height, subdiv=subdiv * rooms_y))
    parts.append(_wall((W, 0), (W, H), height, subdiv=subdiv * rooms_y))
    for ix in range(1, rooms_x):
        for iy in range(rooms_y):
            wall_with_door((ix * room_size, iy * room_size), (ix * room_size, (iy + 1) * room_size),
                           door_t if door_t is not None else float(rng.uniform(0.25, 0.75)))
    for iy in range(1, rooms_y):
        for ix in range(rooms_x):
            wall_with_door((ix * room_size, iy * room_size), ((ix + 1) * room_size, iy * room_size),
                           door_t if door_t is not None else float(rng.uniform(0.25, 0.75)))
    for ix in range(rooms_x):
        for iy in range(rooms_y):
            for _ in range(n_clutter):
                cx = ix * room_size + rng.uniform(1.0, room_size - 1.0)
                cy = iy * room_size + rng.uniform(1.0, room_size - 1.0)
                dims = rng.uniform(0.3, 1.2, 2)
                h = rng.uniform(0.4, height * 0.8)
                parts.append(_box((dims[0], dims[1], h), (cx, cy, h / 2)))
    offsets = np.cumsum([0] + [len(v) for v, _ in parts[:-1]])
    return (np.concatenate([v for v, _ in parts], 0).astype(np.float32),
            np.concatenate([f + o for (_, f), o in zip(parts, offsets)], 0).astype(np.int32))


def make_map(spec: dict):
    """The map a configuration names: ``spec`` is its ``map`` entry."""
    keys = ("rooms_x", "rooms_y", "room_size", "height", "door_width", "subdiv", "n_clutter",
            "seed", "door_t")
    if spec["generator"] != "building":
        raise ValueError(f"unknown map generator {spec['generator']!r}")
    return building(**{k: spec[k] for k in keys})


def _f32(x: float) -> float:
    return float(np.float32(x))


def spherical_dirs(spec: dict) -> np.ndarray:
    """Unit ray directions (height * width, 3) of a spherical lidar in the
    sensor frame, row-major (``id = v * width + u``): azimuth steps of
    (theta_max - theta_min) / width, elevation steps including both ends."""
    w, h = int(spec["width"]), int(spec["height"])
    th_inc = _f32((spec["theta_max"] - spec["theta_min"]) / w)
    ph_inc = _f32((spec["phi_max"] - spec["phi_min"]) / (h - 1)) if h > 1 else 0.0
    theta = (np.float32(_f32(spec["theta_min"]))
             + np.arange(w, dtype=np.float32) * np.float32(th_inc))
    phi = np.float32(_f32(spec["phi_min"])) + np.arange(h, dtype=np.float32) * np.float32(ph_inc)
    ce = np.cos(phi)[:, None]
    d = np.stack([np.broadcast_to(ce * np.cos(theta)[None, :], (h, w)),
                  np.broadcast_to(ce * np.sin(theta)[None, :], (h, w)),
                  np.broadcast_to(np.sin(phi)[:, None], (h, w))], -1)
    return d.reshape(-1, 3).astype(np.float32)


def loop_poses(spec: dict) -> np.ndarray:
    """The closed loop's true base poses (L, 6) as (x, y, z, roll, pitch,
    yaw): ``poses`` points on a circle, heading along it counter-clockwise."""
    cx, cy, z = spec["center"]
    r, n = float(spec["radius"]), int(spec["poses"])
    a = 2.0 * math.pi * np.arange(n) / n
    yaw = np.arctan2(np.sin(a + math.pi / 2), np.cos(a + math.pi / 2))
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a), np.full(n, z), np.zeros(n),
                     np.zeros(n), yaw], -1)


def euler_matrix(roll, pitch, yaw) -> np.ndarray:
    """Rz(yaw) Ry(pitch) Rx(roll), float64 (..., 3, 3)."""
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1)], -2)


def pose_matrix(pose6) -> np.ndarray:
    """A 4 x 4 float64 matrix of an (x, y, z, roll, pitch, yaw) pose."""
    m = np.eye(4)
    m[:3, :3] = euler_matrix(*pose6[3:6])
    m[:3, 3] = pose6[:3]
    return m


def triangles(vertices: np.ndarray, faces: np.ndarray, device) -> torch.Tensor:
    """(F, 3, 3) float32 triangle corners on ``device``."""
    return torch.from_numpy(vertices[faces]).to(device)
