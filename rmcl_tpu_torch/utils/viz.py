"""Visualization exports: particle clouds, correspondences, scans.

Counterpart of ``rmcl_tpu.utils.viz``. The reference publishes RViz markers
and annotated PointCloud2s (particle clouds with likelihood, sigma, n_meas
and badness channels, rmcl_localization.cpp:797-879; correspondence line
markers, MICPSensorCUDA.cpp:15-104). Without a middleware the same
artifacts export to PLY, written on the host from tensors on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rmcl_tpu_torch.convert import to_numpy as _np
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.micp.correspondences import Correspondences


def particle_cloud_channels(cloud: ParticleCloud) -> dict:
    """The reference's per-particle channels: likelihood, sigma, n_meas and
    'badness' (uncertainty-weighted — rmcl_localization.cpp:816-876)."""
    lik = _np(cloud.likelihood.mean)
    sigma = _np(cloud.likelihood.sigma)
    n = _np(cloud.likelihood.n_meas)
    badness = (1.0 - lik / max(lik.max(), 1e-12)) * np.sqrt(np.maximum(sigma, 0.0) + 1.0 / np.maximum(n, 1e-3))
    return {
        "xyz": _np(cloud.poses.trans),
        "likelihood": lik,
        "sigma": sigma,
        "n_meas": n,
        "badness": badness,
        "alive": _np(cloud.alive),
    }


def save_particles_ply(path: str, cloud: ParticleCloud) -> None:
    """Particles as a colored PLY point cloud (likelihood → red..green)."""
    ch = particle_cloud_channels(cloud)
    xyz = ch["xyz"][ch["alive"]]
    lik = ch["likelihood"][ch["alive"]]
    # degenerate clouds (nothing alive) export an empty file, not a crash
    w = lik / max(float(lik.max()) if lik.size else 0.0, 1e-12)
    r = ((1.0 - w) * 255).astype(np.uint8)
    g = (w * 255).astype(np.uint8)
    b = np.zeros_like(r)
    _write_ply_points(path, xyz, np.stack([r, g, b], -1))


def save_correspondences_ply(
    path: str,
    dataset_points: np.ndarray,
    corr: Correspondences,
    mask: Optional[np.ndarray] = None,
) -> None:
    """P2L correspondence line list (the reference's drawCorrespondences —
    MICPSensorCUDA.cpp:64-104: dataset point → plane projection)."""
    d = _np(dataset_points)
    m = _np(corr.model_points)
    n = _np(corr.model_normals)
    ok = _np(corr.found)
    if mask is not None:
        ok = ok & _np(mask)
    signed = np.einsum("nj,nj->n", n, d - m)
    proj = d - signed[:, None] * n
    a, b = d[ok], proj[ok]
    verts = np.concatenate([a, b], axis=0).astype(np.float32)
    k = len(a)
    edges = np.stack([np.arange(k), np.arange(k) + k], -1)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {k}\n"
            "property int vertex1\nproperty int vertex2\nend_header\n"
        )
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")


def save_scan_ply(path: str, points: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
    pts = _np(points)
    if mask is not None:
        pts = pts[_np(mask)]
    _write_ply_points(path, pts, None)


def _write_ply_points(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray]) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(xyz):
            line = f"{p[0]} {p[1]} {p[2]}"
            if rgb is not None:
                line += f" {rgb[i][0]} {rgb[i][1]} {rgb[i][2]}"
            f.write(line + "\n")
