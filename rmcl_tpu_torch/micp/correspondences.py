"""Correspondence search for MICP-L.

Counterpart of ``rmcl_tpu.micp.correspondences``: ray-cast correspondences
(:func:`find_rcc`) and closest-point correspondences (:func:`find_cpc`),
each on a ``BVH`` (the exact engine) or on ``TriangleBins`` (the dense
binned engine).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops.closest_point import closest_points, closest_points_binned
from rmcl_tpu_torch.sensors.models import SensorModel
from rmcl_tpu_torch.sensors.simulate import simulate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Correspondences:
    """Dataset↔model correspondence buffers in the sensor frame.
    ``truncated``: of a closest-point search on bins, the count (an int64
    device scalar) of query blocks whose candidate list a budget cut; None
    for every other search."""

    model_points: Tensor  # (N, 3)
    model_normals: Tensor  # (N, 3) unit, oriented toward the sensor
    found: Tensor  # (N,) bool — sim hit (RC) / within max_dist (CP)
    truncated: Optional[Tensor] = None


def find_rcc(bvh: "BVH | TriangleBins", model: SensorModel, tsm: Transform,
             chunk_size: int = 262144, c_super: int = 24, c_bin: int = 96, c_mid: int = 0,
             c_hyper: int = 0) -> Correspondences:
    """Ray-cast correspondences: one simulated hit per sensor pixel from the
    current pose estimate ``tsm`` (sensor→map); ``model`` may be a
    :class:`~rmcl_tpu_torch.sensors.models.RaySliceModel`, a rank's window of
    the sensor's pixels in the sharded correction. ``c_super``/``c_bin``/
    ``c_mid``/``c_hyper`` tune the dense engine when ``bvh`` is bins
    (``c_mid > 0``: the mid level; ``c_hyper > 0``: the hyper level)."""
    if isinstance(bvh, TriangleBins):
        hits = simulate(bvh, model, tsm, c_super=c_super, c_bin=c_bin, c_mid=c_mid,
                        c_hyper=c_hyper)
    else:
        hits = simulate(bvh, model, tsm, chunk_size=chunk_size)
    return Correspondences(
        model_points=hits.point, model_normals=hits.normal, found=hits.hit
    )


def find_cpc(bvh: "BVH | TriangleBins", dataset_points: Tensor, dataset_mask: Tensor,
             tsm: Transform, max_dist, chunk_size: int = 65536, c_super: int = 24,
             c_bin: int = 96, cluster_by: Tensor | None = None) -> Correspondences:
    """Closest-point correspondences: for every dataset point (sensor frame)
    the nearest mesh surface point within ``max_dist`` (the reference's
    CPCEmbree::find: into the map frame, closest point, back into the
    sensor frame, found = within ``max_dist``). ``bvh`` may be
    ``TriangleBins``; the dense binned distance engine then serves the
    query, in blocks of the Morton order of ``cluster_by`` (N, 3) where
    given, else of the map-frame points, and ``truncated`` counts the
    blocks its budgets cut (on the device, no sync)."""
    p_map = tsm.apply(dataset_points)
    truncated = None
    if isinstance(bvh, TriangleBins):
        cp, sat = closest_points_binned(bvh, p_map, max_dist=max_dist, c_super=c_super,
                                        c_bin=c_bin, with_sat=True, cluster_by=cluster_by)
        truncated = torch.sum(sat, dtype=torch.int64)
    else:
        cp = closest_points(bvh, p_map, max_dist=max_dist, chunk_size=chunk_size)
    inv = tsm.inverse()
    found = dataset_mask & cp.found
    # orient normals toward the query point (a consistent signed distance)
    to_q = p_map - cp.point
    sign = torch.where(torch.sum(cp.normal * to_q, dim=-1) < 0, -1.0, 1.0)
    normal = cp.normal * sign[..., None]
    found3 = found[..., None]
    return Correspondences(
        model_points=torch.where(found3, inv.apply(cp.point), 0.0),
        model_normals=torch.where(found3, inv.rotate(normal), 0.0),
        found=found,
        truncated=truncated,
    )
