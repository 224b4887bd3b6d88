"""Map segmentation: classify scan points as dynamic obstacles or stale map.

Counterpart of ``rmcl_tpu.ops.segmentation`` (the reference's
map-segmentation filter nodes, scan_map_segmentation_embree.cpp:100-195,
o1dn_map_segmentation_embree.cpp): simulate the sensor from the localized
pose, compare the real scan beam by beam with the simulated range by the
point-to-plane distance, and classify

  * scan outliers — a real return in front of the map surface by more than
    ``min_dist_outlier_scan``: a dynamic obstacle not in the map;
  * map outliers  — a real return behind the simulated surface (or a
    simulated hit with no real return) by more than
    ``min_dist_outlier_map``: stale or wrong map geometry.

Dense masks (no data-dependent sizes) and the points they select.
"""

from __future__ import annotations

import dataclasses

import torch

from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.sensors.models import SensorModel
from rmcl_tpu_torch.sensors.simulate import simulate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SegmentationResult:
    """Dense per-beam classification (sensor frame)."""

    scan_outlier: Tensor  # (N,) bool — dynamic obstacle candidates
    map_outlier: Tensor  # (N,) bool — stale map geometry candidates
    scan_points: Tensor  # (N, 3) real points (valid where scan_outlier)
    map_points: Tensor  # (N, 3) simulated points (valid where map_outlier)
    plane_dist: Tensor  # (N,) point-to-plane distance (0 where undefined)


def segment_scan(
    bvh: BVH,
    model: SensorModel,
    tsm: Transform,
    ranges_real: Tensor,
    min_dist_outlier_scan: float = 0.15,
    min_dist_outlier_map: float = 0.15,
    chunk_size: int = 262144,
    mask_real: Tensor | None = None,
) -> SegmentationResult:
    """Classify one scan against the map from pose ``tsm`` (sensor -> map),
    on the BVH's device (the exact cast, K5).

    Decision table (the reference's):
      real valid, sim valid, real < sim, plane_dist > thresh → scan outlier
      real valid, sim valid, real >= sim, plane_dist > thresh → map outlier
      real valid, sim invalid → scan outlier
      real invalid, sim valid → map outlier

    ``mask_real`` optionally ANDs the RangeData.mask channel into the
    real-validity gate (dropped beams are neither scan nor map outliers).
    """
    dev = bvh.device
    ranges_real = torch.as_tensor(ranges_real, dtype=torch.float32).to(dev)
    sim = simulate(bvh, model, tsm, chunk_size=chunk_size)
    o_s, d_s = model.rays(dev)

    real_valid = model.range.contains(ranges_real)
    if mask_real is not None:
        # dropped beams encoded as in-range sentinels (range 0 with
        # range_min 0, the pointcloud_to_o1dn convention) must not classify
        # as dynamic obstacles
        real_valid = real_valid & torch.as_tensor(mask_real, dtype=torch.bool).to(dev)
    sim_valid = sim.hit & model.range.contains(sim.t)

    p_real = o_s + d_s * ranges_real[..., None]
    p_sim = sim.point  # sensor frame
    n_sim = sim.normal

    signed = torch.sum((p_real - p_sim) * n_sim, dim=-1)
    plane_dist = torch.where(sim_valid, torch.abs(signed), 0.0)

    in_front = ranges_real < sim.t
    scan_outlier = real_valid & (
        (sim_valid & in_front & (plane_dist > min_dist_outlier_scan)) | ~sim_valid)
    map_outlier = ((real_valid & sim_valid & ~in_front & (plane_dist > min_dist_outlier_map))
                   | (~real_valid & sim_valid))

    return SegmentationResult(
        scan_outlier=scan_outlier,
        map_outlier=map_outlier,
        scan_points=torch.where(real_valid[..., None], p_real, 0.0),
        map_points=torch.where(sim_valid[..., None], p_sim, 0.0),
        plane_dist=plane_dist,
    )
