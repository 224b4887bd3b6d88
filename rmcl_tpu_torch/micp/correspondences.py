"""Correspondence search for MICP-L.

Counterpart of ``rmcl_tpu.micp.correspondences``: ray-cast correspondences
(:func:`find_rcc`) on the dense binned engine. Closest-point
correspondences (``find_cpc``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.sensors.models import SensorModel
from rmcl_tpu_torch.sensors.simulate import simulate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Correspondences:
    """Dataset↔model correspondence buffers in the sensor frame."""

    model_points: Tensor  # (N, 3)
    model_normals: Tensor  # (N, 3) unit, oriented toward the sensor
    found: Tensor  # (N,) bool — the simulated ray hit


def find_rcc(bins: TriangleBins, model: SensorModel, tsm: Transform,
             c_super: int = 24, c_bin: int = 96) -> Correspondences:
    """Ray-cast correspondences: one simulated hit per sensor pixel from the
    current pose estimate ``tsm`` (sensor→map)."""
    hits = simulate(bins, model, tsm, c_super=c_super, c_bin=c_bin)
    return Correspondences(
        model_points=hits.point, model_normals=hits.normal, found=hits.hit
    )
