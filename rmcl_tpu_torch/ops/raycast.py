"""Ray-hit record shared by the ray engines.

Counterpart of the ``RayHits`` contract of ``rmcl_tpu.ops.raycast``. The
exact BVH traversal of that module is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# t of a ray that hit nothing
NO_HIT_T = 3.0e38


@dataclasses.dataclass(frozen=True)
class RayHits:
    """SoA hit record for a batch of rays."""

    t: Tensor  # (...,) hit distance (NO_HIT_T when missed)
    hit: Tensor  # (...,) bool
    prim_id: Tensor  # (...,) int32 original face id (-1 when missed)
    inst_id: Tensor  # (...,) int32 instance id (-1 when missed)
    point: Tensor  # (..., 3) hit point in ray frame (orig + t*dir)
    normal: Tensor  # (..., 3) geometric unit normal
