"""Particle statistics: likelihood statistics, the weighted mean pose and
its covariance.

Counterpart of ``rmcl_tpu.mcl.stats`` (reference RmclNode::estimateStats).
The reduction runs on the cloud's device; ``max_induction_particles``
restricts it to the first particles, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import pose_covariance_6x6, weighted_pose_mean
from rmcl_tpu_torch.mcl.particles import ParticleCloud

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParticleStats:
    """Mirror of the reference's rmcl_msgs/ParticleStats."""

    pose: Transform  # weighted mean pose (base -> map)
    covariance: Tensor  # (6, 6)
    likelihood_mean: Tensor
    likelihood_sigma: Tensor
    likelihood_min: Tensor
    likelihood_max: Tensor
    shift: Tensor  # = likelihood_min, as the reference keeps it
    trans_bb_min: Tensor  # (3,)
    trans_bb_max: Tensor  # (3,)
    n_particles: Tensor


def estimate_stats(cloud: ParticleCloud,
                   max_induction_particles: Optional[int] = None) -> ParticleStats:
    if max_induction_particles is not None and max_induction_particles < cloud.capacity:
        cloud = cloud.map(lambda x: x[:max_induction_particles])
    L = cloud.likelihood.mean
    alive = cloud.alive
    n = torch.clamp(torch.sum(alive.to(torch.float32)), min=1.0)
    Lv = torch.where(alive, L, 0.0)
    L_mean = torch.sum(Lv) / n
    L_var = torch.sum(torch.where(alive, L * L, 0.0)) / n - L_mean * L_mean
    any_alive = torch.any(alive)
    fin = lambda x: torch.where(any_alive, x, 0.0)  # no infinities for an empty cloud
    inf = float("inf")
    L_min = fin(torch.amin(torch.where(alive, L, inf)))
    L_max = fin(torch.amax(torch.where(alive, L, -inf)))
    t = cloud.poses.trans
    bb_min = fin(torch.amin(torch.where(alive[:, None], t, inf), dim=0))
    bb_max = fin(torch.amax(torch.where(alive[:, None], t, -inf), dim=0))
    pose = weighted_pose_mean(cloud.poses, Lv)  # weight = likelihood mean
    cov = pose_covariance_6x6(cloud.poses, pose, Lv)
    return ParticleStats(
        pose=pose, covariance=cov, likelihood_mean=L_mean,
        likelihood_sigma=torch.sqrt(torch.clamp(L_var, min=0.0)),
        likelihood_min=L_min, likelihood_max=L_max, shift=L_min,
        trans_bb_min=bb_min, trans_bb_max=bb_max, n_particles=n,
    )
