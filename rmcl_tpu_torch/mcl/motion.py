"""Particle motion update: the odometry delta, the forget factor and the
collision kill.

Counterpart of ``rmcl_tpu.mcl.motion`` (reference TFMotionUpdaterCPU):

  * pose_new = pose_old * delta, delta = ~T_bold_o * T_bnew_o;
  * forget = (1 - (1 - rate)^dist) * (1 - (1 - rate_s)^dt), n_meas -=
    forget * n_meas;
  * optional collision kill: a particle whose straight step crosses the
    mesh gets likelihood {mean 0, sigma 0, n_meas MAX} (the segment query
    runs through :func:`rmcl_tpu_torch.ops.raycast.occluded`, K5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.math.gaussian import MAX_N_MEAS, Gaussian1D
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.ops.raycast import occluded


@dataclasses.dataclass(frozen=True)
class MotionUpdateConfig:
    """Defaults match the reference's TFMotionUpdaterCPU::updateParams."""

    forget_rate: float = 0.5  # per meter travelled
    forget_rate_per_second: float = 0.1
    check_collisions: bool = False

    @staticmethod
    def create(forget_rate=0.5, forget_rate_per_second=0.1, check_collisions=False):
        return MotionUpdateConfig(float(forget_rate), float(forget_rate_per_second),
                                  bool(check_collisions))


def motion_update(cloud: ParticleCloud, delta: Transform, dt, config: MotionUpdateConfig,
                  bvh: Optional[BVH] = None, chunk_size: int = 262144) -> ParticleCloud:
    """Apply the odometry delta (base_new -> base_old) to every particle."""
    old_t = cloud.poses.trans
    poses_new = cloud.poses @ delta
    dev = old_t.device
    dist = torch.sqrt(torch.sum(delta.trans * delta.trans))
    dt = torch.clamp(torch.as_tensor(dt, dtype=torch.float32, device=dev), min=0.0)
    rate = torch.tensor(config.forget_rate, dtype=torch.float32, device=dev)
    rate_s = torch.tensor(config.forget_rate_per_second, dtype=torch.float32, device=dev)
    forget = (1.0 - torch.pow(1.0 - rate, dist)) * (1.0 - torch.pow(1.0 - rate_s, dt))
    lik = cloud.likelihood.forget(forget)
    if config.check_collisions and bvh is not None:
        hit_wall = occluded(bvh, old_t, poses_new.trans, chunk_size=chunk_size)
        lik = Gaussian1D(
            mean=torch.where(hit_wall, 0.0, lik.mean),
            sigma=torch.where(hit_wall, 0.0, lik.sigma),
            n_meas=torch.where(hit_wall, MAX_N_MEAS, lik.n_meas),
        )
    return dataclasses.replace(cloud, poses=poses_new, likelihood=lik)
