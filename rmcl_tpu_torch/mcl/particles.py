"""Particle cloud state for global Monte-Carlo localization.

Counterpart of ``rmcl_tpu.mcl.particles``: pose and attributes as one
frozen dataclass of tensors (structure of arrays). The particle count is
the tensors' size; the reference's dynamic count maps to an ``alive`` mask,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.math.gaussian import Gaussian1D
from rmcl_tpu_torch.math.se3 import Transform

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParticleCloud:
    """poses: Transform with batch (N,), the particles' base -> map poses;
    likelihood: Gaussian1D with batch (N,), the streaming range likelihood
    (mean = running likelihood, n_meas = confidence); state_sigma: (N, 6)
    per-axis pose uncertainty; alive: (N,) bool."""

    poses: Transform
    likelihood: Gaussian1D
    state_sigma: Tensor
    alive: Tensor

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    @property
    def n_alive(self) -> Tensor:
        return torch.sum(self.alive.to(torch.int32))

    @property
    def device(self) -> torch.device:
        return self.alive.device

    @staticmethod
    def create(n: int, seed_likelihood: float = 1.0, device="cuda") -> "ParticleCloud":
        """A fresh cloud at identity poses, likelihood mean ``seed_likelihood``."""
        dev = resolve_device(device)
        return ParticleCloud(
            poses=Transform.identity((n,), dev),
            likelihood=Gaussian1D(
                mean=torch.full((n,), float(seed_likelihood), device=dev),
                sigma=torch.zeros((n,), device=dev),
                n_meas=torch.zeros((n,), device=dev),
            ),
            state_sigma=torch.zeros((n, 6), device=dev),
            alive=torch.ones((n,), dtype=torch.bool, device=dev),
        )

    def with_poses(self, poses: Transform) -> "ParticleCloud":
        return dataclasses.replace(self, poses=poses)

    def weights(self) -> Tensor:
        """Normalized resampling weights from the likelihood means (dead
        particles weigh zero)."""
        w = torch.where(self.alive, torch.clamp(self.likelihood.mean, min=0.0), 0.0)
        return w / torch.clamp(torch.sum(w), min=1e-30)

    def map(self, fn) -> "ParticleCloud":
        """``fn`` applied to every tensor of the cloud (a slice, a gather)."""
        return ParticleCloud(
            poses=Transform(rot=fn(self.poses.rot), trans=fn(self.poses.trans)),
            likelihood=Gaussian1D(mean=fn(self.likelihood.mean), sigma=fn(self.likelihood.sigma),
                                  n_meas=fn(self.likelihood.n_meas)),
            state_sigma=fn(self.state_sigma),
            alive=fn(self.alive),
        )
