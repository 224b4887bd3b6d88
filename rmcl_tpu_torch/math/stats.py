"""Pose-estimation linear algebra: the Umeyama / Kabsch solve.

Counterpart of the deterministic half of ``rmcl_tpu.math.stats``. The pose
samplers and ``markley_mean`` draw from ``jax.random`` there and are not
ported yet.
"""

from __future__ import annotations

import torch

from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.se3 import Quaternion, Transform

Tensor = torch.Tensor


def kabsch_rotation(covariance: Tensor) -> Tensor:
    """Optimal rotation R maximizing tr(R Cᵀ) for C = E[m_c ⊗ d_c], with the
    determinant sign fix (a proper rotation even for reflective C)."""
    u, _, vt = torch.linalg.svd(covariance)
    det = torch.linalg.det(u @ vt)
    d = torch.ones_like(covariance[..., 0])
    d = torch.cat([d[..., :-1], det[..., None]], dim=-1)
    return u @ (d[..., :, None] * vt)


def umeyama_transform(stats: CrossStatistics) -> Transform:
    """SE(3) increment T with ``T(dataset) ≈ model`` in the least-squares
    point sense. Degenerate statistics (n_meas == 0) give the identity."""
    R = kabsch_rotation(stats.covariance)
    t = stats.model_mean - torch.sum(R * stats.dataset_mean[..., None, :], dim=-1)
    valid = stats.n_meas > 0.0
    q = Quaternion.from_matrix(R)
    ident = Quaternion.identity(tuple(q.shape[:-1]), q.device, q.dtype)
    return Transform(
        rot=torch.where(valid[..., None], q, ident),
        trans=torch.where(valid[..., None], t, torch.zeros_like(t)),
    )
