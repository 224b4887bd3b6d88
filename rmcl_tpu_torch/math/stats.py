"""Pose-estimation linear algebra: the Umeyama / Kabsch solve, the Markley
quaternion mean, the pose covariance, the pose samplers and the 1-D normal
density.

Counterpart of ``rmcl_tpu.math.stats``. Each sampler is split in two: a
draw step on an explicit ``torch.Generator`` (the public function, with
the JAX signature's key replaced by the generator) and a pure step that
takes the draws (``*_from_*``), so that a test can hand both packages the
same random numbers.
"""

from __future__ import annotations

import torch

from typing import Optional

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


def _normalized_weights(weights: Tensor) -> Tensor:
    """Weights over their sum; all-zero weights become uniform."""
    w_sum = torch.sum(weights)
    uniform = torch.full_like(weights, 1.0 / weights.shape[0])
    return torch.where(w_sum > 0.0, weights / torch.clamp(w_sum, min=1e-12), uniform)


def markley_mean(quats: Tensor, weights: Tensor) -> Tensor:
    """Weighted quaternion average (Markley et al. 2007): the principal
    eigenvector of M = sum w_i q_i q_i^T, with q[0] >= 0.

    quats: (N, 4) wxyz; weights: (N,). Returns (4,). All-zero weights fall
    back to the unweighted mean (a zero matrix would otherwise give the
    last basis vector, a 180-degree rotation)."""
    w = _normalized_weights(weights)
    M = (quats * w[:, None]).T @ quats
    _, vecs = torch.linalg.eigh(M)  # ascending eigenvalues
    q = vecs[..., -1]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def weighted_pose_mean(poses: Transform, weights: Tensor) -> Transform:
    """Weighted mean pose: arithmetic mean translation and Markley mean
    rotation. All-zero weights fall back to the unweighted mean."""
    w = _normalized_weights(weights)
    t_mean = w @ poses.trans
    return Transform(rot=markley_mean(poses.rot, weights), trans=t_mean)


def pose_covariance_6x6(poses: Transform, mean: Transform, weights: Tensor) -> Tensor:
    """Weighted 6x6 covariance of the pose deviations [dt, drotvec] about
    ``mean``; the rotation deviation is the log map of mean^-1 * q."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    dt = poses.trans - mean.trans
    dq = Quaternion.mul(Quaternion.conj(mean.rot).expand_as(poses.rot), poses.rot)
    err = torch.cat([dt, Quaternion.log(dq)], dim=-1)  # (N, 6)
    return (err * w[:, None]).T @ err


def pose_gaussian_from_normals(mean: Transform, covariance6: Tensor, normals: Tensor,
                               jitter: float = 1e-9) -> Transform:
    """Poses N(mean, covariance6) in the [t, rotvec] tangent space from
    standard normals ``(n, 6)``: the Cholesky factor deforms them."""
    eye = torch.eye(6, dtype=covariance6.dtype, device=covariance6.device)
    L = torch.linalg.cholesky(covariance6 + jitter * eye)
    d = normals @ L.T  # (n, 6)
    n = normals.shape[0]
    return Transform(rot=Quaternion.mul(mean.rot.expand(n, 4), Quaternion.exp(d[:, 3:])),
                     trans=mean.trans + d[:, :3])


def sample_pose_gaussian(generator: torch.Generator, mean: Transform, covariance6: Tensor,
                         n: int, jitter: float = 1e-9) -> Transform:
    """n poses ~ N(mean, covariance6): standard normals drawn from
    ``generator`` (on the covariance's device), then
    :func:`pose_gaussian_from_normals`."""
    x = torch.randn((n, 6), generator=generator, dtype=covariance6.dtype,
                    device=covariance6.device)
    return pose_gaussian_from_normals(mean, covariance6, x, jitter)


def pose_uniform_from_draws(u: Tensor) -> Transform:
    """Poses from draws ``(n, 6)`` of (x, y, z, roll, pitch, yaw)."""
    return Transform.from_xyz_euler(u[:, :3], u[:, 3:])


def sample_pose_uniform(generator: torch.Generator, lo, hi, n: int,
                        device="cuda") -> Transform:
    """Uniform box sampling in (x, y, z, roll, pitch, yaw), the global
    localization's initialisation: draws lo + (hi - lo) * U[0, 1) from
    ``generator`` on ``device``, then :func:`pose_uniform_from_draws`."""
    from rmcl_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    u = torch.rand((n, 6), generator=generator, device=dev)
    return pose_uniform_from_draws(torch.maximum(lo, u * (hi - lo) + lo))


def gaussian_pdf(x: Tensor, sigma, mean: Optional[Tensor] = None) -> Tensor:
    """1-D normal density N(x; mean, sigma^2), the per-beam likelihood."""
    if mean is not None:
        x = x - mean
    inv_s = 1.0 / torch.clamp(torch.as_tensor(sigma, dtype=x.dtype, device=x.device),
                              min=1e-12)
    z = x * inv_s
    return 0.3989422804014327 * inv_s * torch.exp(-0.5 * z * z)
