"""Streaming statistics monoids: Gaussian1D and CrossStatistics.

Counterpart of ``rmcl_tpu.math.gaussian``. Both merges are commutative;
``Gaussian1D``'s merge clamps the confidence to ``MAX_N_MEAS`` like the
reference's sequential per-sample clamp. ``sigma`` is a *variance*.

The 3x3 covariance reductions are written as broadcast products summed over
the point axis, not as matrix products: they then stay in full float32 on
the card whatever ``torch.backends.cuda.matmul.allow_tf32`` says (the JAX
package asks for ``Precision.HIGHEST`` for the same reason — these sums feed
the Umeyama SVD).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.math.se3 import Quaternion, Transform

Tensor = torch.Tensor

# Confidence cap — reference rmcl_ros/include/rmcl_ros/rmcl/ParticleAttributes.hpp:24
MAX_N_MEAS = 10_000.0


@dataclasses.dataclass(frozen=True)
class Gaussian1D:
    """Running 1-D Gaussian (mean, variance, effective sample count)."""

    mean: Tensor
    sigma: Tensor  # variance
    n_meas: Tensor  # float — forget factors scale it continuously

    @staticmethod
    def empty(batch_shape: Tuple[int, ...] = (), device="cuda",
              dtype=torch.float32) -> "Gaussian1D":
        z = torch.zeros(tuple(batch_shape), dtype=dtype, device=resolve_device(device))
        return Gaussian1D(mean=z, sigma=z, n_meas=z)

    @staticmethod
    def of(mean: Tensor, sigma=0.0, n_meas=1.0) -> "Gaussian1D":
        mean = mean.to(torch.float32)
        return Gaussian1D(
            mean=mean,
            sigma=torch.as_tensor(sigma, dtype=mean.dtype, device=mean.device).expand(mean.shape),
            n_meas=torch.as_tensor(n_meas, dtype=mean.dtype, device=mean.device).expand(mean.shape),
        )

    def merge(self, other: "Gaussian1D", max_n: float = MAX_N_MEAS) -> "Gaussian1D":
        """Weighted parallel merge; clamps total confidence to ``max_n``."""
        n = self.n_meas + other.n_meas
        safe_n = torch.clamp(n, min=1e-12)
        mean = (self.n_meas * self.mean + other.n_meas * other.mean) / safe_n
        d1 = self.mean - mean
        d2 = other.mean - mean
        sigma = (
            self.n_meas * (self.sigma + d1 * d1)
            + other.n_meas * (other.sigma + d2 * d2)
        ) / safe_n
        empty = n <= 0.0
        return Gaussian1D(
            mean=torch.where(empty, 0.0, mean),
            sigma=torch.where(empty, 0.0, sigma),
            n_meas=torch.clamp(n, max=max_n),
        )

    def __add__(self, other: "Gaussian1D") -> "Gaussian1D":
        return self.merge(other)

    def forget(self, factor) -> "Gaussian1D":
        """Scale confidence down by (1 - factor)."""
        return Gaussian1D(mean=self.mean, sigma=self.sigma,
                          n_meas=self.n_meas * (1.0 - factor))


def _outer_sum(a: Tensor, b: Tensor) -> Tensor:
    """Σ_n a_n ⊗ b_n over the point axis (-2), in full float32."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


@dataclasses.dataclass(frozen=True)
class CrossStatistics:
    """Cross-covariance statistics between a dataset and a model point set.

    ``covariance[i, j] = E[(model_i - model_mean_i) (dataset_j - dataset_mean_j)]``.
    """

    dataset_mean: Tensor  # (..., 3)
    model_mean: Tensor  # (..., 3)
    covariance: Tensor  # (..., 3, 3)
    n_meas: Tensor  # (...,) float

    @staticmethod
    def empty(batch_shape: Tuple[int, ...] = (), device="cuda",
              dtype=torch.float32) -> "CrossStatistics":
        dev = resolve_device(device)
        bs = tuple(batch_shape)
        return CrossStatistics(
            dataset_mean=torch.zeros(bs + (3,), dtype=dtype, device=dev),
            model_mean=torch.zeros(bs + (3,), dtype=dtype, device=dev),
            covariance=torch.zeros(bs + (3, 3), dtype=dtype, device=dev),
            n_meas=torch.zeros(bs, dtype=dtype, device=dev),
        )

    @staticmethod
    def from_masked_points(dataset: Tensor, model: Tensor, mask: Tensor) -> "CrossStatistics":
        """Reduce (N, 3) point pairs with an (N,) validity mask into one
        CrossStatistics (``rm::statistics_p2x``)."""
        w = mask.to(dataset.dtype)
        n = torch.sum(w, dim=-1)
        safe_n = torch.clamp(n, min=1.0)
        d_mean = torch.sum(dataset * w[..., None], dim=-2) / safe_n[..., None]
        m_mean = torch.sum(model * w[..., None], dim=-2) / safe_n[..., None]
        dc = (dataset - d_mean[..., None, :]) * w[..., None]
        mc = model - m_mean[..., None, :]
        cov = _outer_sum(mc, dc) / safe_n[..., None, None]
        empty = n <= 0.0
        return CrossStatistics(
            dataset_mean=torch.where(empty[..., None], 0.0, d_mean),
            model_mean=torch.where(empty[..., None], 0.0, m_mean),
            covariance=torch.where(empty[..., None, None], 0.0, cov),
            n_meas=n,
        )

    def merge(self, other: "CrossStatistics") -> "CrossStatistics":
        """Parallel merge — the ``Cmerged += Cs`` monoid."""
        n = self.n_meas + other.n_meas
        safe_n = torch.clamp(n, min=1e-12)
        w1 = (self.n_meas / safe_n)[..., None]
        w2 = (other.n_meas / safe_n)[..., None]
        d_mean = w1 * self.dataset_mean + w2 * other.dataset_mean
        m_mean = w1 * self.model_mean + w2 * other.model_mean
        dd1 = self.dataset_mean - d_mean
        dm1 = self.model_mean - m_mean
        dd2 = other.dataset_mean - d_mean
        dm2 = other.model_mean - m_mean
        cov = w1[..., None] * (
            self.covariance + dm1[..., :, None] * dd1[..., None, :]
        ) + w2[..., None] * (
            other.covariance + dm2[..., :, None] * dd2[..., None, :]
        )
        empty = n <= 0.0
        return CrossStatistics(
            dataset_mean=torch.where(empty[..., None], 0.0, d_mean),
            model_mean=torch.where(empty[..., None], 0.0, m_mean),
            covariance=torch.where(empty[..., None, None], 0.0, cov),
            n_meas=n,
        )

    def __add__(self, other: "CrossStatistics") -> "CrossStatistics":
        return self.merge(other)

    def transform(self, T: Transform) -> "CrossStatistics":
        """Frame change ``T * stats``: R · cov · Rᵀ, means through T."""
        R = Quaternion.to_matrix(T.rot)
        rc = torch.sum(R[..., :, :, None] * self.covariance[..., None, :, :], dim=-2)
        cov = torch.sum(rc[..., :, None, :] * R[..., None, :, :], dim=-1)
        return CrossStatistics(
            dataset_mean=T.apply(self.dataset_mean),
            model_mean=T.apply(self.model_mean),
            covariance=cov,
            n_meas=self.n_meas,
        )

    def scale_weight(self, w) -> "CrossStatistics":
        """Multiply the effective sample count (per-sensor weight)."""
        return CrossStatistics(
            dataset_mean=self.dataset_mean,
            model_mean=self.model_mean,
            covariance=self.covariance,
            n_meas=self.n_meas * w,
        )
