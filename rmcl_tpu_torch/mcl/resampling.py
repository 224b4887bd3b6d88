"""Resampling strategies for the particle filter.

Counterpart of ``rmcl_tpu.mcl.resampling``: tournament (gladiator),
residual (fixed and dynamic live count) and systematic resampling, each
with the reference's post-copy pose noise and confidence forgetting.

Every resampler is split in two: the public function draws its random
numbers from an explicit ``torch.Generator`` on the cloud's device (where
the JAX function takes a key), and a pure step (``*_from_draws``) takes
them. The draws are those of the JAX function: enemies ``(n,)`` int in [0,
n) and standard normals ``(n, 6)`` for the gladiator; one uniform offset in
[0, 1) and normals ``(n, 6)`` for the others.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rmcl_tpu_torch.math.gaussian import Gaussian1D
from rmcl_tpu_torch.math.se3 import Quaternion, Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Noise and forget parameters shared by the resamplers (reference
    GladiatorResamplerConfig)."""

    min_noise: Tuple[float, ...] = (0.05, 0.05, 0.05, 0.01, 0.01, 0.01)  # tx ty tz r p y
    likelihood_forget_per_meter: float = 0.5
    likelihood_forget_per_radian: float = 0.5

    @staticmethod
    def create(min_noise_t=(0.05, 0.05, 0.05), min_noise_r=(0.01, 0.01, 0.01),
               likelihood_forget_per_meter=0.5, likelihood_forget_per_radian=0.5):
        return ResamplerConfig(tuple(float(x) for x in list(min_noise_t) + list(min_noise_r)),
                               float(likelihood_forget_per_meter),
                               float(likelihood_forget_per_radian))

    def noise(self, device) -> Tensor:
        return torch.tensor(self.min_noise, dtype=torch.float32, device=device)


def _f32(x, device) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _normals(generator: torch.Generator, n: int, device) -> Tensor:
    return torch.randn((n, 6), generator=generator, device=device)


def _uniform(generator: torch.Generator, device) -> Tensor:
    return torch.rand((), generator=generator, device=device)


def _perturb_poses_from_normals(poses: Transform, noise6: Tensor, normals: Tensor):
    """Per-axis Gaussian noise in (x, y, z, roll, pitch, yaw) — the
    reference perturbs Euler angles directly. Returns (new_poses,
    trans_dist_sq, rot_dist)."""
    eps = normals * noise6
    t_new = poses.trans + eps[:, :3]
    roll, pitch, yaw = Quaternion.to_euler(poses.rot)
    q_new = Quaternion.from_euler(roll + eps[:, 3], pitch + eps[:, 4], yaw + eps[:, 5])
    # the SQUARED translation distance is the reference's
    # (GladiatorResamplerCPU exponentiates by l2normSquared())
    trans_d2 = torch.sum(eps[:, :3] ** 2, dim=-1)
    dq = Quaternion.mul(Quaternion.conj(poses.rot), q_new)
    rot_d = torch.sqrt(torch.sum(dq[:, 1:] ** 2, dim=-1))
    return Transform(rot=q_new, trans=t_new), trans_d2, rot_d


def _perturb_poses(generator: torch.Generator, poses: Transform, noise6: Tensor):
    """:func:`_perturb_poses_from_normals` on normals drawn from ``generator``."""
    n = poses.batch_shape[0]
    return _perturb_poses_from_normals(poses, noise6, _normals(generator, n, poses.trans.device))


def gladiator_from_draws(cloud: ParticleCloud, enemy: Tensor, normals: Tensor,
                         config: ResamplerConfig,
                         pool: "ParticleCloud | None" = None) -> ParticleCloud:
    """Tournament: each slot duels enemy[slot]; if the enemy's likelihood
    mean is higher, the slot copies the enemy with noise and confidence
    forgetting. Dead particles never win a duel. ``pool`` (default: the
    cloud) is where the enemies come from; its first ``capacity`` particles
    must be the cloud's (the sharded tournament pools the rank's cloud with
    blocks received from other ranks)."""
    n = cloud.capacity
    dev = cloud.device
    L_self = torch.where(cloud.alive, cloud.likelihood.mean, float("-inf"))
    if pool is None:
        pool, L_pool = cloud, L_self
    else:
        L_pool = torch.where(pool.alive, pool.likelihood.mean, float("-inf"))
    lose = L_pool[enemy] > L_self
    src = torch.where(lose, enemy, torch.arange(n, device=dev))
    src_cloud = pool.map(lambda x: x[src])
    poses_src = src_cloud.poses
    perturbed, trans_d2, rot_d = _perturb_poses_from_normals(poses_src, config.noise(dev),
                                                             normals)
    # losers take the perturbed enemy pose; winners keep their own exactly
    poses_new = Transform(rot=torch.where(lose[:, None], perturbed.rot, poses_src.rot),
                          trans=torch.where(lose[:, None], perturbed.trans, poses_src.trans))
    forget_space = 1.0 - torch.pow(1.0 - _f32(config.likelihood_forget_per_meter, dev), trans_d2)
    forget_rot = 1.0 - torch.pow(1.0 - _f32(config.likelihood_forget_per_radian, dev), rot_d)
    forget = torch.where(lose, torch.maximum(forget_space, forget_rot), 0.0)
    return dataclasses.replace(src_cloud, poses=poses_new,
                               likelihood=src_cloud.likelihood.forget(forget))


def gladiator_resample(cloud: ParticleCloud, generator: torch.Generator,
                       config: ResamplerConfig) -> ParticleCloud:
    """:func:`gladiator_from_draws` on enemies and normals drawn from
    ``generator``."""
    n, dev = cloud.capacity, cloud.device
    enemy = torch.randint(0, n, (n,), generator=generator, device=dev)
    return gladiator_from_draws(cloud, enemy, _normals(generator, n, dev), config)


def _copy_from_indices(cloud: ParticleCloud, src: Tensor, normals: Tensor,
                       config: ResamplerConfig, noise_scale: Tensor) -> ParticleCloud:
    """Every slot copies particle src[slot], perturbed by noise scaled by
    noise_scale[slot]; confidence shrinks by the product of powers
    (ResidualResamplerCPU)."""
    dev = cloud.device
    src_cloud = cloud.map(lambda x: x[src])
    noise6 = config.noise(dev)[None, :] * noise_scale[:, None]
    perturbed, trans_d2, rot_d = _perturb_poses_from_normals(src_cloud.poses, noise6, normals)
    reduction = (torch.pow(_f32(config.likelihood_forget_per_meter, dev), trans_d2)
                 * torch.pow(_f32(config.likelihood_forget_per_radian, dev), rot_d))
    lik = src_cloud.likelihood
    return dataclasses.replace(
        src_cloud, poses=perturbed,
        likelihood=Gaussian1D(mean=lik.mean, sigma=lik.sigma, n_meas=lik.n_meas * reduction))


def _searchsorted_right(cdf: Tensor, x: Tensor) -> Tensor:
    return torch.searchsorted(cdf, x.contiguous(), right=True)


def _residual_sources(w: Tensor, n_target: Tensor, u0: Tensor, n: int) -> Tensor:
    """Deterministic copies floor(n_target * w_i), then a systematic pass
    over the residual weights, into the slots [0, n)."""
    nt_f = n_target.to(torch.float32)
    counts = torch.floor(w * nt_f)
    n_det = torch.sum(counts).to(torch.int32)
    residual = w * nt_f - counts
    r_norm = residual / torch.clamp(torch.sum(residual), min=1e-30)
    slots = torch.arange(n, device=w.device)
    src_det = _searchsorted_right(torch.cumsum(counts, 0), slots.to(counts.dtype))
    n_resid = torch.clamp(n_target - n_det, min=1)
    pos = (u0 + (slots - n_det).to(torch.float32)) / n_resid.to(torch.float32)
    src_resid = _searchsorted_right(torch.cumsum(r_norm, 0), pos)
    src = torch.where(slots < n_det, src_det, src_resid)
    return torch.clamp(src, 0, n - 1)


def _noise_scale(cloud: ParticleCloud, src: Tensor, degenerate: Tensor) -> Tensor:
    """1 / L_max_normed of each copy's source (at least 1e-3), 0 for a
    degenerate cloud."""
    L_max = torch.clamp(torch.amax(cloud.likelihood.mean), min=1e-30)
    L_max_normed = cloud.likelihood.mean[src] / L_max
    return torch.where(degenerate, 0.0, 1.0 / torch.clamp(L_max_normed, min=1e-3))


def residual_from_draws(cloud: ParticleCloud, u0: Tensor, normals: Tensor,
                        config: ResamplerConfig) -> ParticleCloud:
    """Residual resampling: floor(N * w_i) deterministic copies of each
    particle plus a systematic pass at offset u0 over the residual weights;
    noise scaled by 1 / L_max_normed. All-zero weights make it the
    identity without noise."""
    n = cloud.capacity
    w = cloud.weights()
    src = _residual_sources(w, torch.tensor(n, device=w.device), u0, n)
    degenerate = torch.sum(w) <= 0.0
    src = torch.where(degenerate, torch.arange(n, device=w.device), src)
    return _copy_from_indices(cloud, src, normals, config, _noise_scale(cloud, src, degenerate))


def residual_resample(cloud: ParticleCloud, generator: torch.Generator,
                      config: ResamplerConfig) -> ParticleCloud:
    dev = cloud.device
    return residual_from_draws(cloud, _uniform(generator, dev),
                               _normals(generator, cloud.capacity, dev), config)


def residual_dynamic_from_draws(cloud: ParticleCloud, u0: Tensor, normals: Tensor,
                                config: ResamplerConfig, n_target: Tensor) -> ParticleCloud:
    """Residual resampling with a dynamic live count: ``n_target`` new
    particles fill the prefix slots and exactly those are alive (a
    degenerate cloud keeps its alive set)."""
    n = cloud.capacity
    w = cloud.weights()
    n_target = torch.as_tensor(n_target, device=w.device)
    src = _residual_sources(w, n_target, u0, n)
    degenerate = torch.sum(w) <= 0.0
    slots = torch.arange(n, device=w.device)
    src = torch.where(degenerate, slots, src)
    out = _copy_from_indices(cloud, src, normals, config, _noise_scale(cloud, src, degenerate))
    return dataclasses.replace(out, alive=torch.where(degenerate, cloud.alive, slots < n_target))


def residual_resample_dynamic(cloud: ParticleCloud, generator: torch.Generator,
                              config: ResamplerConfig, n_target) -> ParticleCloud:
    dev = cloud.device
    return residual_dynamic_from_draws(cloud, _uniform(generator, dev),
                                       _normals(generator, cloud.capacity, dev), config,
                                       n_target)


def adaptive_particle_count(cloud: ParticleCloud, n_min: int = 256, n_max: int | None = None,
                            spread_ref: float = 1.0) -> Tensor:
    """Live-count policy for :func:`residual_resample_dynamic`: n_min plus
    (n_max - n_min) times the weight fraction outside a ``spread_ref`` ball
    around the weighted mean. An int32 scalar on the cloud's device."""
    n_max = cloud.capacity if n_max is None else n_max
    w = cloud.weights()
    mu = w @ cloud.poses.trans
    d2 = torch.sum((cloud.poses.trans - mu) ** 2, dim=-1)
    inside = torch.sum(torch.where(d2 <= spread_ref * spread_ref, w, 0.0))
    frac = torch.clamp(1.0 - inside, 0.0, 1.0)
    return torch.round(n_min + (n_max - n_min) * frac).to(torch.int32)


def systematic_from_draws(cloud: ParticleCloud, u0: Tensor, normals: Tensor,
                          config: ResamplerConfig) -> ParticleCloud:
    """Low-variance systematic resampling at offset u0, with the
    reference's noise and forget post-pass."""
    n = cloud.capacity
    dev = cloud.device
    w = cloud.weights()
    slots = torch.arange(n, device=dev)
    pos = (u0 + slots) / n
    src = torch.clamp(_searchsorted_right(torch.cumsum(w, 0), pos.to(torch.float32)), 0, n - 1)
    degenerate = torch.sum(w) <= 0.0
    src = torch.where(degenerate, slots, src)
    scale = torch.where(degenerate, 0.0, torch.ones((n,), device=dev))
    return _copy_from_indices(cloud, src, normals, config, scale)


def systematic_resample(cloud: ParticleCloud, generator: torch.Generator,
                        config: ResamplerConfig) -> ParticleCloud:
    dev = cloud.device
    return systematic_from_draws(cloud, _uniform(generator, dev),
                                 _normals(generator, cloud.capacity, dev), config)


def effective_sample_size(cloud: ParticleCloud) -> Tensor:
    """ESS = 1 / sum w^2."""
    w = cloud.weights()
    return 1.0 / torch.clamp(torch.sum(w * w), min=1e-30)
