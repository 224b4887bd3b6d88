"""Sharded execution of the MICP-L and MCL pipelines on ``torch.distributed``.

Counterpart of ``rmcl_tpu.parallel.sharded``. Every function is called by
every rank of the mesh with that rank's shard (rays or particles split over
the ``"rays"`` axis, the map and poses whole on every rank) and returns that
rank's part of the result; nothing here gathers a sharded result.

- MICP-L: each rank finds the correspondences of its own rays, and the
  statistics merge is one packed all-reduce per solver iteration plus one
  for the final statistics (K + 1 a correction).
- MCL: the sensor update is local to the rank (the same beams everywhere,
  no collective). Tournament resampling duels within the rank's block plus
  one rotated block from another rank per exchange shift (one permute a
  shift), so strong hypotheses spread over the ranks in later rounds. The
  dynamic-count residual resampler splits the global live budget by one
  all-gather of the ranks' weight sums.

Random draws: the sensor update's beams come from a generator in the same
state on every rank (JAX passes one key to every shard). The resamplers draw
on the rank's own generator, seeded from (seed, rank) by the caller where
JAX folds the key with the axis index; each has a pure step on given draws
(``*_from_draws``) that the tests feed JAX's per-shard draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from rmcl_tpu_torch.math.gaussian import Gaussian1D
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.mcl.resampling import (ResamplerConfig, gladiator_from_draws,
                                           residual_dynamic_from_draws)
from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig, sensor_update
from rmcl_tpu_torch.micp.pipeline import MICPConfig, MICPSensorData, MICPStats, correct_once
from rmcl_tpu_torch.parallel.mesh import RAY_AXIS, Mesh, put_replicated, put_sharded

Tensor = torch.Tensor


# -- MICP-L: rays sharded --


def shard_sensor_data(sensors: Sequence[MICPSensorData], mesh: Mesh):
    """This rank's shard of each sensor's points and mask; model, frame and
    config whole. The ray count must split evenly over the rays axis."""
    return [dataclasses.replace(s, model=put_replicated(s.model, mesh),
                                points=put_sharded(s.points, mesh),
                                mask=put_sharded(s.mask, mesh),
                                tsb=put_replicated(s.tsb, mesh))
            for s in sensors]


def sharded_correct_once(bvh, sensors: Sequence[MICPSensorData], tom: Transform, tbo: Transform,
                         convergence_progress, mesh: Mesh, config: MICPConfig = MICPConfig(),
                         chunk_size: int = 1 << 30) -> Tuple[Transform, MICPStats]:
    """:func:`~rmcl_tpu_torch.micp.pipeline.correct_once` over rays sharded
    on the mesh's rays axis (sensors from :func:`shard_sensor_data`; the map,
    ``tom`` and ``tbo`` whole): K + 1 all-reduces a correction, the same
    replicated pose and statistics on every rank. ``chunk_size`` defaults to
    no chunking, since each rank holds only its share of the rays."""
    return correct_once(put_replicated(bvh, mesh), sensors, tom, tbo, convergence_progress,
                        config, chunk_size=chunk_size, mesh=mesh, axis=RAY_AXIS)


# -- MCL: particles sharded --


def shard_cloud(cloud: ParticleCloud, mesh: Mesh) -> ParticleCloud:
    return put_sharded(cloud, mesh)


def sharded_sensor_update(accel, cloud: ParticleCloud, generator: Optional[torch.Generator],
                          points_s: Tensor, points_mask: Tensor, tsb: Transform,
                          config: SensorUpdateConfig, mesh: Mesh, chunk_size: int = 1 << 30,
                          beams: Optional[Tuple[Tensor, Tensor, Tensor]] = None) -> ParticleCloud:
    """The sensor update of this rank's particles: every rank scores the same
    beams (``generator`` in the same state on every rank, or injected
    ``beams``), so it needs no collective. ``accel`` as for
    :func:`~rmcl_tpu_torch.mcl.sensor_update.sensor_update`, whole on every
    rank."""
    return sensor_update(put_replicated(accel, mesh), cloud, generator, points_s, points_mask,
                         tsb, config, chunk_size=chunk_size, beams=beams)


def gladiator_mixing_shifts(tick: int, n_shards: int) -> Tuple[int, ...]:
    """Doubling exchange schedule: on tick t rotate by 2^(t mod log2 n), so
    a strong hypothesis reaches every shard in O(log n) ticks, where a fixed
    shift of one needs O(n). Use as ``shifts=gladiator_mixing_shifts(tick,
    mesh.axis_size("rays"))``."""
    if n_shards <= 1:
        return ()
    levels = max(1, (n_shards - 1).bit_length())
    return (1 << (tick % levels),)


def _exchange_shifts(mesh: Mesh, exchange: bool, shifts) -> Tuple[int, ...]:
    n_dev = mesh.axis_size(RAY_AXIS)
    if not exchange or n_dev <= 1:
        return ()
    shifts = (1,) if shifts is None else shifts
    return tuple(int(s) % n_dev for s in shifts if int(s) % n_dev != 0)


def _pack_cloud(cloud: ParticleCloud) -> Tensor:
    """The cloud's seven tensors as one (n, 17) float32 block, so that an
    exchange shift is one permute and not seven."""
    return torch.cat([cloud.poses.rot, cloud.poses.trans, cloud.likelihood.mean[:, None],
                      cloud.likelihood.sigma[:, None], cloud.likelihood.n_meas[:, None],
                      cloud.state_sigma, cloud.alive.to(torch.float32)[:, None]], dim=1)


def _unpack_cloud(p: Tensor) -> ParticleCloud:
    return ParticleCloud(poses=Transform(rot=p[:, 0:4], trans=p[:, 4:7]),
                         likelihood=Gaussian1D(mean=p[:, 7], sigma=p[:, 8], n_meas=p[:, 9]),
                         state_sigma=p[:, 10:16], alive=p[:, 16] > 0.5)


def _pool_size(cloud: ParticleCloud, mesh: Mesh, exchange: bool = True,
               shifts: Optional[Tuple[int, ...]] = None) -> int:
    """Particles in this rank's duel pool: its own block plus one block a
    shift (the range of the enemy draws)."""
    return (1 + len(_exchange_shifts(mesh, exchange, shifts))) * cloud.capacity


def sharded_gladiator_from_draws(cloud: ParticleCloud, enemy: Tensor, normals: Tensor,
                                 config: ResamplerConfig, mesh: Mesh, exchange: bool = True,
                                 shifts: Optional[Tuple[int, ...]] = None) -> ParticleCloud:
    """The sharded tournament on given draws: ``enemy`` (n,) in [0, pool
    size), ``normals`` (n, 6). The pool is this rank's block, then the block
    of the rank ``s`` places before it for each shift ``s`` (one packed
    permute a shift): n x (1 + the shifts that move) particles."""
    pool = cloud
    shifts = _exchange_shifts(mesh, exchange, shifts)
    if shifts:
        packed = _pack_cloud(cloud)
        blocks = [cloud] + [_unpack_cloud(mesh.ppermute(packed, RAY_AXIS, s)) for s in shifts]
        pool = ParticleCloud(
            poses=Transform(rot=torch.cat([b.poses.rot for b in blocks]),
                            trans=torch.cat([b.poses.trans for b in blocks])),
            likelihood=Gaussian1D(*(torch.cat([getattr(b.likelihood, f) for b in blocks])
                                    for f in ("mean", "sigma", "n_meas"))),
            state_sigma=torch.cat([b.state_sigma for b in blocks]),
            alive=torch.cat([b.alive for b in blocks]))
    return gladiator_from_draws(cloud, enemy, normals, config, pool=pool)


def sharded_gladiator_resample(cloud: ParticleCloud, generator: torch.Generator,
                               config: ResamplerConfig, mesh: Mesh, exchange: bool = True,
                               shifts: Optional[Tuple[int, ...]] = None) -> ParticleCloud:
    """Tournament resampling with per-rank duels and a neighbour exchange:
    each rank duels its particles against enemies from its own block and,
    when ``exchange`` is set, from one rotated block per entry of ``shifts``
    (default ``(1,)``; :func:`gladiator_mixing_shifts` for the doubling
    schedule). ``generator`` is the rank's own stream."""
    n, dev = cloud.capacity, cloud.device
    pool_n = _pool_size(cloud, mesh, exchange, shifts)
    enemy = torch.randint(0, pool_n, (n,), generator=generator, device=dev)
    normals = torch.randn((n, 6), generator=generator, device=dev)
    return sharded_gladiator_from_draws(cloud, enemy, normals, config, mesh, exchange, shifts)


def _residual_shares(w_all: Tensor, n_target: Tensor, cap: int) -> Tensor:
    """Each rank's live budget from the ranks' weight sums ``w_all``:
    weight-proportional shares capped at a rank's capacity, the remainder
    handed out by a greedy fill in descending fractional part, so that the
    shares sum to min(n_target, ranks x cap). The same arithmetic on every
    rank."""
    n_dev = w_all.shape[0]
    w_sum = torch.clamp(torch.sum(w_all), min=1e-30)
    exact = w_all / w_sum * n_target.to(torch.float32)
    base = torch.clamp(torch.floor(exact).to(torch.int32), max=cap)
    remaining = n_target - torch.sum(base)
    room = cap - base
    order = torch.argsort(-(exact - torch.floor(exact)), stable=True)
    room_ord = room[order]
    prefix = torch.cumsum(room_ord, 0)
    give_ord = torch.minimum(torch.clamp(remaining - (prefix - room_ord), min=0), room_ord)
    give = torch.zeros(n_dev, dtype=give_ord.dtype, device=w_all.device)
    give[order] = give_ord
    return (base + give).to(torch.int32)


def sharded_residual_dynamic_from_draws(cloud: ParticleCloud, u0: Tensor, normals: Tensor,
                                        config: ResamplerConfig, n_target,
                                        mesh: Mesh) -> ParticleCloud:
    """Dynamic-count residual resampling over a particle-sharded cloud on
    given draws: the global live budget ``n_target`` splits over the ranks in
    proportion to their likelihood mass (:func:`_residual_shares`, from one
    all-gather of the ranks' sums), and each rank resamples its share into
    its prefix slots."""
    w_local = torch.sum(torch.where(cloud.alive, torch.clamp(cloud.likelihood.mean, min=0.0),
                                    0.0))
    w_all = mesh.all_gather(w_local, RAY_AXIS)
    n_target = torch.as_tensor(n_target, dtype=torch.int32, device=cloud.device)
    share = _residual_shares(w_all, n_target, cloud.capacity)[mesh.axis_index(RAY_AXIS)]
    return residual_dynamic_from_draws(cloud, u0, normals, config, share)


def sharded_residual_resample_dynamic(cloud: ParticleCloud, generator: torch.Generator,
                                      config: ResamplerConfig, n_target,
                                      mesh: Mesh) -> ParticleCloud:
    """:func:`sharded_residual_dynamic_from_draws` on draws from the rank's
    own ``generator``."""
    dev = cloud.device
    u0 = torch.rand((), generator=generator, device=dev)
    normals = torch.randn((cloud.capacity, 6), generator=generator, device=dev)
    return sharded_residual_dynamic_from_draws(cloud, u0, normals, config, n_target, mesh)


def psum_likelihood_stats(cloud: ParticleCloud, mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """Global likelihood sum and max over a particle-sharded cloud (dead
    particles count zero): two all-reduces."""
    w = torch.where(cloud.alive, cloud.likelihood.mean, 0.0)
    return mesh.psum(torch.sum(w), RAY_AXIS), mesh.pmax(torch.amax(w), RAY_AXIS)
