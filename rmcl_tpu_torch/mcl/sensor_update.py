"""Particle sensor update: beam-sampled 1-D range likelihoods.

Counterpart of ``rmcl_tpu.mcl.sensor_update`` (reference
PCDSensorUpdater{Embree,Optix}). The S sampled beams of one scan are cast
from every particle's sensor pose as one batch of N x S rays, scored and
folded into each particle's likelihood:

  * RC: error = |signed point-to-plane distance| between the measured point
    and the simulated hit's plane; hit/miss mismatches take fixed penalty
    errors;
  * CP: error = distance from the measured point (map frame) to the closest
    surface point;
  * eval = N(error; 0, dist_sigma); the S evals fold as one batch Gaussian
    (masked over real beams), merged into the prior with the n_meas clamp.

Three ray engines: ``bvh`` (K5), ``binned`` (K3 + K1, beam-major or
particle-major blocks) and ``seeded`` (K3 with the lossless flag, K1, then
K5 on the uncertified rays). The update is a composition of the steps
below (:func:`beam_layout`, :func:`cluster_poses`, :func:`cast_update_rays`,
:func:`score_rc`, :func:`fold`), which a caller that times them may run
one by one.

The bvh engine casts the beams in the angular order the particle-major
layout uses (sorted by elevation band and azimuth; it groups rays of like
direction into the walk's warps) and puts the per-beam hits back into the
sampled order before scoring, so its result is the sampled-order result
bit for bit: each ray's walk does not depend on its neighbours.

RC on the bvh engine runs none of those steps one by one:
:func:`~rmcl_tpu_torch.ops.traverse_cuda.walk_score_rc` takes the poses
and the beams (:func:`score_beams`) to each particle's two fold sums, on
the card in two launches (K5 scoring each ray as its walk ends, then a
fold kernel) with no per-ray tensor in device memory but one float a ray,
on the CPU as the same composition op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from rmcl_tpu_torch.math.gaussian import MAX_N_MEAS, Gaussian1D
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import gaussian_pdf
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.ops.closest_point import (closest_points, closest_points_binned,
                                              closest_points_seeded)
from rmcl_tpu_torch.ops.order import cluster_order
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits, _map_hits, cast_rays, cast_rays_seeded
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from rmcl_tpu_torch.ops.traverse_cuda import BEAM_WORDS, walk_score_rc
from rmcl_tpu_torch.utils import timing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SensorUpdateConfig:
    """The JAX package's fields and defaults (see its docstring for each):
    ``engine`` "bvh", "binned" or "seeded"; ``cluster`` Morton + heading
    clusters the particles for the dense engines (a pure reordering);
    ``c_super``/``c_bin``/``c_mid``/``c_hyper`` the cull budgets;
    ``block_size``/``sub_blocks`` the dense engine's blocks; ``sort_blocks``
    K1's candidate-count launch order (no result changes); ``layout``
    "beam" or "particle" for the binned engine; ``range_cap_sigmas`` caps a
    real-hit beam's ray at range + k * dist_sigma (0: unbounded)."""

    samples: int = 100
    correspondence_type: str = "RC"
    engine: str = "bvh"
    cluster: bool = True
    c_super: int = 24
    c_bin: int = 96
    c_mid: int = 0
    block_size: int = 128
    c_hyper: int = 0
    sub_blocks: int = 4
    sort_blocks: bool = True
    layout: str = "beam"
    dist_sigma: float = 2.0
    real_hit_sim_miss_error: float = 100.0
    real_miss_sim_hit_error: float = 100.0
    real_miss_sim_miss_error: float = 0.0
    range_min: float = 0.1
    range_max: float = 130.0
    range_cap_sigmas: float = 6.0

    @staticmethod
    def create(samples=100, correspondence_type="RC", dist_sigma=2.0,
               real_hit_sim_miss_error=100.0, real_miss_sim_hit_error=100.0,
               real_miss_sim_miss_error=0.0, range_min=0.1, range_max=130.0, engine="bvh",
               cluster=True, c_super=24, c_bin=96, c_mid=0, c_hyper=0, layout="beam",
               range_cap_sigmas=6.0, block_size=128, sub_blocks=4, sort_blocks=True):
        return SensorUpdateConfig(
            samples=int(samples), correspondence_type=correspondence_type, engine=engine,
            cluster=bool(cluster), c_super=int(c_super), c_bin=int(c_bin), c_mid=int(c_mid),
            block_size=int(block_size), c_hyper=int(c_hyper), sub_blocks=int(sub_blocks),
            sort_blocks=bool(sort_blocks), layout=layout, dist_sigma=float(dist_sigma),
            real_hit_sim_miss_error=float(real_hit_sim_miss_error),
            real_miss_sim_hit_error=float(real_miss_sim_hit_error),
            real_miss_sim_miss_error=float(real_miss_sim_miss_error),
            range_min=float(range_min), range_max=float(range_max),
            range_cap_sigmas=float(range_cap_sigmas))


def beams_from_indices(points: Tensor, mask: Tensor, idx: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The beams of the sampled points ``idx``: (dirs (S, 3), ranges (S,),
    valid (S,))."""
    pts = points[idx]
    rng = torch.sqrt(torch.sum(pts * pts, dim=-1))
    dirs = pts / torch.clamp(rng, min=1e-12)[..., None]
    return dirs, rng, mask[idx]


def sample_beams(generator: torch.Generator, points: Tensor, mask: Tensor,
                 n_samples: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Pick ``n_samples`` random valid points of a sensor-frame cloud (with
    replacement, uniform over the valid ones), drawn from ``generator`` on
    the points' device; then :func:`beams_from_indices`."""
    p = mask.to(torch.float32)
    p = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))  # no valid point: any
    idx = torch.multinomial(p, n_samples, replacement=True, generator=generator)
    return beams_from_indices(points, mask, idx)


def _angular_order(dirs: Tensor) -> Tensor:
    """Beams sorted by elevation band (8) then azimuth (512 steps), stable."""
    az = torch.atan2(dirs[:, 1], dirs[:, 0])
    el = torch.asin(torch.clamp(dirs[:, 2], -1.0, 1.0))
    band = torch.clamp(((el + math.pi * 0.5) * (8.0 / math.pi)).to(torch.int32), 0, 7)
    azq = torch.clamp(((az + math.pi) * (512.0 / (2.0 * math.pi))).to(torch.int32), 0, 511)
    return torch.argsort(band * 512 + azq, stable=True)


def _range_cap(config: SensorUpdateConfig, ranges: Tensor, real_hit: Tensor,
               beam_w: Optional[Tensor] = None) -> Tensor:
    """Per-beam t_max: real-hit beams capped at range + k * dist_sigma,
    real-miss beams unbounded (a capped real-miss beam could turn a far
    sim hit into a sim miss), pad beams (weight 0) dead at 0."""
    if config.range_cap_sigmas <= 0.0:
        full = torch.full(ranges.shape, NO_HIT_T, device=ranges.device)
    else:
        cap = ranges + torch.tensor(config.range_cap_sigmas, dtype=torch.float32,
                                    device=ranges.device) * config.dist_sigma
        full = torch.where(real_hit, cap, NO_HIT_T)
    if beam_w is not None:
        full = torch.where(beam_w > 0.0, full, 0.0)
    return full


@dataclasses.dataclass(frozen=True)
class BeamLayout:
    """The beams as the cast takes them: ``dirs (Sp, 3)``, ``ranges``,
    ``real_hit``, ``weight`` (0 for pad beams) and ``t_max`` (Sp,);
    ``particle_major`` whether they were angular-sorted and padded."""

    dirs: Tensor
    ranges: Tensor
    real_hit: Tensor
    weight: Tensor
    t_max: Tensor
    particle_major: bool


def _particle_major(config: SensorUpdateConfig) -> bool:
    return config.correspondence_type != "CP" and (
        (config.engine == "binned" and config.layout == "particle")
        or config.engine == "seeded")


def beam_layout(config: SensorUpdateConfig, beams) -> BeamLayout:
    """The particle-major engines (seeded; binned with layout "particle")
    take the beams angular-sorted and padded to a multiple of 32 with dead
    beams (t_max 0, weight 0); the others take them as sampled."""
    dirs, ranges, valid = beams
    S = dirs.shape[0]
    real_hit = (ranges >= config.range_min) & (ranges <= config.range_max) & valid
    weight = torch.ones((S,), device=dirs.device)
    if not _particle_major(config):
        return BeamLayout(dirs, ranges, real_hit, weight, _range_cap(config, ranges, real_hit),
                          False)
    order = _angular_order(dirs)
    dirs, ranges, real_hit = dirs[order], ranges[order], real_hit[order]
    pad = (-S) % 32
    if pad:
        dirs = torch.cat([dirs, dirs.new_tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)])
        ranges = torch.cat([ranges, ranges.new_zeros(pad)])
        real_hit = torch.cat([real_hit, real_hit.new_zeros(pad)])
        weight = torch.cat([weight, weight.new_zeros(pad)])
    return BeamLayout(dirs, ranges, real_hit, weight,
                      _range_cap(config, ranges, real_hit, weight), True)


def cluster_poses(cloud: ParticleCloud, tsb: Transform, config: SensorUpdateConfig,
                  cluster: Optional[bool] = None):
    """The particles' sensor poses ``Tsm = Tbm * Tsb`` (N,), and for the
    dense RC engines with ``cluster`` their Morton + heading order: returns
    (tsm in cluster order, inverse permutation or None)."""
    tsm = cloud.poses @ tsb
    if cluster is None:
        cluster = (config.engine in ("binned", "seeded") and config.correspondence_type != "CP"
                   and config.cluster)
    if not cluster:
        return tsm, None
    fw = cloud.poses.rotate(torch.tensor([1.0, 0.0, 0.0], device=cloud.device))
    order, inv = cluster_order(cloud.poses.trans, fw)
    return tsm[order.long()], inv.long()


def _bvh_cast(bvh, orig_m, dirs_m, t_max, beam_dirs, chunk_size) -> RayHits:
    """The exact engine with the beams in angular order (``beam_dirs``, the
    sensor-frame beams), hits put back into the sampled order (the cast is
    per ray, so the result is bitwise the sampled-order cast's)."""
    order = _angular_order(beam_dirs)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    hits = cast_rays(bvh, orig_m[:, order], dirs_m[:, order], t_min=0.0, t_max=t_max[:, order],
                     chunk_size=chunk_size, flip_normals=False)
    return _map_hits(lambda x: x[:, inv], hits)


def update_rays(tsm: Transform, layout: BeamLayout) -> Tuple[Tensor, Tensor, Tensor]:
    """Every (particle, beam) ray in the map frame: origins and directions
    (N, Sp, 3) (the origins a broadcast view) and t_max (N, Sp)."""
    N, Sp = tsm.batch_shape[0], layout.dirs.shape[0]
    tsm_b = tsm.expand_dims(-1)
    return (tsm_b.trans.expand(N, Sp, 3), tsm_b.rotate(layout.dirs),
            layout.t_max[None, :].expand(N, Sp))


def cast_update_rays(accel, config: SensorUpdateConfig, tsm: Transform, layout: BeamLayout,
                     chunk_size: int = 262144) -> Tuple[Tensor, Tensor, RayHits]:
    """Cast every (particle, beam) ray with the configured engine. Returns
    (orig_m (N, Sp, 3), dirs_m (N, Sp, 3), hits with batch (N, Sp))."""
    N, Sp = tsm.batch_shape[0], layout.dirs.shape[0]
    with timing.span("rmcl.cast.rays"):
        orig_m, dirs_m, t_max = update_rays(tsm, layout)
    dense = dict(block_size=config.block_size, flip_normals=False, c_super=config.c_super,
                 c_bin=config.c_bin, c_mid=config.c_mid, c_hyper=config.c_hyper,
                 sub_blocks=config.sub_blocks)
    if config.engine == "seeded":
        bvh_s, bins_s = accel
        h = cast_rays_seeded(bvh_s, bins_s, orig_m.reshape(-1, 3), dirs_m.reshape(-1, 3),
                             t_max=t_max.reshape(-1), chunk_size=chunk_size, **dense)
        hits = _map_hits(lambda x: x.reshape((N, Sp) + tuple(x.shape[1:])), h)
    elif config.engine == "binned" and layout.particle_major:
        h = cast_rays_binned(accel, orig_m.reshape(-1, 3), dirs_m.reshape(-1, 3),
                             t_max=t_max.reshape(-1), payload="index",
                             sort_blocks=config.sort_blocks, **dense)
        hits = _map_hits(lambda x: x.reshape((N, Sp) + tuple(x.shape[1:])), h)
    elif config.engine == "binned":
        # beam-major blocks: all particles of one beam (coherent once the
        # cloud has concentrated)
        o_bm = orig_m.transpose(0, 1).reshape(-1, 3)
        d_bm = dirs_m.transpose(0, 1).reshape(-1, 3)
        t_bm = t_max.transpose(0, 1).reshape(-1)
        h = cast_rays_binned(accel, o_bm, d_bm, t_max=t_bm, payload="index",
                             sort_blocks=config.sort_blocks, **dense)
        hits = _map_hits(lambda x: x.reshape((Sp, N) + tuple(x.shape[1:])).transpose(0, 1), h)
    elif config.engine == "bvh":
        hits = _bvh_cast(accel, orig_m, dirs_m, t_max, layout.dirs, chunk_size)
    else:
        raise ValueError(f"unknown engine {config.engine!r}")
    return orig_m, dirs_m, hits


def score_rc(config: SensorUpdateConfig, layout: BeamLayout, orig_m: Tensor, dirs_m: Tensor,
             hits: RayHits) -> Tensor:
    """RC error (N, Sp): |signed point-to-plane distance| of the measured
    point to the simulated hit's plane, or the hit/miss penalties."""
    sim_hit = hits.hit & (hits.t > config.range_min)
    p_real_m = orig_m + dirs_m * layout.ranges[None, :, None]
    signed = torch.sum(hits.normal * (hits.point - p_real_m), dim=-1)
    real = layout.real_hit[None, :]
    return torch.where(
        sim_hit,
        torch.where(real, torch.abs(signed), config.real_miss_sim_hit_error),
        torch.where(real, config.real_hit_sim_miss_error, config.real_miss_sim_miss_error))


def score_cp(accel, config: SensorUpdateConfig, tsm: Transform, layout: BeamLayout,
             chunk_size: int = 262144) -> Tensor:
    """CP error (N, S): distance of each measured point (map frame) to the
    closest surface point."""
    p_meas_m = tsm.expand_dims(-1).apply(layout.dirs * layout.ranges[:, None])
    if config.engine == "binned":
        cp = closest_points_binned(accel, p_meas_m, c_super=config.c_super, c_bin=config.c_bin)
    elif config.engine == "seeded":
        bvh_s, bins_s = accel
        cp = closest_points_seeded(bvh_s, bins_s, p_meas_m, chunk_size=chunk_size,
                                   c_super=config.c_super, c_bin=config.c_bin)
    else:
        cp = closest_points(accel, p_meas_m, chunk_size=chunk_size)
    return torch.where(cp.found, cp.dist, config.real_hit_sim_miss_error)


def fold(cloud: ParticleCloud, config: SensorUpdateConfig, layout: BeamLayout, error: Tensor,
         perm_inv: Optional[Tensor]) -> ParticleCloud:
    """Evaluate N(error; 0, dist_sigma), fold the S evals of each particle
    as one batch Gaussian (pad beams weigh 0), undo the clustering on the
    two (N,) results and merge into the prior likelihood."""
    S = config.samples
    evals = gaussian_pdf(error, config.dist_sigma)
    w = layout.weight[None, :]
    e_mean = torch.sum(evals * w, dim=-1) / S
    e_var = torch.sum(w * (evals - e_mean[:, None]) ** 2, dim=-1) / S
    if perm_inv is not None:
        e_mean, e_var = e_mean[perm_inv], e_var[perm_inv]
    return merge_batch(cloud, config, e_mean, e_var)


def merge_batch(cloud: ParticleCloud, config: SensorUpdateConfig, e_mean: Tensor,
                e_var: Tensor) -> ParticleCloud:
    """Merge each particle's batch Gaussian of S evals (mean ``e_mean``,
    variance ``e_var``) into its prior likelihood, with the n_meas clamp."""
    batch = Gaussian1D(mean=e_mean, sigma=e_var,
                       n_meas=torch.full_like(e_mean, float(config.samples)))
    return dataclasses.replace(cloud, likelihood=cloud.likelihood.merge(batch, max_n=MAX_N_MEAS))


def score_beams(layout: BeamLayout) -> Tensor:
    """The beams as :func:`~rmcl_tpu_torch.ops.traverse_cuda.walk_score_rc`
    takes them, (S, 8) float32 in the bvh engine's angular order: direction,
    range, t_max, real hit (1.0/0.0), the index in the sampled order, 0."""
    S = layout.dirs.shape[0]
    dev = layout.dirs.device
    idx = torch.arange(S, device=dev, dtype=torch.float32)
    table = torch.cat([layout.dirs, layout.ranges[:, None], layout.t_max[:, None],
                       layout.real_hit.to(torch.float32)[:, None], idx[:, None],
                       torch.zeros((S, BEAM_WORDS - 7), device=dev)], dim=1)
    return table[_angular_order(layout.dirs)].contiguous()


def sensor_update(accel, cloud: ParticleCloud, generator: Optional[torch.Generator],
                  points_s: Tensor, points_mask: Tensor, tsb: Transform,
                  config: Optional[SensorUpdateConfig] = None, chunk_size: int = 262144,
                  beams: Optional[Tuple[Tensor, Tensor, Tensor]] = None) -> ParticleCloud:
    """Evaluate S sampled beams against all particles and fold the
    likelihoods.

    ``accel``: the BVH (engine "bvh"), the TriangleBins ("binned") or the
    pair (bvh, bins) ("seeded"). ``beams``: an injected ``(dirs, ranges,
    valid)`` triple (the :func:`sample_beams` output), so that the chunks of
    a large cloud score one beam set; else ``generator`` draws them."""
    if config is None:
        config = SensorUpdateConfig.create()
    with timing.span("rmcl.mcl.beams"):
        if beams is None:
            beams = sample_beams(generator, points_s, points_mask, config.samples)
        layout = beam_layout(config, beams)
    with timing.span("rmcl.mcl.cluster"):
        tsm, perm_inv = cluster_poses(cloud, tsb, config)
    if config.correspondence_type == "CP":
        with timing.span("rmcl.mcl.score"):
            error = score_cp(accel, config, tsm, layout, chunk_size)
    elif config.engine == "bvh":
        # the walk scores each ray and a fold reduces them: two floats a
        # particle come back, no per-ray hit
        with timing.span("rmcl.mcl.walk_score"):
            e_mean, e_var = walk_score_rc(
                accel.nodes, accel.root_link, torch.cat([tsm.rot, tsm.trans], dim=-1),
                score_beams(layout), range_min=config.range_min,
                hit_miss=config.real_hit_sim_miss_error,
                miss_hit=config.real_miss_sim_hit_error,
                miss_miss=config.real_miss_sim_miss_error, dist_sigma=config.dist_sigma,
                chunk_size=chunk_size)
        timing.count("rmcl.mcl.walk_score", 1)
        with timing.span("rmcl.mcl.fold"):
            return merge_batch(cloud, config, e_mean, e_var)
    else:
        orig_m, dirs_m, hits = cast_update_rays(accel, config, tsm, layout, chunk_size)
        with timing.span("rmcl.mcl.score"):
            error = score_rc(config, layout, orig_m, dirs_m, hits)
    with timing.span("rmcl.mcl.fold"):
        return fold(cloud, config, layout, error, perm_inv)


def probe_update_rays(cloud: ParticleCloud, generator: Optional[torch.Generator],
                      points_s: Tensor, points_mask: Tensor, tsb: Transform,
                      config: SensorUpdateConfig,
                      beams: Optional[Tuple[Tensor, Tensor, Tensor]] = None):
    """The (orig, dirs, t_max) rays that a binned RC :func:`sensor_update`
    would cast, in its block order (clustering, beam- or particle-major
    layout, the per-beam reach cap), for budget audits
    (:func:`~rmcl_tpu_torch.ops.raycast_binned.block_cull_stats`,
    :func:`~rmcl_tpu_torch.utils.tune.suggest_budgets`)."""
    if beams is None:
        beams = sample_beams(generator, points_s, points_mask, config.samples)
    particle_major = config.layout == "particle"
    layout = beam_layout(dataclasses.replace(
        config, engine="binned", correspondence_type="RC"), beams)
    tsm, _ = cluster_poses(cloud, tsb, config, cluster=config.cluster)
    orig_m, dirs_m, t_max = update_rays(tsm, layout)
    if particle_major:
        return orig_m.reshape(-1, 3), dirs_m.reshape(-1, 3), t_max.reshape(-1)
    return (orig_m.transpose(0, 1).reshape(-1, 3), dirs_m.transpose(0, 1).reshape(-1, 3),
            t_max.transpose(0, 1).reshape(-1))
