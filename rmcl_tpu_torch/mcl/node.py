"""RMCL localization runtime: the RmclNode equivalent.

Counterpart of ``rmcl_tpu.mcl.node``: host-side orchestration of the three
periodic stages (motion update, sensor update, resampling), the two
re-initialization services (``initial_pose_guess``, ``global_localization``),
pose induction and the map -> odom output; the engine choice of
``engine="auto"`` (:func:`auto_engine`) and the binned engine's budget
audit.

What differs from the JAX package: PyTorch runs eagerly, so there is no
program to compile ahead and no compile cache; the JAX node's background
warm threads have no counterpart. :meth:`MCLNode.warm` builds the kernels'
libraries, the port's only first-use cost. The node owns one
``torch.Generator`` on the map's device, seeded from ``MCLConfig.seed``;
its streams are not ``jax.random``'s. ``engine="auto"`` with ray
casting (RC) on a CUDA map takes the exact BVH walk for every cloud, where
the JAX gate takes the binned engine once the cloud concentrates: on the
H100 the RC cycle on the walk (K5) was faster than on the binned cast
(K3 + K1) at every size measured, 50,000 to 1,048,576 particles. Closest
points (CP) keep the JAX gate there, as every device does: on a tracking
cloud the binned loop (K6b) was faster than the walk (K6) (``PERF.md`` §6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from rmcl_tpu_torch.math.gaussian import Gaussian1D
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import sample_pose_gaussian, sample_pose_uniform
from rmcl_tpu_torch.mcl.motion import MotionUpdateConfig, motion_update
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.mcl.resampling import (ResamplerConfig, adaptive_particle_count,
                                           effective_sample_size, gladiator_resample,
                                           residual_resample, residual_resample_dynamic,
                                           systematic_resample)
from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig, sensor_update
from rmcl_tpu_torch.mcl.stats import ParticleStats, estimate_stats
from rmcl_tpu_torch.utils import timing

Tensor = torch.Tensor

_RESAMPLERS: dict[str, Callable] = {
    "gladiator": gladiator_resample,
    "residual": residual_resample,
    "systematic": systematic_resample,
}

# the kernels' libraries that the MCL path can launch (see MCLNode.warm)
_KERNELS = ("cull_blocks", "intersect_bins", "traverse_bvh", "closest_bvh", "closest_bins")


def auto_engine(prev: str, spread: float, hspread: float, spread_max: float,
                heading_max: float) -> str:
    """The JAX package's gate for ``engine="auto"``: from the exact walk,
    ``"binned"`` once the weighted spread is under ``spread_max`` and the
    heading spread under ``heading_max``; from binned, back to ``"bvh"``
    once either passes twice its threshold."""
    if prev == "binned":
        return "bvh" if spread > 2.0 * spread_max or hspread > 2.0 * heading_max else "binned"
    return "binned" if spread < spread_max and hspread < heading_max else "bvh"


@dataclasses.dataclass
class MCLConfig:
    """Per-stage configuration with the JAX package's fields and defaults:
    ``dynamic_count`` "off", "reference" or "adaptive"; ``compact_compute``
    runs the sensor stage on the live prefix (padded to a power of two)
    under a dynamic count; ``auto_budget`` adopts :func:`suggest_budgets`'
    recommendation when the binned engine's audit saturates;
    ``auto_engine_*`` the ``engine="auto"`` gate (spread in meters, heading
    spread as a sine, evaluated every ``auto_engine_period`` updates; an RC
    update on a CUDA map is the exact walk and reads none)."""

    n_particles: int = 100_000
    resampler: str = "gladiator"
    motion: MotionUpdateConfig = dataclasses.field(default_factory=MotionUpdateConfig.create)
    sensor: SensorUpdateConfig = dataclasses.field(default_factory=SensorUpdateConfig.create)
    resampling: ResamplerConfig = dataclasses.field(default_factory=ResamplerConfig.create)
    max_induction_particles: int = 50_000
    min_particles_for_resample: int = 10
    seed: int = 0
    dynamic_count: str = "off"
    adaptive_n_min: int = 256
    adaptive_spread_ref: float = 1.0
    compact_compute: bool = True
    auto_budget: bool = True
    auto_engine_spread: float = 1.0
    auto_engine_heading_spread: float = 0.1
    auto_engine_period: int = 5

    @staticmethod
    def from_params(params) -> "MCLConfig":
        """From a ParamTree with the reference's YAML schema (the keys the
        JAX package's ``MCLConfig.from_params`` reads, with its defaults)."""
        g = params.get
        corr = g("sensor_update.correspondence_type", "RC")
        corr = {0: "RC", 1: "CP"}.get(corr, str(corr))
        resampler = str(g("resampling.type", "gladiator"))
        if resampler not in _RESAMPLERS:
            raise ValueError(f"unknown resampling.type {resampler!r} (have {sorted(_RESAMPLERS)})")
        return MCLConfig(
            n_particles=int(g("max_particles", 100_000)),
            seed=int(g("seed", 0)),
            resampler=resampler,
            min_particles_for_resample=int(g("resampling.min_particles", 10)),
            dynamic_count=str(g("resampling.dynamic_count", "off")),
            adaptive_n_min=int(g("resampling.adaptive_n_min", 256)),
            adaptive_spread_ref=float(g("resampling.adaptive_spread_ref", 1.0)),
            auto_engine_spread=float(g("sensor_update.auto_engine_spread", 1.0)),
            auto_engine_heading_spread=float(g("sensor_update.auto_engine_heading_spread", 0.1)),
            auto_engine_period=int(g("sensor_update.auto_engine_period", 5)),
            max_induction_particles=int(g("resampling.max_induction_particles", 50_000)),
            motion=MotionUpdateConfig.create(
                forget_rate=float(g("motion_update.forget_rate", 0.5)),
                forget_rate_per_second=float(g("motion_update.forget_rate_per_second", 0.1)),
                check_collisions=bool(g("motion_update.check_collisions", False)),
            ),
            sensor=SensorUpdateConfig.create(
                samples=int(g("sensor_update.samples", 100)),
                correspondence_type=corr,
                dist_sigma=float(g("sensor_update.dist_sigma", 2.0)),
                real_hit_sim_miss_error=float(g("sensor_update.real_hit_sim_miss_error", 100.0)),
                real_miss_sim_hit_error=float(g("sensor_update.real_miss_sim_hit_error", 100.0)),
                real_miss_sim_miss_error=float(g("sensor_update.real_miss_sim_miss_error", 0.0)),
                range_min=float(g("sensor_update.sensor_range_min", 0.05)),
                range_max=float(g("sensor_update.sensor_range_max", 80.0)),
                engine=str(g("sensor_update.engine", "bvh")),
                cluster=bool(g("sensor_update.cluster", True)),
                c_super=int(g("sensor_update.c_super", 24)),
                c_bin=int(g("sensor_update.c_bin", 96)),
                c_mid=int(g("sensor_update.c_mid", 0)),
                layout=str(g("sensor_update.layout", "beam")),
            ),
            resampling=ResamplerConfig.create(
                min_noise_t=(float(g("resampling.min_noise_tx", 0.03)),
                             float(g("resampling.min_noise_ty", 0.03)),
                             float(g("resampling.min_noise_tz", 0.0))),
                min_noise_r=(float(g("resampling.min_noise_roll", 0.0)),
                             float(g("resampling.min_noise_pitch", 0.0)),
                             float(g("resampling.min_noise_yaw", 0.01))),
                likelihood_forget_per_meter=float(
                    g("resampling.likelihood_forget_per_meter", 0.3)),
                likelihood_forget_per_radian=float(
                    g("resampling.likelihood_forget_per_radian", 0.2)),
            ),
        )


class MCLNode:
    """Monte-Carlo localization over a mesh map (a BVH, or a MeshMap with
    both structures). The caller owns the timing: stages are called
    explicitly. Runs on the map's device."""

    # adopted budgets are quantized to this ladder (the JAX package's): it
    # keeps the configurations few
    _BUDGET_RUNGS = ((48, 256), (96, 1024), (192, 4096))

    def __init__(self, map_, config: Optional[MCLConfig] = None):
        self.bvh = map_.bvh if hasattr(map_, "bvh") else map_
        self.bins = getattr(map_, "bins", None)
        self.config = config or MCLConfig()
        if self.config.sensor.engine in ("binned", "seeded") and self.bins is None:
            raise ValueError(f"sensor.engine='{self.config.sensor.engine}' needs a MeshMap "
                             "(with triangle bins), not a raw BVH")
        self.device = self.bvh.device
        self.generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.cloud = ParticleCloud.create(self.config.n_particles, device=self.device)
        self.timer = timing.StageTimer(prefix="rmcl.mcl.")
        self.tbo_last: Optional[Transform] = None
        self.stamp_last: Optional[float] = None
        self.motion_updates = 0
        self.sensor_updates = 0
        # host mirror of the live count; updated on init and after every
        # dynamic-count resample
        self.n_alive_host: Optional[int] = self.config.n_particles
        self.adaptive_n_min_eff = min(self.config.adaptive_n_min, self.config.n_particles)
        self._budget_checked = False
        self.last_audit: Optional[dict] = None  # what the last budget audit saw and adopted
        # engine='auto' starts on the exact traversal: an initial cloud is
        # scattered, where the dense engine's budgets saturate
        self._engine_choice = "bvh"
        self._engine_gate_seen = False

    # -- services ----------------------------------------------------------

    def initial_pose_guess(self, pose: Transform, covariance6: Optional[Tensor] = None) -> None:
        """Gaussian (re)initialization around a pose guess."""
        if covariance6 is None:
            covariance6 = torch.diag(torch.tensor([0.25, 0.25, 0.1, 0.01, 0.01, 0.1]))
        cov = torch.as_tensor(covariance6, dtype=torch.float32).to(self.device)
        pose = Transform(rot=pose.rot.to(self.device), trans=pose.trans.to(self.device))
        poses = sample_pose_gaussian(self.generator, pose, cov, self.config.n_particles)
        self.cloud = ParticleCloud.create(self.config.n_particles,
                                          device=self.device).with_poses(poses)
        self._reset_updaters()

    def global_localization(self, box_min, box_max) -> None:
        """Uniform re-seeding over an (x, y, z, roll, pitch, yaw) box."""
        poses = sample_pose_uniform(self.generator, box_min, box_max, self.config.n_particles,
                                    device=self.device)
        self.cloud = ParticleCloud.create(self.config.n_particles,
                                          device=self.device).with_poses(poses)
        self._reset_updaters()

    def _reset_updaters(self) -> None:
        self.tbo_last = None
        self.stamp_last = None
        self.motion_updates = 0
        self.sensor_updates = 0
        self.n_alive_host = self.config.n_particles
        # the cloud just changed: re-audit the budgets, re-evaluate the gate
        self._budget_checked = False
        self._engine_gate_seen = False

    def warm(self, n_points: int = 0) -> None:
        """Build the kernels' libraries of the MCL path now (on the card;
        nothing to do on the CPU). PyTorch runs eagerly, so this — each
        kernel's ``nvcc`` build on first use — is the port's only first-use
        cost; ``n_points`` is taken for the JAX signature and unused."""
        if self.device.type != "cuda":
            return
        from rmcl_tpu_torch import _build

        for name in _KERNELS:
            _build.load_library(name)

    # -- periodic stages -----------------------------------------------------

    def motion_update(self, tbo: Transform, stamp: float) -> None:
        """Motion stage from the odometry transform base -> odom at ``stamp``."""
        if self.tbo_last is None:
            self.tbo_last, self.stamp_last = tbo, stamp
            return
        dt = stamp - self.stamp_last
        if dt <= 1e-7:
            return
        delta = self.tbo_last.inverse() @ tbo  # T_bnew_bold
        delta = Transform(rot=delta.rot.to(self.device), trans=delta.trans.to(self.device))
        with self.timer.stage("motion_update", block_on=lambda: self.cloud):
            self.cloud = motion_update(
                self.cloud, delta, float(dt), self.config.motion,
                bvh=self.bvh if self.config.motion.check_collisions else None)
        self.tbo_last, self.stamp_last = tbo, stamp
        self.motion_updates += 1

    def _check_budgets(self, points_s: Tensor, points_mask: Tensor, tsb: Transform) -> None:
        """One-shot audit of the binned engine's budgets on the real update
        rays (a deterministic probe generator, so the filter's stream is not
        consumed): if a level truncates some block, adopt
        :func:`suggest_budgets`' recommendation (quantized to the rung
        ladder, c_mid included) when ``auto_budget``, else warn."""
        import warnings

        from rmcl_tpu_torch.mcl.sensor_update import probe_update_rays
        from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats
        from rmcl_tpu_torch.utils.tune import suggest_budgets

        self._budget_checked = True
        cfg = self.config.sensor
        probe = torch.Generator(device=self.device).manual_seed(self.config.seed ^ 0x5AFE)
        o, d, t_cap = probe_update_rays(self.cloud, probe, points_s, points_mask, tsb, cfg)
        _, sat = block_cull_stats(self.bins, o, d, t_max=t_cap, block_size=cfg.block_size,
                                  c_super=cfg.c_super, c_bin=cfg.c_bin,
                                  sub_blocks=cfg.sub_blocks, c_mid=cfg.c_mid,
                                  c_hyper=cfg.c_hyper)
        sat = sat.cpu().numpy()
        frac = float(sat.mean())
        self.last_audit = dict(sat_fraction=frac, adopted=False)
        if not sat.any():
            return  # no level truncated any sampled block: certified
        if not self.config.auto_budget:
            warnings.warn(
                f"binned sensor-update budgets saturate on this map/cloud: {frac:.0%} of ray "
                f"blocks truncated at some cull level (c_super={cfg.c_super}/c_bin="
                f"{cfg.c_bin}) — likelihoods may silently drop geometry. Raise the budgets or "
                f"enable MCLConfig.auto_budget.", stacklevel=3)
            return
        rec = suggest_budgets(self.bins, o, d, t_max=t_cap, block_size=cfg.block_size)
        cs, cb = self._budget_rung(max(rec.c_super, cfg.c_super), max(rec.c_bin, cfg.c_bin))
        new = dataclasses.replace(cfg, c_super=cs, c_bin=cb, c_mid=rec.c_mid)
        if cfg.c_hyper and self.bins.hyper_aabb is not None:
            # the hyper level keeps c_hyper hypers of H supers, so the super
            # budget needs ceil(c_super / H) of them (the JAX node keeps
            # c_hyper, and its cull's top_k then fails on the larger rungs)
            H = self.bins.supers_per_hyper
            new = dataclasses.replace(new, c_hyper=max(cfg.c_hyper, -(-cs // H)))
        self.config.sensor = new
        self.last_audit = dict(sat_fraction=frac, adopted=True, c_super=cs, c_bin=cb,
                               c_mid=rec.c_mid, c_hyper=new.c_hyper, max_bins=rec.max_bins)

    @classmethod
    def _budget_rung(cls, c_super: int, c_bin: int):
        for cs, cb in cls._BUDGET_RUNGS:
            if cs >= c_super and cb >= c_bin:
                return cs, cb
        return c_super, c_bin  # beyond the ladder: adopt exactly

    @staticmethod
    def _spread_metrics(cloud: ParticleCloud) -> Tensor:
        """Weighted position spread (the root of the mean per-axis weighted
        variance) and heading spread (the sine of the weighted forward
        axes' spread about their mean), one (2,) tensor: one readback for
        the ``engine="auto"`` gate."""
        w = cloud.weights()
        mu = w @ cloud.poses.trans
        var = w @ (cloud.poses.trans - mu) ** 2
        spread = torch.sqrt(torch.clamp(torch.mean(var), min=0.0))
        fw = cloud.poses.rotate(torch.tensor([1.0, 0.0, 0.0], device=cloud.device))
        fw_mu = w @ fw
        fw_mu = fw_mu / torch.clamp(torch.sqrt(torch.sum(fw_mu * fw_mu)), min=1e-9)
        ca = torch.sum(w * torch.sum(fw * fw_mu[None, :], dim=-1))
        hspread = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0))
        return torch.stack([spread, hspread])

    def _auto_select_engine(self) -> None:
        """The engine for ``engine="auto"``. RC on the card: the exact BVH
        walk, with no readback. Otherwise the gate (:func:`auto_engine`):
        the exact walk for a scattered cloud and the dense binned engine
        once the weighted spread and heading spread fall below their
        thresholds (2x hysteresis to flip back), evaluated every
        ``auto_engine_period`` updates, one readback each time."""
        if self.bins is None or (self.device.type == "cuda"
                                 and self.config.sensor.correspondence_type != "CP"):
            self._engine_choice = "bvh"
            return
        period = max(int(self.config.auto_engine_period), 1)
        if self.sensor_updates % period and self._engine_gate_seen:
            return
        self._engine_gate_seen = True
        with timing.span("rmcl.mcl.gate"):
            spread, hspread = (float(x) for x in self._spread_metrics(self.cloud).cpu())
        prev = self._engine_choice
        choice = auto_engine(prev, spread, hspread, self.config.auto_engine_spread,
                             self.config.auto_engine_heading_spread)
        if choice != prev:
            self._engine_choice = choice
            # the binned engine needs a fresh budget audit for this cloud
            self._budget_checked = choice != "binned"

    def _compact_slice(self) -> Optional[int]:
        """Prefix length for compact compute, or None for the whole cloud:
        the live count rounded up to a power of two (the live set is a
        compacted prefix under a dynamic count)."""
        if (self.config.dynamic_count == "off" or not self.config.compact_compute
                or self.n_alive_host is None or self.n_alive_host >= self.config.n_particles):
            return None
        k = max(self.n_alive_host, self.config.min_particles_for_resample, 1)
        return min(1 << (k - 1).bit_length(), self.config.n_particles)

    def _accel_for(self, engine: str):
        if engine == "binned":
            return self.bins
        if engine == "seeded":
            return (self.bvh, self.bins)
        return self.bvh

    def effective_sensor_config(self) -> SensorUpdateConfig:
        """The sensor configuration the next update runs (``engine="auto"``
        resolved to the current choice)."""
        cfg = self.config.sensor
        if cfg.engine == "auto":
            return dataclasses.replace(cfg, engine=self._engine_choice)
        return cfg

    def sensor_update(self, points_s: Tensor, points_mask: Tensor, tsb: Transform) -> None:
        """Sensor stage on one point-cloud message. With a dynamic count,
        only the live prefix (padded to a power of two) is cast."""
        with timing.span("rmcl.mcl.upload"):
            points_s = torch.as_tensor(points_s, dtype=torch.float32).to(self.device)
            points_mask = torch.as_tensor(points_mask, dtype=torch.bool).to(self.device)
            tsb = Transform(rot=tsb.rot.to(self.device), trans=tsb.trans.to(self.device))
        if self.config.sensor.engine == "auto":
            self._auto_select_engine()
        eff_cfg = self.effective_sensor_config()
        # the audit runs when the binned engine is chosen: on the scattered
        # initial cloud it would adopt worst-case budgets for the whole run
        if (not self._budget_checked and eff_cfg.engine == "binned"
                and eff_cfg.correspondence_type != "CP"):
            self._check_budgets(points_s, points_mask, tsb)
            eff_cfg = self.effective_sensor_config()
        accel = self._accel_for(eff_cfg.engine)
        timing.count(f"rmcl.mcl.engine.{eff_cfg.engine}", 1)
        k = self._compact_slice()
        with self.timer.stage("sensor_update", block_on=lambda: self.cloud):
            if k is None:
                self.cloud = sensor_update(accel, self.cloud, self.generator, points_s,
                                           points_mask, tsb, eff_cfg)
            else:
                # the update changes only the likelihoods: write the
                # prefix's back in front of the rest
                sub = sensor_update(accel, self.cloud.map(lambda x: x[:k]), self.generator,
                                    points_s, points_mask, tsb, eff_cfg).likelihood
                lik = self.cloud.likelihood
                self.cloud = dataclasses.replace(self.cloud, likelihood=Gaussian1D(
                    *(torch.cat([getattr(sub, f), getattr(lik, f)[k:]])
                      for f in ("mean", "sigma", "n_meas"))))
        self.sensor_updates += 1

    def resample(self) -> bool:
        """Resampling stage; False when guarded away (it needs a motion and
        a sensor update, and at least ``min_particles_for_resample`` live
        particles)."""
        if self.motion_updates < 1 or self.sensor_updates < 1:
            return False
        n_live = (self.n_alive_host if self.n_alive_host is not None
                  else int(self.cloud.n_alive))
        if n_live < self.config.min_particles_for_resample:
            return False
        with self.timer.stage("resampling", block_on=lambda: self.cloud):
            if self.config.dynamic_count != "off":
                cap = self.config.n_particles
                if self.config.dynamic_count == "adaptive" and self.config.resampler != "gladiator":
                    n_target = adaptive_particle_count(
                        self.cloud, n_min=self.adaptive_n_min_eff, n_max=cap,
                        spread_ref=self.config.adaptive_spread_ref)
                else:
                    n_target = torch.tensor(cap, dtype=torch.int32, device=self.device)
                if self.config.resampler == "gladiator":
                    new = gladiator_resample(self.cloud, self.generator, self.config.resampling)
                else:
                    new = residual_resample_dynamic(self.cloud, self.generator,
                                                    self.config.resampling, n_target)
                n_new = int(new.n_alive)
                if n_new < self.config.min_particles_for_resample:
                    return False  # keep the previous cloud, not a collapsed one
                self.cloud = new
                self.n_alive_host = n_new
            else:
                fn = _RESAMPLERS[self.config.resampler]
                self.cloud = fn(self.cloud, self.generator, self.config.resampling)
        return True

    # -- outputs ---------------------------------------------------------------

    def estimate(self) -> ParticleStats:
        with timing.span("rmcl.mcl.estimate"):
            return estimate_stats(self.cloud,
                                  max_induction_particles=self.config.max_induction_particles)

    def pose_map_odom(self, tbo: Transform) -> Transform:
        """map -> odom: Tom = Tbm * ~Tbo."""
        pose = self.estimate().pose
        tbo = Transform(rot=tbo.rot.to(self.device), trans=tbo.trans.to(self.device))
        return pose @ tbo.inverse()

    def ess(self) -> float:
        return float(effective_sample_size(self.cloud))
