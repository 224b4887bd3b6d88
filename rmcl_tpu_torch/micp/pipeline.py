"""The MICP-L correction pipeline.

Counterpart of ``rmcl_tpu.micp.pipeline`` (unsharded): one correction
finds ray-cast correspondences once, then runs ``optimization_iterations``
Gauss-Newton (or Umeyama) iterations over the pre-transformed statistics,
with adaptive max-dist annealing from the convergence progress and a NaN
guard on the new pose (reference micp_localization.cpp:856-1016).

The normal-equation and covariance sums are broadcast products summed over
the points, so they stay in full float32 on the card (the JAX package asks
for ``Precision.HIGHEST``). Closest-point correspondences and the sharded
reduction are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.se3 import Quaternion, Transform
from rmcl_tpu_torch.math.stats import umeyama_transform
from rmcl_tpu_torch.micp.correspondences import Correspondences, find_rcc
from rmcl_tpu_torch.sensors.models import SensorModel

Tensor = torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class MICPSensorConfig:
    """Per-sensor correspondence settings (held as float32-rounded floats)."""

    max_dist: float
    adaptive_max_dist_min: float
    weight: float
    corr_type: str = "RC"

    @staticmethod
    def create(max_dist=0.5, adaptive_max_dist_min=0.15, weight=1.0, corr_type="RC"):
        return MICPSensorConfig(
            max_dist=_f32(max_dist),
            adaptive_max_dist_min=_f32(adaptive_max_dist_min),
            weight=_f32(weight),
            corr_type=corr_type,
        )


@dataclasses.dataclass(frozen=True)
class MICPSensorData:
    """One sensor's frozen measurement snapshot."""

    model: SensorModel
    points: Tensor  # (N, 3) dataset points, sensor frame
    mask: Tensor  # (N,) valid (range-gated) measurements
    tsb: Transform  # sensor → base
    config: MICPSensorConfig


@dataclasses.dataclass(frozen=True)
class MICPConfig:
    """Node-level correction settings.

    solver: "p2l_gn" (point-to-plane Gauss-Newton about the correspondence
    centroid, the default) or "umeyama" (project onto the model planes,
    then a point-to-point Umeyama/Kabsch solve — the reference's scheme).
    ``c_super``/``c_bin`` are the binned engine's candidate budgets."""

    optimization_iterations: int = 5
    adaptive_max_dist: bool = True
    disable_correction: bool = False
    solver: str = "p2l_gn"
    gn_damping: float = 1e-6
    c_super: int = 24
    c_bin: int = 96


@dataclasses.dataclass(frozen=True)
class MICPStats:
    """Per-correction statistics."""

    total_measurements: Tensor
    valid_measurements: Tensor
    valid_matches: Tensor  # merged n_meas
    covariance_trace: Tensor
    convergence_progress: Tensor


def statistics_p2l(pre_transform: Transform, dataset: Tensor, corr: Correspondences,
                   mask: Tensor, max_dist) -> CrossStatistics:
    """Masked point-to-plane cross-statistics reduction
    (``rm::statistics_p2l``): pre-transform the dataset, gate on |signed
    plane distance| <= max_dist, accumulate (dataset, projection) pairs."""
    d = pre_transform.apply(dataset)
    n = corr.model_normals
    signed = torch.sum(n * (d - corr.model_points), dim=-1)
    ok = mask & corr.found & (torch.abs(signed) <= max_dist)
    proj = d - signed[..., None] * n
    return CrossStatistics.from_masked_points(d, proj, ok)


def p2l_normal_equations(pre_transform: Transform, dataset: Tensor,
                         model_points: Tensor, normals: Tensor, mask: Tensor,
                         max_dist, centroid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The point-to-plane Gauss-Newton system about ``centroid``.

    Residual r_i = n_i · (d_i - m_i); Jacobian row J_i = [n_i, (d_i - c) x n_i].
    Returns (A (6,6), b (6,), n_meas)."""
    d = pre_transform.apply(dataset)
    r = torch.sum(normals * (d - model_points), dim=-1)
    ok = (mask & (torch.abs(r) <= max_dist)).to(d.dtype)
    j_rot = torch.linalg.cross(d - centroid, normals, dim=-1)
    J = torch.cat([normals, j_rot], dim=-1) * ok[..., None]  # (N, 6)
    A = torch.sum(J[:, :, None] * J[:, None, :], dim=0)
    b = -torch.sum(J * (r * ok)[:, None], dim=0)
    return A, b, torch.sum(ok)


def _solve_p2l_delta(A: Tensor, b: Tensor, centroid: Tensor, damping: float) -> Transform:
    """Solve A δ = b, build the SE(3) increment about the centroid."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    A = A + damping * eye * torch.clamp(torch.trace(A), min=1.0)
    delta = torch.linalg.solve(A, b)
    t, w = delta[:3], delta[3:]
    q = Quaternion.exp(w)
    # T = Trans(c) ∘ (R, t) ∘ Trans(-c)
    trans = centroid + t - Quaternion.rotate(q, centroid)
    return Transform(rot=q, trans=trans)


def _annealed_max_dist(cfg: MICPSensorConfig, progress: Tensor, enabled: bool):
    """Linear annealing of the gating distance with convergence progress."""
    if not enabled:
        return cfg.max_dist
    return cfg.max_dist * (1.0 - progress) + cfg.adaptive_max_dist_min * progress


def find_correspondences(bins: TriangleBins, sensors: Sequence[MICPSensorData],
                         tbm: Transform, c_super: int = 24,
                         c_bin: int = 96) -> Tuple[Correspondences, ...]:
    """One ray-cast correspondence search per sensor from the pose estimate."""
    out = []
    for s in sensors:
        if s.config.corr_type != "RC":
            raise NotImplementedError(
                f"correspondence type {s.config.corr_type!r} is not ported yet")
        out.append(find_rcc(bins, s.model, tbm @ s.tsb, c_super=c_super, c_bin=c_bin))
    return tuple(out)


def correct_once(bins: TriangleBins, sensors: Sequence[MICPSensorData],
                 tom: Transform, tbo: Transform, convergence_progress,
                 config: MICPConfig = MICPConfig()) -> Tuple[Transform, MICPStats]:
    """One full correction: ray cast → K solver iterations → new Tom."""
    corrs = find_correspondences(bins, sensors, tom @ tbo,
                                 c_super=config.c_super, c_bin=config.c_bin)
    return correct_from_correspondences(sensors, corrs, tom, tbo,
                                        convergence_progress, config)


def correct_from_correspondences(
    sensors: Sequence[MICPSensorData],
    corrs: Sequence[Correspondences],
    tom: Transform,
    tbo: Transform,
    convergence_progress,
    config: MICPConfig = MICPConfig(),
) -> Tuple[Transform, MICPStats]:
    """The optimization half of :func:`correct_once`: K iterations over
    given correspondences → new Tom (reference :915-1016)."""
    dev = tom.trans.device
    progress_in = torch.as_tensor(convergence_progress, dtype=torch.float32, device=dev)
    # lift per-sensor data into the odom frame once
    lifted = []
    for s, corr in zip(sensors, corrs):
        t_os = tbo @ s.tsb
        lifted.append((
            t_os.apply(s.points),
            t_os.apply(corr.model_points),
            t_os.rotate(corr.model_normals),
            s.mask & corr.found,
            s.config,
        ))
    gates = [_annealed_max_dist(scfg, progress_in, config.adaptive_max_dist)
             for *_, scfg in lifted]

    # shared conditioning centroid over all valid correspondences
    c_sum = sum(torch.sum(d * m[..., None], 0) for d, _, _, m, _ in lifted)
    c_cnt = sum(torch.sum(m.to(torch.float32)) for *_, m, _ in lifted)
    centroid = c_sum / torch.clamp(c_cnt, min=1.0)

    t_onew_oold = Transform.identity(device=dev)
    for _ in range(config.optimization_iterations):
        if config.solver == "umeyama":
            merged = CrossStatistics.empty(device=dev)
            for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
                corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
                merged = merged + statistics_p2l(
                    t_onew_oold, d_o, corr_o, ok, max_dist).scale_weight(scfg.weight)
            delta = umeyama_transform(merged)
        elif config.solver == "p2l_gn":
            A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
            b = torch.zeros((6,), dtype=torch.float32, device=dev)
            for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
                A_s, b_s, _ = p2l_normal_equations(
                    t_onew_oold, d_o, m_o, n_o, ok, max_dist, centroid)
                A = A + scfg.weight * A_s
                b = b + scfg.weight * b_s
            delta = _solve_p2l_delta(A, b, centroid, config.gn_damping)
        else:
            raise ValueError(f"unknown solver {config.solver!r}")
        # stats measured on pre-transformed data ⇒ the increment composes on
        # the LEFT of the accumulated delta
        t_onew_oold = (delta @ t_onew_oold).normalized()

    # final merged statistics for reporting — UNWEIGHTED, like the
    # reference's Cmerged_o
    merged_final = CrossStatistics.empty(device=dev)
    for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
        corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
        merged_final = merged_final + statistics_p2l(t_onew_oold, d_o, corr_o, ok, max_dist)

    if config.disable_correction:
        t_onew_oold = Transform.identity(device=dev)

    tom_new = (tom @ t_onew_oold).normalized()
    # NaN guard — keep the old pose if the update went non-finite
    finite = tom_new.is_finite()
    tom_new = Transform(
        rot=torch.where(finite, tom_new.rot, tom.rot),
        trans=torch.where(finite, tom_new.trans, tom.trans),
    )

    # convergence progress (reference :988-1007):
    # trans_progress = 1/exp(10*|t|); rot_progress = qw^2;
    # match_ratio = n_meas / valid
    total = sum(int(s.points.shape[0]) for s in sensors)
    valid = sum(torch.sum(s.mask.to(torch.float32)) for s in sensors)
    trans_progress = torch.exp(-10.0 * torch.sqrt(torch.sum(t_onew_oold.trans ** 2)))
    rot_progress = torch.square(t_onew_oold.rot[0])
    match_ratio = merged_final.n_meas / torch.clamp(valid, min=1.0)
    progress = trans_progress * rot_progress * torch.clamp(match_ratio, max=1.0)

    stats = MICPStats(
        total_measurements=torch.tensor(float(total), dtype=torch.float32, device=dev),
        valid_measurements=valid,
        valid_matches=merged_final.n_meas,
        covariance_trace=torch.trace(merged_final.covariance),
        convergence_progress=progress,
    )
    return tom_new, stats
