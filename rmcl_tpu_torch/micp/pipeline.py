"""The MICP-L correction pipeline.

Counterpart of ``rmcl_tpu.micp.pipeline`` (unsharded): one correction
finds ray-cast correspondences once, then runs ``optimization_iterations``
Gauss-Newton (or Umeyama) iterations over the pre-transformed statistics,
with adaptive max-dist annealing from the convergence progress and a NaN
guard on the new pose (reference micp_localization.cpp:856-1016).

Correspondences are ray-cast (``corr_type="RC"``) or closest-point
(``"CP"``), found on a ``BVH`` (the exact engine) or on ``TriangleBins``
(the dense binned engine). Unsharded, the point-to-plane Gauss-Newton loop
(the default solver) on the card is one hand-written kernel
(:mod:`rmcl_tpu_torch.ops.solve_cuda`). Elsewhere the loop runs as torch
operations; their normal-equation and covariance sums are broadcast products
summed over the points, so they stay in full float32 on the card (the JAX
package asks for ``Precision.HIGHEST``).

Sharded over rays (``mesh`` and ``axis`` given; every rank runs the same
call on its shard, as JAX's ``psum_axis`` body runs inside ``shard_map``):
each RC sensor casts only its rank's window of pixels
(:class:`~rmcl_tpu_torch.sensors.models.RaySliceModel`), CP points arrive
sharded, and the reduction is one packed all-reduce per solver iteration
plus one for the final statistics: K + 1 collectives a correction. The
centroid's numerators ride iteration 1 about the base position and the
normal equations are re-centred after it (:func:`_shift_Ab`); Umeyama
reduces raw moments. That arithmetic is the JAX package's sharded one, which
differs from the unsharded path by float32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.se3 import Quaternion, Transform
from rmcl_tpu_torch.math.stats import umeyama_transform
from rmcl_tpu_torch.micp.correspondences import Correspondences, find_cpc, find_rcc
from rmcl_tpu_torch.ops.solve_cuda import OUT_SLICES, p2l_gauss_newton
from rmcl_tpu_torch.sensors.models import RaySliceModel, SensorModel
from rmcl_tpu_torch.utils import timing

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
    """One sensor's frozen measurement snapshot. ``cp_order_points``: (N,
    3) points whose Morton order blocks a closest-point query on bins (the
    node's: the map-frame points at the scan's first correction, so the
    scan keeps its blocks, and the budgets audited for them, from one pose
    estimate to the next); None orders each correction's map-frame points,
    as the JAX package does."""

    model: SensorModel
    points: Tensor  # (N, 3) dataset points, sensor frame
    mask: Tensor  # (N,) valid (range-gated) measurements
    tsb: Transform  # sensor → base
    config: MICPSensorConfig
    cp_order_points: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class MICPConfig:
    """Node-level correction settings.

    solver: "p2l_gn" (point-to-plane Gauss-Newton about the correspondence
    centroid, the default) or "umeyama" (project onto the model planes,
    then a point-to-point Umeyama/Kabsch solve — the reference's scheme).
    ``c_super``/``c_bin`` are the binned engine's candidate budgets;
    ``c_mid`` > 0 adds the ray cull's mid level and ``c_hyper`` > 0 its
    hyper level (bins built with one), 0 leaving each off. ``cp_super``/
    ``cp_bin`` > 0 are the closest-point query's own budgets (its cull, K7,
    needs others than the ray cull); 0 takes ``c_super``/``c_bin``, the
    JAX package's one pair."""

    optimization_iterations: int = 5
    adaptive_max_dist: bool = True
    disable_correction: bool = False
    solver: str = "p2l_gn"
    gn_damping: float = 1e-6
    c_super: int = 24
    c_bin: int = 96
    c_mid: int = 0
    c_hyper: int = 0
    cp_super: int = 0
    cp_bin: int = 0

    def cp_budgets(self) -> Tuple[int, int]:
        """The closest-point query's (c_super, c_bin)."""
        return self.cp_super or self.c_super, self.cp_bin or self.c_bin


# the statistics MICPStats carries for every correction
STATISTICS = ("total_measurements", "valid_measurements", "valid_matches", "covariance_trace",
              "convergence_progress")


@dataclasses.dataclass(frozen=True)
class MICPStats:
    """Per-correction statistics (:data:`STATISTICS`), and
    ``truncated_blocks``: the closest-point query blocks on bins whose
    candidate list a budget cut, summed over the CP sensors (an int64
    device scalar, never read back by the correction); None where no
    closest-point query ran on bins."""

    total_measurements: Tensor
    valid_measurements: Tensor
    valid_matches: Tensor  # merged n_meas
    covariance_trace: Tensor
    convergence_progress: Tensor
    truncated_blocks: Optional[Tensor] = None


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


def _p2x_raw_moments(pre_transform: Transform, dataset: Tensor, corr: Correspondences,
                     mask: Tensor, max_dist, ref: Tensor):
    """Masked p2x statistics as raw moments about ``ref``: (Sd (3,), Sm (3,),
    Sdm (3, 3), n) with ``Sd = sum (d - ref)``, ``Sm = sum (proj - ref)``,
    ``Sdm = sum (proj - ref)(d - ref)^T`` over the valid pairs. Plain sums,
    so a sharded reduction is one packed all-reduce; centring about a
    replicated ``ref`` keeps the float32 sums from cancelling."""
    d = pre_transform.apply(dataset)
    n = corr.model_normals
    signed = torch.sum(n * (d - corr.model_points), dim=-1)
    ok = mask & corr.found & (torch.abs(signed) <= max_dist)
    proj = d - signed[..., None] * n
    w = ok.to(d.dtype)
    dc = (d - ref) * w[..., None]
    mc = (proj - ref) * w[..., None]
    Sdm = torch.sum(mc[:, :, None] * (d - ref)[:, None, :], dim=0)
    return torch.sum(dc, 0), torch.sum(mc, 0), Sdm, torch.sum(w)


def _stats_from_raw(Sd, Sm, Sdm, n, ref) -> CrossStatistics:
    """The normalized CrossStatistics from summed raw moments."""
    safe_n = torch.clamp(n, min=1.0)
    db = Sd / safe_n  # dataset mean - ref
    mb = Sm / safe_n
    cov = Sdm / safe_n - torch.outer(mb, db)
    empty = n <= 0.0
    z3 = torch.zeros_like(db)
    return CrossStatistics(
        dataset_mean=torch.where(empty, z3, ref + db),
        model_mean=torch.where(empty, z3, ref + mb),
        covariance=torch.where(empty, 0.0, cov),
        n_meas=n,
    )


def _triu(device) -> Tuple[Tensor, Tensor]:
    """A 6 x 6 matrix's upper triangle, row by row (``jnp.triu_indices(6)``)."""
    return tuple(torch.triu_indices(6, 6, device=device))


def _pack_Ab(A: Tensor, b: Tensor, extra=()) -> Tensor:
    """One flat float32 vector: A's upper triangle (21), b (6) and the
    extras, the single all-reduce payload of a Gauss-Newton iteration."""
    return torch.cat([A[_triu(A.device)], b] + [torch.atleast_1d(e).reshape(-1) for e in extra])


def _unpack_Ab(v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    A = torch.zeros((6, 6), dtype=v.dtype, device=v.device)
    A[_triu(v.device)] = v[:21]
    A = A + A.T - torch.diag(torch.diag(A))
    return A, v[21:27], v[27:]


def _shift_Ab(A: Tensor, b: Tensor, s: Tensor) -> Tuple[Tensor, Tensor]:
    """Move the normal equations from reference point c0 to c = c0 - s
    exactly: Jacobian rows map as [n, j] -> [n, j + s x n], i.e. J' = J M^T
    with M = [[I, 0], [skew(s), I]], so A' = M A M^T and b' = M b."""
    z = torch.zeros((), dtype=A.dtype, device=A.device)
    S = torch.stack([torch.stack([z, -s[2], s[1]]), torch.stack([s[2], z, -s[0]]),
                     torch.stack([-s[1], s[0], z])])
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = torch.cat([torch.cat([eye, torch.zeros_like(eye)], 1), torch.cat([S, eye], 1)], 0)
    return M @ A @ M.T, M @ b


def _annealed_max_dist(cfg: MICPSensorConfig, progress: Tensor, enabled: bool):
    """Linear annealing of the gating distance with convergence progress."""
    if not enabled:
        return cfg.max_dist
    return cfg.max_dist * (1.0 - progress) + cfg.adaptive_max_dist_min * progress


def find_correspondences(bvh: "BVH | TriangleBins", sensors: Sequence[MICPSensorData],
                         tbm: Transform, chunk_size: int = 262144, c_super: int = 24,
                         c_bin: int = 96, c_mid: int = 0, c_hyper: int = 0, mesh=None,
                         axis: str = "rays", cp_super: int = 0,
                         cp_bin: int = 0) -> Tuple[Correspondences, ...]:
    """One correspondence search per sensor from the pose estimate: closest
    points for a ``"CP"`` sensor (gated at its ``max_dist``; on bins at the
    budgets ``cp_super``/``cp_bin``, where 0 takes ``c_super``/``c_bin``), a
    ray cast otherwise (``c_mid``/``c_hyper`` reach only the ray cast, as in
    the JAX package).

    ``mesh`` (a :class:`~rmcl_tpu_torch.parallel.mesh.Mesh`) with the rays
    sharded over its ``axis``: each sensor's points and mask are this rank's
    shard, and its model is cut to the same window of pixels
    (:class:`RaySliceModel`), so the search stays local to the rank."""
    if mesh is not None:
        idx = mesh.axis_index(axis)
        sensors = [dataclasses.replace(s, model=RaySliceModel(
            inner=s.model, start=idx * int(s.points.shape[0]), size=int(s.points.shape[0])))
            for s in sensors]
    out = []
    for s in sensors:
        tsm = tbm @ s.tsb
        if s.config.corr_type == "CP":
            out.append(find_cpc(bvh, s.points, s.mask, tsm, s.config.max_dist,
                                chunk_size=chunk_size, c_super=cp_super or c_super,
                                c_bin=cp_bin or c_bin, cluster_by=s.cp_order_points))
        else:
            out.append(find_rcc(bvh, s.model, tsm, chunk_size=chunk_size, c_super=c_super,
                                c_bin=c_bin, c_mid=c_mid, c_hyper=c_hyper))
    return tuple(out)


def correct_once(bvh: "BVH | TriangleBins", sensors: Sequence[MICPSensorData],
                 tom: Transform, tbo: Transform, convergence_progress,
                 config: MICPConfig = MICPConfig(), chunk_size: int = 262144, mesh=None,
                 axis: str = "rays") -> Tuple[Transform, MICPStats]:
    """One full correction: correspondences → K solver iterations → new Tom.
    ``bvh`` is the map's ``BVH`` or its ``TriangleBins``.

    With ``mesh``, every rank of the mesh calls this on its shard of each
    sensor's points and mask (rays sharded over ``axis``; the map, poses and
    models whole on every rank) and gets the same replicated result: the
    search stays local and the reduction takes K + 1 all-reduces (module
    docstring)."""
    with timing.span("rmcl.micp.correspond"):
        corrs = find_correspondences(bvh, sensors, tom @ tbo, chunk_size=chunk_size,
                                     c_super=config.c_super, c_bin=config.c_bin,
                                     c_mid=config.c_mid, c_hyper=config.c_hyper, mesh=mesh,
                                     axis=axis, cp_super=config.cp_super, cp_bin=config.cp_bin)
    with timing.span("rmcl.micp.optimize"):
        tom_new, stats = correct_from_correspondences(sensors, corrs, tom, tbo,
                                                      convergence_progress, config, mesh=mesh,
                                                      axis=axis)
    truncated = [c.truncated for c in corrs if c.truncated is not None]
    if truncated:  # this rank's blocks, where sharded
        stats = dataclasses.replace(stats, truncated_blocks=sum(truncated[1:], truncated[0]))
    return tom_new, stats


def correct_from_correspondences(
    sensors: Sequence[MICPSensorData],
    corrs: Sequence[Correspondences],
    tom: Transform,
    tbo: Transform,
    convergence_progress,
    config: MICPConfig = MICPConfig(),
    mesh=None,
    axis: str = "rays",
) -> Tuple[Transform, MICPStats]:
    """The optimization half of :func:`correct_once`: K iterations over
    given correspondences → new Tom (reference :915-1016). ``mesh``: the
    correspondences are this rank's shard over ``axis``, reduced by one
    packed all-reduce an iteration plus one for the statistics.

    Unsharded with ``solver="p2l_gn"`` on CUDA tensors, the whole loop is
    one launch of :func:`~rmcl_tpu_torch.ops.solve_cuda.p2l_gauss_newton`
    and no host sync; every other call runs :func:`_correct_torch`."""
    dev = tom.trans.device
    progress_in = torch.as_tensor(convergence_progress, dtype=torch.float32, device=dev)
    if mesh is None and config.solver == "p2l_gn" and dev.type == "cuda":
        return _correct_fused(sensors, corrs, tom, tbo, progress_in, config)
    return _correct_torch(sensors, corrs, tom, tbo, progress_in, config, mesh, axis)


def _correct_fused(sensors, corrs, tom: Transform, tbo: Transform, progress_in: Tensor,
                   config: MICPConfig) -> Tuple[Transform, MICPStats]:
    """The unsharded point-to-plane loop as one kernel launch: the new pose
    and the statistics are views of its ``(12,)`` output."""
    out = p2l_gauss_newton(sensors, corrs, tom, tbo, progress_in, config)
    timing.count("rmcl.micp.optimize.fused", 1)
    return Transform(rot=out[OUT_SLICES["rot"]], trans=out[OUT_SLICES["trans"]]), MICPStats(
        **{name: out[OUT_SLICES[name]] for name in STATISTICS})


def _correct_torch(sensors, corrs, tom: Transform, tbo: Transform, progress_in: Tensor,
                   config: MICPConfig, mesh, axis: str) -> Tuple[Transform, MICPStats]:
    """:func:`correct_from_correspondences` as torch operations, on any
    device, sharded or not: each iteration in its ``rmcl.micp.iteration``
    span, each solve in ``rmcl.micp.solve``. The plain version the kernel
    is held to."""
    dev = tom.trans.device
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

    if mesh is None:
        # shared conditioning centroid over all valid correspondences
        c_sum = sum(torch.sum(d * m[..., None], 0) for d, _, _, m, _ in lifted)
        c_cnt = sum(torch.sum(m.to(torch.float32)) for *_, m, _ in lifted)
        centroid = c_sum / torch.clamp(c_cnt, min=1.0)
    else:
        # the centroid's sums ride iteration 1's all-reduce (about c0)
        centroid = None
    c0 = tbo.trans  # base position in the odom frame, replicated

    t_onew_oold = Transform.identity(device=dev)
    for it in range(config.optimization_iterations):
        with timing.span("rmcl.micp.iteration"):
            if config.solver == "umeyama":
                if mesh is None:
                    merged = CrossStatistics.empty(device=dev)
                    for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
                        corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
                        merged = merged + statistics_p2l(
                            t_onew_oold, d_o, corr_o, ok, max_dist).scale_weight(scfg.weight)
                else:
                    # raw-moment sums, one packed all-reduce
                    raw = torch.zeros(16, dtype=torch.float32, device=dev)
                    for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
                        corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
                        sd, sm, sdm, nn = _p2x_raw_moments(t_onew_oold, d_o, corr_o, ok,
                                                           max_dist, c0)
                        raw = raw + scfg.weight * torch.cat([sd, sm, sdm.reshape(9), nn[None]])
                    raw = mesh.psum(raw, axis)
                    merged = _stats_from_raw(raw[0:3], raw[3:6], raw[6:15].reshape(3, 3),
                                             raw[15], c0)
                with timing.span("rmcl.micp.solve"):
                    delta = umeyama_transform(merged)
            elif config.solver == "p2l_gn":
                A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
                b = torch.zeros((6,), dtype=torch.float32, device=dev)
                first = mesh is not None and it == 0
                cext = torch.zeros(4, dtype=torch.float32, device=dev)
                for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
                    A_s, b_s, _ = p2l_normal_equations(
                        t_onew_oold, d_o, m_o, n_o, ok, max_dist, c0 if first else centroid)
                    A = A + scfg.weight * A_s
                    b = b + scfg.weight * b_s
                    if first:
                        mf = ok.to(torch.float32)
                        cext = cext + torch.cat([torch.sum((d_o - c0) * mf[..., None], 0),
                                                 torch.sum(mf)[None]])
                if mesh is not None:
                    A, b, cext = _unpack_Ab(mesh.psum(_pack_Ab(A, b, (cext,)), axis))
                    if first:
                        centroid = c0 + cext[:3] / torch.clamp(cext[3], min=1.0)
                        A, b = _shift_Ab(A, b, c0 - centroid)
                with timing.span("rmcl.micp.solve"):
                    delta = _solve_p2l_delta(A, b, centroid, config.gn_damping)
            else:
                raise ValueError(f"unknown solver {config.solver!r}")
            # stats measured on pre-transformed data ⇒ the increment composes on
            # the LEFT of the accumulated delta
            t_onew_oold = (delta @ t_onew_oold).normalized()

    # final merged statistics for reporting — UNWEIGHTED, like the
    # reference's Cmerged_o
    if mesh is None:
        merged_final = CrossStatistics.empty(device=dev)
        for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
            corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
            merged_final = merged_final + statistics_p2l(t_onew_oold, d_o, corr_o, ok, max_dist)
    else:
        # the valid count rides the statistics' all-reduce
        raw = torch.zeros(16, dtype=torch.float32, device=dev)
        for (d_o, m_o, n_o, ok, scfg), max_dist in zip(lifted, gates):
            corr_o = Correspondences(model_points=m_o, model_normals=n_o, found=ok)
            sd, sm, sdm, nn = _p2x_raw_moments(t_onew_oold, d_o, corr_o, ok, max_dist, c0)
            raw = raw + torch.cat([sd, sm, sdm.reshape(9), nn[None]])
        valid_loc = sum(torch.sum(s.mask.to(torch.float32)) for s in sensors)
        raw = mesh.psum(torch.cat([raw, valid_loc.reshape(1)]), axis)
        merged_final = _stats_from_raw(raw[0:3], raw[3:6], raw[6:15].reshape(3, 3), raw[15], c0)

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
    if mesh is None:
        valid = sum(torch.sum(s.mask.to(torch.float32)) for s in sensors)
    else:
        # the shapes are this rank's shard
        total *= mesh.axis_size(axis)
        valid = raw[16]
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
