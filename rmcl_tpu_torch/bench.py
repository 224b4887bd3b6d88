"""Headline benchmark on the card — the reference's corrector workload.

    python -m rmcl_tpu_torch.bench
    BENCH_ENGINE=dense python -m rmcl_tpu_torch.bench
    BENCH_FUSED=1 python -m rmcl_tpu_torch.bench

Reproduces the reference's corrector benchmark (``BASELINE.md``,
``lidar_corrector_embree_benchmark.cpp``): a VLP-16 model (900 x 16 =
14,400 rays a pose), 1000 poses corrected at once against a synthetic
~1M-face sphere; one correction = cast the sensor from every pose estimate
-> masked point-to-plane reduce -> one Umeyama solve per pose. The rays
come in :class:`~rmcl_tpu_torch.ops.raycast_binned.TiledSweep` blocks of
16 poses x 8 directions. Engines (``BENCH_ENGINE``):

* ``factored`` (default): :func:`rmcl_tpu_torch.ops.raycast_binned.cast_rays_binned_factored`
  (K4), culled through hypers -> supers -> bins; one cull
  (``factored_candidates`` with an origin margin) serves each chain of
  ``BENCH_STEPS`` jittered corrections (candidate reuse). With
  ``BENCH_FUSED=1`` the reduction runs in sweep order on the dataset
  permuted once (:meth:`SweepBench.correction_fused`), and every
  correction culls afresh, as the JAX bench's fused variant does;
* ``dense``: :func:`~rmcl_tpu_torch.ops.raycast_binned.cast_rays_binned`
  on the sweep's materialized rays with ``dir_groups`` = the block's 8
  directions (K3 + K2g), at the cast's own cull defaults and with no
  reuse; its hits (point, normal, hit) are un-permuted to pose order.

Metric: correspondence rays per second of the full correction, timed over
chains of ``BENCH_STEPS`` corrections at distinct estimates (host clock
ending in ``torch.cuda.synchronize()``, cull included). ``vs_baseline``:
the ratio to the reference's Embree desktop-CPU number at the same face
count.

Reads the JAX bench's ``BENCH_*`` variables (``BENCH_FACES``,
``BENCH_POSES``, ``BENCH_ITERS``, ``BENCH_BIN_SIZE``, ``BENCH_CBIN``,
``BENCH_AZ_TILE``, ``BENCH_EL_TILE``, ``BENCH_POSES_PER_TILE``,
``BENCH_BPS``, ``BENCH_CMID``, ``BENCH_SPH``, ``BENCH_SEED``,
``BENCH_CHUNK``, ``BENCH_CHYPER``, ``BENCH_PAYLOAD``, ``BENCH_CSUPER``,
``BENCH_SUBBLOCKS``, ``BENCH_REUSE``, ``BENCH_MARGIN``, ``BENCH_STEPS``,
``BENCH_ENGINE``, ``BENCH_FUSED``). Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.mesh import make_sphere
from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import umeyama_transform
from rmcl_tpu_torch.ops.raycast_binned import (
    TiledSweep,
    cast_rays_binned,
    cast_rays_binned_factored,
    factored_candidates,
)
from rmcl_tpu_torch.sensors.models import SphericalModel

Tensor = torch.Tensor

BASELINE_EMBREE_1M = 71.6e6  # corr-rays/s, reference desktop CPU (Embree)
# per-face-count reference rows (lidar_corrector_embree_benchmark.cpp:145-152:
# 14.4M corr-rays in 0.183 / 0.201 / 0.456 s at 100k / 1M / 10M faces)
BASELINE_EMBREE = {
    100_000: 14.4e6 / 0.183,
    1_000_000: BASELINE_EMBREE_1M,
    10_000_000: 14.4e6 / 0.456,
}
MAX_DIST = 2.0  # point-to-plane gate of the correction (m)
JITTER = 0.02  # per-step estimate jitter of a timed chain (m), within the margin


def settings_from_env(env=os.environ) -> "tuple[dict, dict]":
    """The JAX bench's defaults and ``BENCH_*`` overrides, resolved:
    (the keywords of :class:`SweepBench`, the run's ``iters`` and
    ``steps``)."""
    get = lambda k, d: type(d)(env.get(k, d))
    faces = get("BENCH_FACES", 1_000_000)
    big = faces > 4_000_000
    run = dict(iters=get("BENCH_ITERS", 3), steps=get("BENCH_STEPS", 16))
    return dict(
        faces=faces,
        n_poses=get("BENCH_POSES", 1000),
        bin_size=get("BENCH_BIN_SIZE", 64),
        c_bin=get("BENCH_CBIN", 512 if big else 64),
        az_tile=get("BENCH_AZ_TILE", 8),
        el_tile=get("BENCH_EL_TILE", 1),
        poses_per_tile=get("BENCH_POSES_PER_TILE", 16),
        bins_per_super=get("BENCH_BPS", 16),
        c_mid=get("BENCH_CMID", 0),
        supers_per_hyper=get("BENCH_SPH", 16),
        seed=get("BENCH_SEED", 0),
        block_chunk=get("BENCH_CHUNK", 512),
        c_hyper=get("BENCH_CHYPER", 24 if big else 20),
        payload=get("BENCH_PAYLOAD", "plane"),
        c_super=get("BENCH_CSUPER", 128 if big else 24),
        # per-ray cull cones on big maps; coarser cones where candidate
        # sets are tiny anyway
        sub_blocks=get("BENCH_SUBBLOCKS", 128 if faces >= 400_000 else 8),
        reuse=get("BENCH_REUSE", "1") == "1",
        margin=get("BENCH_MARGIN", 0.03),
        engine=get("BENCH_ENGINE", "factored"),
        fused=get("BENCH_FUSED", "0") == "1",
    ), run


class SweepBench:
    """The pose-sweep workload: map, sensor, poses and the correction.

    ``mesh`` replaces the sphere of ``faces`` faces (a small map for tests);
    ``width`` the VLP-16's 900 azimuth steps. ``engine`` "factored" or
    "dense"; ``fused`` (factored only) reduces in sweep order."""

    def __init__(self, faces=1_000_000, n_poses=1000, seed=0, bin_size=64, bins_per_super=16,
                 supers_per_hyper=16, c_bin=64, c_super=24, c_hyper=20, c_mid=0, sub_blocks=128,
                 block_chunk=512, payload="plane", poses_per_tile=16, az_tile=8, el_tile=1,
                 reuse=True, margin=0.03, width=900, mesh=None, engine="factored", fused=False,
                 device="cuda"):
        if engine not in ("factored", "dense"):
            raise ValueError(f"unknown engine {engine!r}: 'factored' or 'dense'")
        if fused and engine != "factored":
            raise ValueError("the fused reduction runs on the factored engine only")
        dev = resolve_device(device)
        if mesh is None:
            n = int(np.sqrt(faces / 2))
            mesh = make_sphere(n, n, radius=50.0)
        self.faces = faces
        t0 = time.perf_counter()
        self.bins = build_bins(mesh, bin_size=bin_size, bins_per_super=bins_per_super,
                               supers_per_hyper=supers_per_hyper, device=dev)
        self.build_s = time.perf_counter() - t0
        self.model = SphericalModel.vlp16(width=width)
        self.dirs = self.model.rays(dev)[1]  # (n_dirs, 3) sensor frame
        self.rng = np.random.default_rng(seed)
        self.trans_true_np = self.rng.uniform(-5, 5, size=(n_poses, 3)).astype(np.float32)
        self.trans_true = torch.from_numpy(self.trans_true_np).to(dev)
        self.sweep = TiledSweep(self.trans_true_np, self.model.width, self.model.height,
                                poses_per_tile=poses_per_tile, az_tile=az_tile,
                                el_tile=el_tile)
        self.cull_kw = dict(c_bin=c_bin, block_chunk=block_chunk, c_mid=c_mid, c_hyper=c_hyper,
                            c_super=c_super, sub_blocks=sub_blocks)
        self.fact_kw = dict(self.cull_kw, sort_blocks=True, payload=payload)
        # the dense engine: the JAX bench's cast_kw, the cast's defaults otherwise
        # (c_super 24, sub_blocks 4, no hyper level)
        self.cast_kw = dict(block_size=self.sweep.block_size, dir_groups=self.sweep.dir_groups,
                            c_bin=c_bin, block_chunk=512, sort_blocks=True, c_mid=c_mid)
        self.engine = engine
        self.fused = fused
        # candidate reuse is the factored engine's; the fused correction culls afresh
        self.reuse = reuse and engine == "factored" and not fused
        self.margin = margin
        self.device = dev

    @property
    def n_rays(self) -> int:
        return self.trans_true.shape[0] * self.dirs.shape[0]

    def cast_sweep(self, trans: Tensor, candidates=None):
        """Closest hit for every pose x every scan direction (identity
        rotations, the reference's translation sweep). Returns (points,
        normals, hit) in canonical (n_poses, n_dirs, ...) order. Factored:
        points from t along the shared scan direction; dense: the cast's
        points, un-permuted with its normals and hits."""
        n = self.sweep.n_rays
        if self.engine == "dense":
            o, d = self.sweep.rays(trans, self.dirs)
            hits = cast_rays_binned(self.bins, o, d, **self.cast_kw)
            packed = torch.cat([hits.point, hits.normal, hits.hit[:, None].to(torch.float32)],
                               dim=1)
            up = self.sweep.unpermute(packed)  # (n_poses, n_dirs, 7)
            return up[..., 0:3], up[..., 3:6], up[..., 6] > 0.5
        o_blk, d_blk = self.sweep.factored_rays(trans, self.dirs)
        hits = cast_rays_binned_factored(self.bins, o_blk, d_blk, candidates=candidates,
                                         **self.fact_kw)
        packed = torch.cat([hits.normal.reshape(n, 3), hits.t.reshape(n, 1),
                            hits.hit.reshape(n, 1).to(torch.float32)], dim=1)
        up = self.sweep.unpermute(packed)  # (n_poses, n_dirs, 5)
        t = up[..., 3]
        sim_p = trans[:, None, :] + t[..., None] * self.dirs[None]
        return sim_p, up[..., 0:3], up[..., 4] > 0.5

    def make_dataset(self, trans: Tensor):
        """Sensor-frame scan points per pose and their hit mask."""
        point, _, hit = self.cast_sweep(trans)
        return point - trans[:, None, :], hit

    def correction_layout(self, data_points: Tensor, data_mask: Tensor):
        """The dataset in the layout :meth:`correction` takes: as it is, or
        for the fused reduction permuted once into sweep order ((n_rays, 3)
        and (n_rays,)), as the reference unpacks a scan once a message."""
        if not self.fused:
            return data_points, data_mask
        return (self.sweep.permute(data_points),
                self.sweep.permute(data_mask[..., None])[..., 0])

    def candidates(self, est: Tensor):
        """One cull at the estimate, inflated by the margin for reuse."""
        o_blk, d_blk = self.sweep.factored_rays(est, self.dirs)
        return factored_candidates(self.bins, o_blk, d_blk, origin_margin=self.margin,
                                   **self.cull_kw)

    def correction(self, data_points: Tensor, data_mask: Tensor, trans_est: Tensor,
                   candidates=None):
        """One correction for all poses: cast -> point-to-plane reduce ->
        Umeyama. Returns (the per-pose increment Transform, n_meas). The
        dataset comes in :meth:`correction_layout`."""
        if self.fused:
            return self.correction_fused(data_points, data_mask, trans_est)
        sim_p, sim_n, sim_hit = self.cast_sweep(trans_est, candidates)
        # dataset into the map frame via the CURRENT estimate (identity rotations)
        d_map = data_points + trans_est[:, None, :]
        signed = torch.sum(sim_n * (d_map - sim_p), dim=-1)
        ok = data_mask & sim_hit & (torch.abs(signed) <= MAX_DIST)
        proj = d_map - signed[..., None] * sim_n
        stats = CrossStatistics.from_masked_points(d_map, proj, ok)
        return umeyama_transform(stats), stats.n_meas

    def correction_fused(self, data_sweep: Tensor, mask_sweep: Tensor, trans_est: Tensor):
        """One correction with the statistics reduced in sweep order (the
        JAX bench's ``correction_fused``): the hits stay in the cast's
        layout and :meth:`TiledSweep.pose_sums` reduces 16 channels a ray
        to the poses, in place of un-permuting the hits. The statistics are
        taken in each pose's local frame (sensor-frame points); the centred
        covariance does not change with the frame, but the increment's
        translation is the local frame's, so it differs from
        :meth:`correction`'s by (I - R) t_est. ``data_sweep (n_rays, 3)``,
        ``mask_sweep (n_rays,)`` from :meth:`correction_layout`."""
        o_blk, d_blk = self.sweep.factored_rays(trans_est, self.dirs)
        hits = cast_rays_binned_factored(self.bins, o_blk, d_blk, **self.fact_kw)
        n_rays = self.sweep.n_rays
        sim_p = hits.point.reshape(n_rays, 3)
        sim_n = hits.normal.reshape(n_rays, 3)
        sim_hit = hits.hit.reshape(n_rays)
        n_blk, P, _ = o_blk.shape
        G = d_blk.shape[1]
        o_r = o_blk[:, None].expand(n_blk, G, P, 3).reshape(n_rays, 3)
        # pose-local frames: the dataset is sensor-frame, the model point is proj - t
        sim_p_loc = sim_p - o_r
        signed = torch.sum(sim_n * (data_sweep - sim_p_loc), dim=-1)
        ok = mask_sweep & sim_hit & (torch.abs(signed) <= MAX_DIST)
        m_loc = data_sweep - signed[:, None] * sim_n
        outer = (m_loc[:, :, None] * data_sweep[:, None, :]).reshape(n_rays, 9)
        # selected, not multiplied by the mask as in the JAX bench: a ray the
        # dataset cast missed has a point at t = 3e38, whose moments times 0
        # are NaN (where every point is finite the sums are the same)
        ch = torch.where(ok[:, None], torch.cat([ok[:, None].to(torch.float32), data_sweep, m_loc,
                                                 outer], dim=1), 0.0)
        ps = self.sweep.pose_sums(ch)  # (n_poses, 16)
        n = ps[:, 0]
        safe = torch.clamp(n, min=1.0)[:, None]
        d_mean = ps[:, 1:4] / safe
        m_mean = ps[:, 4:7] / safe
        cov = ps[:, 7:16].reshape(-1, 3, 3) / safe[..., None] - m_mean[:, :, None] * d_mean[:, None, :]
        empty = (n <= 0.0)[:, None]
        stats = CrossStatistics(dataset_mean=torch.where(empty, 0.0, d_mean),
                                model_mean=torch.where(empty, 0.0, m_mean),
                                covariance=torch.where(empty[..., None], 0.0, cov), n_meas=n)
        return umeyama_transform(stats), n

    def chain(self, data_points: Tensor, data_mask: Tensor, est0: Tensor, jitters: Tensor):
        """``len(jitters)`` corrections at est0 + jitter, reusing one cull at
        est0 when reuse is on. Returns the last increment's translations."""
        cands = self.candidates(est0) if self.reuse else None
        acc = torch.zeros((), device=self.device)
        for jit in jitters:
            delta, n_meas = self.correction(data_points, data_mask, est0 + jit, cands)
            acc = acc + torch.sum(delta.trans) + torch.sum(n_meas)
        return delta.trans, acc

    def iterate(self, data_points: Tensor, data_mask: Tensor, est: Tensor, n: int):
        """``n`` corrections, each composed onto the estimate (est <- delta(est));
        returns the final translation estimates. The fused correction's
        increments are pose-local, so it does not iterate here."""
        if self.fused:
            raise ValueError("iterate composes map-frame increments: use the unfused correction")
        for _ in range(n):
            delta, _ = self.correction(data_points, data_mask, est)
            est = delta.apply(est)
        return est


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main():
    cfg, run = settings_from_env()
    if not torch.cuda.is_available():
        raise SystemExit("rmcl_tpu_torch.bench: no CUDA device; the benchmark runs on the card")
    bench = SweepBench(**cfg, device="cuda")
    trans = bench.trans_true
    data_points, data_mask = bench.correction_layout(*bench.make_dataset(trans))
    est0 = trans + torch.tensor([0.0, 0.0, 0.2], device=trans.device)  # reference's offset
    bench.correction(data_points, data_mask, est0)  # warm-up
    k = run["steps"]
    jit_sets = [torch.from_numpy(bench.rng.uniform(-JITTER, JITTER, size=(k,) + tuple(trans.shape))
                                 .astype(np.float32)).to(trans.device)
                for _ in range(run["iters"] + 1)]  # +1 warm
    times = []
    for js in jit_sets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.chain(data_points, data_mask, est0, js)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k)
    best = min(times[1:])
    faces = cfg["faces"]
    fk = f"{faces // 1_000_000}M" if faces >= 1_000_000 else f"{faces // 1000}k"
    value = bench.n_rays / best
    result = {
        "metric": f"micp_correction_rays_per_sec_{fk}faces",
        "value": round(value, 1),
        "unit": "corr-rays/s",
        "steps_per_timing": k,
        "engine": bench.engine,
        "fused": bench.fused,
    }
    if bench.reuse:
        result["candidate_reuse"] = {"margin_m": bench.margin, "cull_per_steps": k}
    result["vs_baseline"] = round(value / BASELINE_EMBREE.get(faces, BASELINE_EMBREE_1M), 4)
    result["device"] = _card()
    result["ms_per_correction"] = [round(t * 1e3, 3) for t in times[1:]]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
