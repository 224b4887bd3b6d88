"""Headline benchmark on the card — the reference's corrector workload.

    python -m rmcl_tpu_torch.bench

Reproduces the reference's corrector benchmark (``BASELINE.md``,
``lidar_corrector_embree_benchmark.cpp``): a VLP-16 model (900 x 16 =
14,400 rays a pose), 1000 poses corrected at once against a synthetic
~1M-face sphere; one correction = cast the sensor from every pose estimate
-> masked point-to-plane reduce -> one Umeyama solve per pose, through the
library's batch corrector, :class:`rmcl_tpu_torch.micp.batch.BatchCorrector`
(K3's factored cull through hypers -> supers -> bins, K4, then the
epilogue kernel), on rays in
:class:`~rmcl_tpu_torch.ops.raycast_binned.TiledSweep` blocks of 16 poses x
8 directions. One cull (with an origin margin) serves each chain of
``BENCH_STEPS`` jittered corrections (candidate reuse).

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
``BENCH_SUBBLOCKS``, ``BENCH_REUSE``, ``BENCH_MARGIN``, ``BENCH_STEPS``)
and refuses the removed ``BENCH_ENGINE`` (other than ``factored``) and
``BENCH_FUSED=1``. Prints ONE JSON line.
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
from rmcl_tpu_torch.micp.batch import BatchCorrector
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
    ``steps``). Raises on the removed dense engine and fused reduction."""
    if env.get("BENCH_ENGINE", "factored") != "factored" or env.get("BENCH_FUSED") == "1":
        raise ValueError("BENCH_ENGINE and BENCH_FUSED were removed: the bench runs the batch "
                         "corrector (the factored engine) alone")
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
    ), run


class SweepBench:
    """The pose-sweep workload: map, sensor, poses and the batch corrector.

    ``mesh`` replaces the sphere of ``faces`` faces (a small map for tests);
    ``width`` the VLP-16's 900 azimuth steps."""

    def __init__(self, faces=1_000_000, n_poses=1000, seed=0, bin_size=64, bins_per_super=16,
                 supers_per_hyper=16, c_bin=64, c_super=24, c_hyper=20, c_mid=0, sub_blocks=128,
                 block_chunk=512, payload="plane", poses_per_tile=16, az_tile=8, el_tile=1,
                 reuse=True, margin=0.03, width=900, mesh=None, device="cuda"):
        dev = resolve_device(device)
        if mesh is None:
            n = int(np.sqrt(faces / 2))
            mesh = make_sphere(n, n, radius=50.0)
        self.faces = faces
        t0 = time.perf_counter()
        bins = build_bins(mesh, bin_size=bin_size, bins_per_super=bins_per_super,
                          supers_per_hyper=supers_per_hyper, device=dev)
        self.build_s = time.perf_counter() - t0
        self.model = SphericalModel.vlp16(width=width)
        self.rng = np.random.default_rng(seed)
        self.trans_true_np = self.rng.uniform(-5, 5, size=(n_poses, 3)).astype(np.float32)
        self.trans_true = torch.from_numpy(self.trans_true_np).to(dev)
        self.reuse = reuse
        self.margin = margin
        # with reuse off the steps cull afresh (every move reaches a zero margin)
        self.corrector = BatchCorrector(bins, self.model, self.trans_true_np, MAX_DIST,
                                        margin if reuse else 0.0, poses_per_tile, az_tile,
                                        el_tile, c_super=c_super, c_bin=c_bin, c_hyper=c_hyper,
                                        c_mid=c_mid, sub_blocks=sub_blocks,
                                        block_chunk=block_chunk, payload=payload)
        self.sweep = self.corrector.sweep
        self.dirs = self.corrector.dirs  # (n_dirs, 3) sensor frame
        self.device = dev

    @property
    def bins(self):
        """The map's bins: the corrector's, so that a replacement reaches it."""
        return self.corrector.bins

    @bins.setter
    def bins(self, bins):
        self.corrector.bins = bins

    @property
    def n_rays(self) -> int:
        return self.trans_true.shape[0] * self.dirs.shape[0]

    def make_dataset(self, trans: Tensor):
        """Sensor-frame scan points per pose and their hit mask."""
        point, _, hit = self.corrector.cast(trans)
        return point - trans[:, None, :], hit

    def candidates(self, est: Tensor):
        """One cull at the estimate, inflated by the margin for reuse."""
        return self.corrector.candidates(est)[0]

    def correction(self, data_points: Tensor, data_mask: Tensor, trans_est: Tensor,
                   candidates=None):
        """One correction for all poses: the corrector's
        :meth:`~rmcl_tpu_torch.micp.batch.BatchCorrector.correct`. Returns
        (the per-pose increment Transform, n_meas)."""
        return self.corrector.correct(data_points, data_mask, trans_est, candidates)

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
        """``n`` corrections, each composed onto the estimate (est <- delta(est)),
        through the corrector's steps, which keep a cull while no pose moved
        past the margin; returns the final translation estimates."""
        for _ in range(n):
            est = self.corrector.step(data_points, data_mask, est).trans
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
    data_points, data_mask = bench.make_dataset(trans)
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
    }
    if bench.reuse:
        result["candidate_reuse"] = {"margin_m": bench.margin, "cull_per_steps": k}
    result["vs_baseline"] = round(value / BASELINE_EMBREE.get(faces, BASELINE_EMBREE_1M), 4)
    result["device"] = _card()
    result["ms_per_correction"] = [round(t * 1e3, 3) for t in times[1:]]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
