"""The one generator of the benchmark's traffic, driven by a traffic file.

A ``scan_loop`` traffic drives a robot around a closed loop in the map. Its
file gives the loop, the scan rate, the range noise, the odometry drift and
the start (a loop pose and an offset from it in the base frame), and what
the node is asked (``node`` settings that the cell overrides, particles,
warm-up and the check's sample). The seed picks the drift's direction
(unless the file fixes it) and every range's noise: every seed sees the
same poses, sizes and rates, and a node that audits its budgets at the
start audits the same rays.

The true scans of the loop's poses are cast once by the plain caster and
kept in ``benchmark/cache`` under a key of everything that shapes them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from benchmark import world
from benchmark.reference import cast as rc

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "cache"


def load(kind: str, name: str, here: Path = ROOT) -> dict:
    """``<here>/<kind>/<name>.json`` (``here``: the benchmark's directory)."""
    path = Path(here) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def _cache_key(cfg: dict, traffic: dict) -> str:
    h = hashlib.sha256()
    h.update(json.dumps([cfg["map"], cfg["sensor"], traffic["loop"]], sort_keys=True).encode())
    for src in ("world.py", "reference/cast.py"):
        h.update((ROOT / src).read_bytes())
    return h.hexdigest()[:16]


def true_scans(cfg: dict, traffic: dict, tri: torch.Tensor, dirs: torch.Tensor):
    """Ranges (L, R) float32 and hits (L, R) of the loop's poses, cast by
    the plain caster at the truth (from the cache when it holds them)."""
    path = CACHE / f"scans-{_cache_key(cfg, traffic)}.npz"
    if path.is_file():
        with np.load(path) as z:
            return z["ranges"], z["hit"]
    poses = world.loop_poses(traffic["loop"])
    sensor = cfg["sensor"]
    ranges, hits = [], []
    for p in poses:
        m = torch.from_numpy(world.pose_matrix(p)).float().to(tri.device)
        d = (dirs @ m[:3, :3].T)[None]
        t_max = torch.full(d.shape[:2], float(np.float32(sensor["range_max"])), device=tri.device)
        t, face = rc.cast(tri, m[None, :3, 3], d, float(np.float32(sensor["range_min"])), t_max)
        ranges.append(torch.where(face >= 0, t, 0.0)[0].cpu().numpy())
        hits.append((face >= 0)[0].cpu().numpy())
    ranges, hits = np.stack(ranges).astype(np.float32), np.stack(hits)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, ranges=ranges, hit=hits)
    os.replace(tmp, path)
    return ranges, hits


def _xyyaw(x, y, yaw) -> np.ndarray:
    return world.pose_matrix([x, y, 0.0, 0.0, 0.0, yaw])


@dataclasses.dataclass
class Run:
    """One run's traffic. Slot k (one scan, at ``k / scan_rate_hz`` s) has
    its loop pose, true base pose and drifted odometry (4 x 4 float64), and
    its noisy scan (ranges, 0 where masked; mask); ``start`` is the start
    pose given to a tracker. Noise rows repeat after ``noise_slots`` slots."""

    traffic: dict
    loop: np.ndarray
    phase: int
    drift: tuple
    start: np.ndarray
    true_ranges: np.ndarray
    true_hits: np.ndarray
    noise: np.ndarray
    range_lo: np.float32
    range_hi: np.float32

    def loop_index(self, k: int) -> int:
        return (self.phase + k) % self.loop.shape[0]

    def truth(self, k: int) -> np.ndarray:
        return world.pose_matrix(self.loop[self.loop_index(k)])

    def tbo(self, k: int) -> np.ndarray:
        dx, dy, dyaw = self.drift
        return _xyyaw(k * dx, k * dy, k * dyaw) @ self.truth(k)

    def stamp(self, k: int) -> float:
        return k / float(self.traffic["scan_rate_hz"])

    def scan(self, k: int):
        """(ranges (R,) float32, mask (R,) bool) of slot k."""
        i = self.loop_index(k)
        r = self.true_ranges[i] + np.float32(self.traffic["range_noise_sigma"]) * self.noise[
            k % self.noise.shape[0]]
        mask = self.true_hits[i] & (r >= self.range_lo) & (r <= self.range_hi)
        return np.where(mask, r, np.float32(0.0)).astype(np.float32), mask


def make(cfg: dict, traffic: dict, seed: int, true_ranges: np.ndarray,
         true_hits: np.ndarray) -> Run:
    """The run's traffic, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    loop = world.loop_poses(traffic["loop"])
    step, dyaw = traffic["drift_per_scan"]
    ang = rng.uniform(0.0, 2.0 * math.pi)
    sign = float(rng.choice([-1.0, 1.0]))
    # a traffic may fix the drift: where the cloud's spread, and so the
    # cast's work, follows the drift, every seed then does the same work
    ang, sign = float(traffic.get("drift_angle", ang)), float(traffic.get("drift_yaw_sign", sign))
    drift = (step * math.cos(ang), step * math.sin(ang), dyaw * sign)
    noise = rng.standard_normal((int(traffic["noise_slots"]),) + true_ranges.shape[1:],
                                dtype=np.float32)
    sensor = cfg["sensor"]
    run = Run(traffic, loop, int(traffic["start_index"]), drift, np.eye(4), true_ranges,
              true_hits, noise, np.float32(sensor["range_min"]), np.float32(sensor["range_max"]))
    run.start = run.truth(0) @ _xyyaw(*traffic.get("start_offset", [0.0, 0.0, 0.0]))
    return run
