"""Drive the MICP-L node (``micp/node.py::MICPLocalization``) over a
``scan_loop`` traffic and judge its corrections against the plain reference.

Closed loop: corrections run back to back, each one read back to the host
as the pose; a new scan and its odometry are handed in every
``corrections_per_scan`` corrections (stamped at the traffic's scan rate).
A correction is timed from its start, the ingest of a new scan included,
to the pose on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark import world
from benchmark.reference import micp as ref
from benchmark.reference import se3

UNIT = "correction"


def _pose(m: np.ndarray, device):
    from rmcl_tpu_torch.math.se3 import Transform

    return Transform.from_matrix(torch.from_numpy(m).float().to(device))


def _matrix(t) -> torch.Tensor:
    """A program Transform as a float32 4 x 4 on the host."""
    return se3.from_quat(t.rot.detach().float().cpu(), t.trans.detach().float().cpu())


def node_params(cfg: dict, traffic: dict) -> dict:
    params = {k: v for k, v in cfg["node"].items()}
    for k, v in traffic.get("node", {}).items():
        params[k] = v
    return params


@dataclasses.dataclass
class Prepared:
    cfg: dict
    traffic: dict
    device: torch.device
    vertices: np.ndarray
    faces: np.ndarray
    dirs: np.ndarray
    true_ranges: np.ndarray
    true_hits: np.ndarray
    mesh_map: object


def prepare(cfg, traffic, device, spans) -> Prepared:
    """The map (the program's structures) and the loop's true scans."""
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import TriangleMesh

    v, f = world.make_map(cfg["map"])
    with spans("setup.map_build"):
        mesh = TriangleMesh(v, f, "building")
        b = cfg["map"]["bins"]
        mesh_map = MeshMap(mesh=mesh, bvh=build_bvh(mesh, device=device),
                           bins=build_bins(mesh, bin_size=b["bin_size"],
                                           bins_per_super=b["bins_per_super"],
                                           supers_per_hyper=b["supers_per_hyper"],
                                           device=device), name="building")
        if device.type == "cuda":
            torch.cuda.synchronize()
    dirs = world.spherical_dirs(cfg["sensor"])
    tri = world.triangles(v, f, device)
    ranges, hits = tr.true_scans(cfg, traffic, tri, torch.from_numpy(dirs).to(device))
    return Prepared(cfg, traffic, device, v, f, dirs, ranges, hits, mesh_map)


@dataclasses.dataclass
class Record:
    slot: int
    tom: object
    tbo: object
    progress: object
    tom_after: object
    stats: object


@dataclasses.dataclass
class Outcome:
    unit_seconds: List[float]
    window_s: float
    records: List[Record]
    run: tr.Run
    trace_units: int


def _info(p: Prepared):
    from rmcl_tpu_torch.io import msgs

    s = p.cfg["sensor"]
    return msgs.ScanInfo(phi_n=s["height"], theta_n=s["width"], phi_min=s["phi_min"],
                         phi_inc=(s["phi_max"] - s["phi_min"]) / (s["height"] - 1),
                         theta_min=s["theta_min"],
                         theta_inc=(s["theta_max"] - s["theta_min"]) / s["width"],
                         range_min=s["range_min"], range_max=s["range_max"])


def _message(info, run: tr.Run, k: int):
    """Slot k's odometry, stamp and scan message."""
    from rmcl_tpu_torch.io import msgs

    r, m = run.scan(k)
    return (_pose(run.tbo(k), "cpu"), run.stamp(k),
            msgs.ScanStamped(msgs.Header(run.stamp(k)), info, msgs.RangeData(r, m)))


def run(p: Prepared, seed: int, seconds: float, spans, traced) -> Outcome:
    """Warm up on the start, then the window. ``traced(seconds)`` is a
    context manager that profiles the first part of the window.

    Correction n of the window runs on slot ``n // corrections_per_scan``:
    the traffic fixes the work, so a slower run (a traced one) makes the
    same corrections on the same scans. Slot n's message is made after the
    correction that ingests slot n - 1, outside any correction's time."""
    from rmcl_tpu_torch.config.tree import ParamTree
    from rmcl_tpu_torch.micp.node import MICPLocalization

    t = p.traffic
    run_ = tr.make(p.cfg, t, seed, p.true_ranges, p.true_hits)
    per_scan = int(t["corrections_per_scan"])
    info = _info(p)
    with spans("setup.messages"):
        msg0 = _message(info, run_, 0)
    name = t["sensor_name"]
    with spans("setup.node"):
        node = MICPLocalization(p.mesh_map, ParamTree(node_params(p.cfg, t)))
    start = _pose(run_.start, p.device)
    with spans("setup.warmup"):
        node.on_odometry(*msg0[:2])
        node.on_scan(name, msg0[2])
        node.set_pose(start)
        for _ in range(int(t["warmup_corrections"])):
            node.step()
            node.pose_base_map().trans.cpu()
        node.set_pose(start)
    records, lat = [], []
    trace_units, n, nxt = 0, 0, msg0
    trace_s = float(t.get("trace_seconds", 0.0)) or seconds
    with traced(min(trace_s, seconds)) as in_trace:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            c0 = time.perf_counter()
            if c0 >= deadline:
                break
            slot, nth = divmod(n, per_scan)
            fresh = nth == 0
            if fresh:
                tbo, stamp, msg = nxt
                with spans("bench.ingest"):
                    node.on_odometry(tbo, stamp)
                    node.on_scan(name, msg)
            before = (node.tom, node.tbo, node.convergence_progress)
            with spans("bench.step"):
                stats = node.step()
            with spans("bench.readback"):
                pose = node.pose_base_map()
                pose.trans.cpu(), pose.rot.cpu()
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            records.append(Record(slot, *before, node.tom, stats))
            trace_units += in_trace()
            if fresh:
                nxt = _message(info, run_, slot + 1)
            n += 1
        window = time.perf_counter() - t0
    return Outcome(lat, window, records, run_, trace_units)


def settings(p: Prepared) -> ref.Settings:
    node = node_params(p.cfg, p.traffic)
    sensor = node["sensors"][p.traffic["sensor_name"]]
    corr = sensor["correspondences"]
    return ref.Settings(corr_type=corr["type"], max_dist=corr["max_dist"],
                        adaptive_max_dist_min=corr["adaptive_max_dist_min"],
                        adaptive=node["adaptive_max_dist"],
                        iterations=node["optimization_iterations"],
                        range_min=float(np.float32(p.cfg["sensor"]["range_min"])),
                        range_max=float(np.float32(p.cfg["sensor"]["range_max"])))


def sample(outcome: Outcome, seed: int, n: int) -> List[int]:
    """``n`` of the window's corrections, drawn from the seed uniformly
    among all of them."""
    k = len(outcome.records)
    rng = np.random.default_rng([seed, 1])
    return sorted(int(i) for i in rng.choice(k, size=min(n, k), replace=False))


def gaps(p: Prepared, outcome: Outcome, indices: List[int], control=None) -> np.ndarray:
    """(len(indices), 3): each correction's gaps between the program's
    corrected base pose and valid matches and the reference's, from the
    node's state before it: translation (m), rotation (rad) and the valid
    matches' relative gap. ``control``: a precision (``se3.TF32``) in which
    the reference stands in for the program."""
    s = settings(p)
    tri = world.triangles(p.vertices, p.faces, p.device)
    dirs = torch.from_numpy(p.dirs).to(p.device)
    out = []
    for i in indices:
        r = outcome.records[i]
        ranges, mask = outcome.run.scan(r.slot)
        tom, tbo = _matrix(r.tom).to(p.device), _matrix(r.tbo).to(p.device)
        args = (tri, dirs, torch.from_numpy(ranges).to(p.device),
                torch.from_numpy(mask).to(p.device), tom, tbo, float(r.progress), s)
        tom_ref, n_ref, _ = ref.correct(*args)
        if control is None:
            tom_got = _matrix(r.tom_after).to(p.device)
            n_got = float(r.stats.valid_matches)
        else:
            tom_got, n_got, _ = ref.correct(*args, prec=control)
        a, b = tom_ref @ tbo, tom_got @ tbo
        out.append((float(torch.linalg.norm((a[:3, 3] - b[:3, 3]).double())),
                    float(se3.rotation_angle(a[:3, :3], b[:3, :3])),
                    abs(n_got - n_ref) / max(n_ref, 1.0)))
    return np.asarray(out, dtype=np.float64).reshape(-1, 3)


def readings(p: Prepared, outcome: Outcome, seed: int, control=None):
    """Of each gap (:func:`gaps`) over the corrections drawn from the whole
    window (:func:`sample`), the widest but ``check.allow``: a ray that
    grazes an edge hits another face in either caster, and the one
    correction in some hundreds that keeps it moves by up to 1e-4 m and
    5e-5 rad."""
    check = p.traffic["check"]
    g = gaps(p, outcome, sample(outcome, seed, int(check["corrections"])), control)
    widest = -np.sort(-g, axis=0)[min(int(check["allow"]), len(g) - 1)]
    return {"pose_gap_m": float(widest[0]), "rot_gap_rad": float(widest[1]),
            "match_gap": float(widest[2])}


def release(p: Prepared) -> None:
    """Drop the program's map before the reference runs."""
    p.mesh_map = None
