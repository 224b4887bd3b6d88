"""Drive the MCL node (``mcl/node.py::MCLNode``) over a ``scan_loop``
traffic and judge its stages against the plain reference.

Closed loop: one cycle is ``motion_update`` (the odometry of the next
scan), ``sensor_update`` (that scan, taken at the truth), ``resample`` and
``estimate`` read to the host. The cloud starts around the truth with the
traffic's covariance; the warm-up cycles run on, so the window continues
the same track.

The check follows the program stage by stage from its own state: each
stage's reference starts from the cloud the program handed to that stage,
with the random draws the program's generator gave it, which the check
takes again from the generator's state saved before the stage (beams:
``multinomial`` over the valid points; the tournament: ``randint`` enemies,
then ``randn`` (n, 6) normals).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark import world
from benchmark.reference import mcl as ref
from benchmark.reference import se3
from benchmark.systems import micpl

UNIT = "cycle"
prepare = micpl.prepare
release = micpl.release


def _cfg(p):
    """(MCLConfig, sensor update settings dict) of the configuration."""
    from rmcl_tpu_torch.mcl.motion import MotionUpdateConfig
    from rmcl_tpu_torch.mcl.node import MCLConfig
    from rmcl_tpu_torch.mcl.resampling import ResamplerConfig
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig

    n = p.cfg["node"]
    s, m, r = n["sensor_update"], n["motion_update"], n["resampling"]
    return MCLConfig(
        n_particles=int(p.traffic["particles"]), resampler=n["resampler"],
        motion=MotionUpdateConfig.create(m["forget_rate"], m["forget_rate_per_second"], False),
        sensor=SensorUpdateConfig.create(**s),
        resampling=ResamplerConfig.create(r["min_noise_t"], r["min_noise_r"],
                                          r["likelihood_forget_per_meter"],
                                          r["likelihood_forget_per_radian"]),
        max_induction_particles=int(n["max_induction_particles"]))


@dataclasses.dataclass
class Record:
    slot: int
    before: object
    moved: object
    sensor_state: torch.Tensor
    scored: object
    resample_state: torch.Tensor
    resampled: object
    did_resample: bool
    estimate: object
    sensor_cfg: object


@dataclasses.dataclass
class Outcome:
    unit_seconds: List[float]
    window_s: float
    records: List[Record]
    run: tr.Run
    trace_units: int


def _points(p, run_, k):
    r, m = run_.scan(k)
    return torch.from_numpy(p.dirs * r[:, None]), torch.from_numpy(m)


def run(p, seed: int, seconds: float, spans, traced) -> Outcome:
    from rmcl_tpu_torch.mcl.node import MCLNode

    t = p.traffic
    run_ = tr.make(p.cfg, t, seed, p.true_ranges, p.true_hits)
    # the node's own generator: from the traffic where it fixes it, so that
    # every seed's cloud moves by the same draws; else from the run's seed
    cfg = dataclasses.replace(_cfg(p), seed=int(t.get("node_seed", seed)) % (1 << 63))
    tsb = micpl._pose(np.eye(4), "cpu")
    with spans("setup.node"):
        node = MCLNode(p.mesh_map, cfg)
        node.warm()
        cov = torch.diag(torch.tensor(t["initial_covariance"], dtype=torch.float32))
        node.initial_pose_guess(micpl._pose(run_.truth(0), p.device), cov)
    scans = {}

    def cycle(k, capture=None):
        pts, mask = scans.pop(k) if k in scans else _points(p, run_, k)
        before = node.cloud
        node.motion_update(micpl._pose(run_.tbo(k), "cpu"), run_.stamp(k))
        moved = node.cloud
        s_state = node.generator.get_state() if capture is not None else None
        with spans("bench.sensor_update"):
            node.sensor_update(pts, mask, tsb)
        scored = node.cloud
        r_state = node.generator.get_state() if capture is not None else None
        with spans("bench.resample"):
            did = node.resample()
        with spans("bench.estimate"):
            est = node.estimate()
            est.pose.trans.cpu(), est.pose.rot.cpu()
        if capture is not None:
            capture.append(Record(k, before, moved, s_state, scored, r_state, node.cloud, did,
                                  est, node.effective_sensor_config()))

    warm = int(t["warmup_cycles"])
    with spans("setup.warmup"):
        for k in range(warm + 1):
            cycle(k)
    check = t["check"]
    rng = np.random.default_rng([seed, 2])
    chosen = set(int(i) for i in rng.choice(int(check["sample_before"]),
                                            size=int(check["cycles"]), replace=False))
    records, last, lat = [], [], []
    trace_units = 0
    k = warm + 1
    scans[k] = _points(p, run_, k)
    trace_s = float(t.get("trace_seconds", 0.0)) or seconds
    with traced(min(trace_s, seconds)) as in_trace:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while time.perf_counter() < deadline:
            c0 = time.perf_counter()
            last = []
            cycle(k, records if n in chosen else last)
            lat.append(time.perf_counter() - c0)
            trace_units += in_trace()
            k += 1
            n += 1
            scans[k] = _points(p, run_, k)
        window = time.perf_counter() - t0
    if last and (not records or records[-1].slot != last[0].slot):
        records.append(last[0])
    return Outcome(lat, window, records, run_, trace_units)


def _poses(cloud, idx) -> torch.Tensor:
    return se3.from_quat(cloud.poses.rot[idx].float(), cloud.poses.trans[idx].float())


def _rel(a, b) -> torch.Tensor:
    return torch.abs(a - b) / torch.clamp(torch.abs(b), min=1e-30)


def _pose_gap(a, b) -> torch.Tensor:
    """Translation gap (m) plus rotation gap (rad) of two pose stacks."""
    return (torch.linalg.norm((a[..., :3, 3] - b[..., :3, 3]).double(), dim=-1)
            + se3.rotation_angle(a[..., :3, :3], b[..., :3, :3]))


def readings(p, outcome: Outcome, seed: int, control=None):
    """Each stage of the sampled cycles against the reference, from the
    program's state before it: the widest motion gap, the 75th percentile
    of the relative likelihood gaps (a few beams that hit another face at an
    edge move a particle's likelihood by a percent), the widest resampling
    gap and the estimate's gap."""
    dev = p.device
    n = p.cfg["node"]
    scfg = dict(n["sensor_update"])
    tri = world.triangles(p.vertices, p.faces, dev)
    check = p.traffic["check"]
    rng = np.random.default_rng([seed, 3])
    out = {"motion_gap": 0.0, "likelihood_gap_p75": 0.0, "resample_gap": 0.0,
           "estimate_gap": 0.0}
    for rec in outcome.records:
        N = rec.before.capacity
        idx = torch.from_numpy(rng.choice(N, size=min(N, int(check["particles"])),
                                          replace=False)).to(dev)
        # motion
        run_ = outcome.run
        delta = torch.from_numpy(np.linalg.inv(run_.tbo(rec.slot - 1)) @ run_.tbo(rec.slot))
        dts = run_.stamp(rec.slot) - run_.stamp(rec.slot - 1)
        m = n["motion_update"]
        want_p, want_n = ref.motion(_poses(rec.before, idx), rec.before.likelihood.n_meas[idx],
                                    delta.float().to(dev), dts, m["forget_rate"],
                                    m["forget_rate_per_second"])
        if control is None:
            got_p, got_n = _poses(rec.moved, idx), rec.moved.likelihood.n_meas[idx].float()
        else:
            got_p, got_n = ref.motion(_poses(rec.before, idx), rec.before.likelihood.n_meas[idx],
                                      delta.float().to(dev), dts, m["forget_rate"],
                                      m["forget_rate_per_second"], prec=control)
        out["motion_gap"] = max(out["motion_gap"], float(_pose_gap(got_p, want_p).max()),
                                float(_rel(got_n, want_n).max()))
        # sensor update: the beams the program drew
        pts, mask = _points(p, run_, rec.slot)
        pts, mask = pts.to(dev), mask.to(dev)
        g = torch.Generator(device=dev)
        g.set_state(rec.sensor_state)
        w = mask.float()
        w = torch.where(torch.sum(w) > 0, w, torch.ones_like(w))
        bi = torch.multinomial(w, int(scfg["samples"]), replacement=True, generator=g)
        bp = pts[bi]
        rng_b = torch.sqrt(torch.sum(bp * bp, -1))
        dirs = bp / torch.clamp(rng_b, min=1e-12)[:, None]
        lik = rec.moved.likelihood
        prior = (lik.mean[idx], lik.sigma[idx], lik.n_meas[idx])
        poses = _poses(rec.moved, idx)
        want = ref.likelihood(tri, poses, dirs, rng_b, mask[bi], prior, scfg)[0]
        got = (rec.scored.likelihood.mean[idx].float() if control is None else
               ref.likelihood(tri, poses, dirs, rng_b, mask[bi], prior, scfg, prec=control)[0])
        rel = _rel(got, want)
        out["likelihood_gap_p75"] = max(out["likelihood_gap_p75"],
                                        float(torch.quantile(rel.double(), 0.75)))
        # resampling: the enemies and normals the program drew
        if rec.did_resample:
            g.set_state(rec.resample_state)
            cloud = rec.scored
            enemy = torch.randint(0, N, (N,), generator=g, device=dev)
            normals = torch.randn((N, 6), generator=g, device=dev)
            r = n["resampling"]
            noise6 = torch.tensor(list(r["min_noise_t"]) + list(r["min_noise_r"]), device=dev)
            _, src = ref.duel(idx, cloud.likelihood.mean, cloud.alive, enemy)
            args = (idx, cloud.likelihood.mean, cloud.alive, enemy, normals, _poses(cloud, src),
                    cloud.likelihood.n_meas[src].float(), noise6,
                    r["likelihood_forget_per_meter"], r["likelihood_forget_per_radian"])
            want_p, want_n = ref.gladiator(*args)
            if control is None:
                got_p = _poses(rec.resampled, idx)
                got_n = rec.resampled.likelihood.n_meas[idx].float()
                mean_gap = _rel(rec.resampled.likelihood.mean[idx], cloud.likelihood.mean[src])
            else:
                got_p, got_n = ref.gladiator(*args, prec=control)
                mean_gap = torch.zeros(1, device=dev)
            out["resample_gap"] = max(out["resample_gap"], float(_pose_gap(got_p, want_p).max()),
                                      float(_rel(got_n, want_n).max()), float(mean_gap.max()))
        # the estimate of the program's resampled cloud
        c = rec.resampled
        k = min(int(n["max_induction_particles"]), c.capacity)
        args = (c.poses.rot[:k], c.poses.trans[:k], c.likelihood.mean[:k], c.alive[:k])
        want = ref.estimate(*args)
        got = (se3.from_quat(rec.estimate.pose.rot.float(), rec.estimate.pose.trans.float())
               if control is None else ref.estimate(*args, prec=control))
        out["estimate_gap"] = max(out["estimate_gap"], float(_pose_gap(got, want)))
    return out


def guarantees(p, outcome: Outcome):
    """Ray blocks of the sampled cycles' binned casts that a cull budget
    truncated: the configuration promises every beam against the whole
    map, and a truncated block's likelihoods can drop geometry. Read by the
    program's own audit (``block_cull_stats``) on the rays that each cycle
    cast, rebuilt from the cloud and the beams the program drew."""
    from rmcl_tpu_torch.mcl.sensor_update import probe_update_rays
    from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats

    dev = p.device
    tsb = micpl._pose(np.eye(4), dev)
    truncated = 0
    for rec in outcome.records:
        c = rec.sensor_cfg
        if c.engine != "binned":
            continue
        pts, mask = _points(p, outcome.run, rec.slot)
        g = torch.Generator(device=dev)
        g.set_state(rec.sensor_state)
        o, d, t_cap = probe_update_rays(rec.moved, g, pts.to(dev), mask.to(dev), tsb, c)
        _, sat = block_cull_stats(p.mesh_map.bins, o, d, t_max=t_cap, block_size=c.block_size,
                                  c_super=c.c_super, c_bin=c.c_bin, sub_blocks=c.sub_blocks,
                                  c_mid=c.c_mid, c_hyper=c.c_hyper)
        truncated += int(sat.sum())
        del o, d, t_cap, sat
    return {"truncated_blocks": truncated}
