"""The MCL cycle's stages, written out plainly for a sample of particles:
the motion update (pose times the odometry delta, the forget factor), the
range-likelihood sensor update (the plain caster, the RC error with its
hit/miss penalties, the batch Gaussian folded into the prior with the
confidence cap), the tournament resampling (duel, Euler-angle noise,
confidence forgetting) and the weighted estimate (mean translation,
Markley mean rotation). uos/rmcl rmcl_localization.cpp and the
configuration's node state the semantics; poses are 4 x 4 matrices."""

from __future__ import annotations

import math

import torch

from benchmark.reference import cast as rc
from benchmark.reference import se3
from benchmark.reference.se3 import FLOAT32, Precision

MAX_N_MEAS = 10_000.0


def motion(poses: torch.Tensor, n_meas: torch.Tensor, delta: torch.Tensor, dt: float,
           rate: float, rate_s: float, prec: Precision = FLOAT32):
    """Poses (K, 4, 4) moved by ``delta`` (4, 4) and their confidences
    forgotten: (poses, n_meas)."""
    with rc.exact_matmul():
        new = prec.mm(poses, delta)
        dist = torch.linalg.norm(delta[:3, 3].float())
        forget = (1.0 - (1.0 - rate) ** dist) * (1.0 - (1.0 - rate_s) ** max(dt, 0.0))
        return new.float(), (n_meas.float() * (1.0 - forget)).float()


def errors(tri, poses, beams_s, ranges, valid, cfg: dict, prec: Precision = FLOAT32):
    """The RC range errors (K, S) of particles at ``poses`` (K, 4, 4) (the
    sensor at the base) for the sampled beams: unit directions (S, 3),
    ``ranges`` (S,) and ``valid`` (S,)."""
    S = beams_s.shape[0]
    with rc.exact_matmul():
        real = (ranges >= cfg["range_min"]) & (ranges <= cfg["range_max"]) & valid
        t_max = torch.where(real, ranges + cfg["range_cap_sigmas"] * cfg["dist_sigma"], rc.NO_HIT)
        o = poses[:, :3, 3]
        d = prec.mm(beams_s[None], poses[:, :3, :3].transpose(1, 2)).float()  # (K, S, 3)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t, face = rc.cast(tri, o, d, 0.0, t_max[None].expand(poses.shape[0], S), prec=prec)
        sim = (face >= 0) & (t > cfg["range_min"])
        n = rc.face_normals(tri, face, prec)
        hit_p = (o[:, None, :] + d * torch.where(sim, t, 0.0)[..., None]).float()
        real_p = (o[:, None, :] + d * ranges[None, :, None]).float()
        signed = torch.sum(n * (hit_p - real_p), -1)
        return torch.where(sim, torch.where(real[None], torch.abs(signed),
                                             cfg["real_miss_sim_hit_error"]),
                           torch.where(real[None], cfg["real_hit_sim_miss_error"],
                                       cfg["real_miss_sim_miss_error"])).float()


def likelihood(tri, poses, beams_s, ranges, valid, prior, cfg: dict, prec: Precision = FLOAT32):
    """New likelihood (mean, sigma, n_meas) (K,) of particles at ``poses``
    from the sampled beams' :func:`errors`, each evaluated under
    N(0, dist_sigma) and folded as one batch into ``prior`` (mean, sigma,
    n_meas) with the confidence cap."""
    S = beams_s.shape[0]
    sigma = cfg["dist_sigma"]
    err = errors(tri, poses, beams_s, ranges, valid, cfg, prec)
    ev = torch.exp(-0.5 * (err / sigma) ** 2) / (sigma * math.sqrt(2.0 * math.pi))
    e_mean = torch.sum(ev, -1) / S
    e_var = torch.sum((ev - e_mean[:, None]) ** 2, -1) / S
    m0, s0, n0 = (x.float() for x in prior)
    n = n0 + S
    mean = (n0 * m0 + S * e_mean) / n
    var = (n0 * (s0 + (m0 - mean) ** 2) + S * (e_var + (e_mean - mean) ** 2)) / n
    return mean.float(), var.float(), torch.clamp(n, max=MAX_N_MEAS).float()


def gladiator(slots, mean, alive, enemy, normals, poses_src, n_meas_src, noise6,
              f_meter: float, f_radian: float, prec: Precision = FLOAT32):
    """Resampled poses (K, 4, 4) and confidences of the slots ``slots``:
    each duels ``enemy[slot]`` and, losing, copies it with Euler-angle noise
    ``normals * noise6`` and forgets. ``poses_src``/``n_meas_src`` are the
    (K,) sources' poses and confidences, gathered by the caller from the
    sources this function returns first: call :func:`duel` for them."""
    lose, _ = duel(slots, mean, alive, enemy)
    eps = normals[slots].float() * noise6.float()
    r0 = poses_src[:, :3, :3].float()
    roll, pitch, yaw = se3.to_euler(r0)
    r1 = se3.euler(roll + eps[:, 3], pitch + eps[:, 4], yaw + eps[:, 5])
    t1 = poses_src[:, :3, 3].float() + eps[:, :3]
    d2 = torch.sum(eps[:, :3] ** 2, -1)
    rel = prec.mm(r0.transpose(1, 2), r1).float()  # r0^-1 r1
    cos = (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    sin = torch.linalg.norm(torch.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                                         rel[:, 1, 0] - rel[:, 0, 1]], -1), dim=-1) / 2.0
    rot_d = torch.sin(torch.atan2(sin, cos) / 2.0).float()
    forget = torch.maximum(1.0 - (1.0 - f_meter) ** d2, 1.0 - (1.0 - f_radian) ** rot_d)
    new = poses_src.clone()
    new[:, :3, :3] = torch.where(lose[:, None, None], r1.float(), poses_src[:, :3, :3])
    new[:, :3, 3] = torch.where(lose[:, None], t1.float(), poses_src[:, :3, 3])
    n_new = torch.where(lose, (n_meas_src.float() * (1.0 - forget)).float(), n_meas_src)
    return new, n_new


def duel(slots, mean, alive, enemy):
    """(lose (K,), source index (K,)) of the slots ``slots``."""
    score = torch.where(alive, mean, float("-inf"))
    e = enemy[slots]
    lose = score[e] > score[slots]
    return lose, torch.where(lose, e, slots)


def estimate(quats, trans, mean, alive, prec: Precision = FLOAT32):
    """Weighted mean pose (4, 4) of particles with quaternions (N, 4),
    translations (N, 3), weighted by their likelihood mean (dead: 0;
    all-zero weights: uniform); the rotation is the principal eigenvector
    of sum w q q^T."""
    w = torch.where(alive, mean, 0.0).float()
    total = torch.sum(w)
    w = w / total if float(total) > 0 else torch.full_like(w, 1.0 / w.shape[0])
    t = prec.mm(w[None], trans.float())[0]
    q = quats.float()
    M = prec.mm((q * w[:, None]).T, q)
    _, vecs = torch.linalg.eigh(M.double())
    return se3.from_quat(vecs[:, -1].float(), t.float())
