"""One MICP-L correction, written out plainly: correspondences by the plain
caster (RC) or the plain closest point (CP), then point-to-plane
Gauss-Newton iterations about the correspondences' centroid with the
annealed gate, the damped solve, the corrected pose, the final statistics
and the convergence progress (uos/rmcl micp_localization.cpp:856-1016, as
the configuration's node states it)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import cast as rc
from benchmark.reference import se3
from benchmark.reference.se3 import FLOAT32, Precision


@dataclasses.dataclass(frozen=True)
class Settings:
    corr_type: str
    max_dist: float
    adaptive_max_dist_min: float
    adaptive: bool
    iterations: int
    range_min: float
    range_max: float
    damping: float = 1e-6


def correspondences(tri, dirs_s, points_s, mask, tsm, s: Settings, prec: Precision):
    """(model points, normals, found) in the sensor frame."""
    if s.corr_type == "RC":
        origin = tsm[:3, 3]
        d_m = se3.rotate(tsm, dirs_s, prec)
        d_m = d_m / torch.linalg.norm(d_m, dim=-1, keepdim=True)
        t, face = rc.cast(tri, origin[None], d_m[None], s.range_min,
                          torch.full((1, d_m.shape[0]), s.range_max, device=d_m.device),
                          prec=prec)
        t, face = t[0], face[0]
        found = face >= 0
        p_m = origin + d_m * torch.where(found, t, 0.0)[:, None]
        n_m = rc.face_normals(tri, face).float()
    else:
        q = se3.apply(tsm, points_s, prec)
        p_m, face, _ = rc.closest(tri, q, s.max_dist, prec=prec)
        found = mask & (face >= 0)
        n_m = rc.face_normals(tri, face).float()
        n_m = torch.where((torch.sum(n_m * (q - p_m), -1) < 0)[:, None], -n_m, n_m)
    inv = se3.inverse(tsm)
    p_s = torch.where(found[:, None], se3.apply(inv, p_m, prec), 0.0)
    n_s = torch.where(found[:, None], se3.rotate(inv, n_m, prec), 0.0)
    return p_s, n_s, found


def correct(tri, dirs_s, ranges, mask, tom, tbo, progress, s: Settings,
            prec: Precision = FLOAT32):
    """The corrected map <- odom transform (4, 4), the final valid matches
    and the new convergence progress, from the node's state before the
    correction (``tom``, ``tbo`` 4 x 4 float32, ``progress`` a number) and
    the scan (``ranges``, ``mask``) of sensor rays ``dirs_s``; the sensor
    sits at the base. Computed in ``prec`` (the 6 x 6 solve in float32)."""
    with rc.exact_matmul():
        points_s = dirs_s * ranges[:, None]
        tsm = prec.mm(tom, tbo).float()
        m_s, n_s, found = correspondences(tri, dirs_s, points_s, mask, tsm, s, prec)
        ok = mask & found
        d_o = se3.apply(tbo, points_s, prec).float()
        m_o = se3.apply(tbo, m_s, prec).float()
        n_o = se3.rotate(tbo, n_s, prec).float()
        p = float(progress)
        gate = s.max_dist * (1.0 - p) + s.adaptive_max_dist_min * p if s.adaptive else s.max_dist
        w = ok.float()
        centroid = torch.sum(d_o * w[:, None], 0) / torch.clamp(torch.sum(w), min=1.0)
        T = torch.eye(4, dtype=torch.float32, device=d_o.device)
        for _ in range(s.iterations):
            d = prec.mm(d_o, T[:3, :3].T).float() + T[:3, 3]
            r = torch.sum(n_o * (d - m_o), -1)
            g = (ok & (torch.abs(r) <= gate)).float()
            J = torch.cat([n_o, torch.linalg.cross(d - centroid, n_o)], -1) * g[:, None]
            A = torch.sum(J[:, :, None] * J[:, None, :], 0).float()
            b = -torch.sum(J * (r * g)[:, None], 0).float()
            A = A + s.damping * torch.eye(6, device=A.device) * torch.clamp(torch.trace(A), min=1.0)
            delta = torch.linalg.solve(A, b)
            R = se3.exp_so3(delta[3:], prec)
            c = centroid.float()
            step = se3.matrix(R, c + delta[:3] - prec.mm(R, c[:, None])[:, 0].float())
            T = prec.mm(step, T.float()).float()
        d = prec.mm(d_o, T[:3, :3].T).float() + T[:3, 3]
        signed = torch.sum(n_o * (d - m_o), -1)
        n_meas = torch.sum((ok & (torch.abs(signed) <= gate)).float())
        T = T.float()
        tom_new = prec.mm(tom, T).float()
        if not bool(torch.isfinite(tom_new).all()):
            tom_new = tom
        valid = torch.sum(mask.float())
        qw2 = (1.0 + torch.diagonal(T[:3, :3]).sum()) / 4.0
        prog = (torch.exp(-10.0 * torch.linalg.norm(T[:3, 3])) * qw2
                * torch.clamp(n_meas / torch.clamp(valid, min=1.0), max=1.0))
    return tom_new, float(n_meas), float(prog)
