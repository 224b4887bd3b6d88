"""Plain ray casting and closest points against every triangle.

No acceleration structure: a ray is held against every face's bounding
sphere and takes Moller-Trumbore with each face whose sphere it passes; a
query is held against every face that a uniform grid of cells cannot rule
out. Triangles are two-sided. Every function takes the precision it computes
in (``benchmark.reference.se3.Precision``): float32 is the reference, a
lower one the control.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.se3 import FLOAT32, Precision

NO_HIT = 3.0e38
_EPS = 1e-7


@contextlib.contextmanager
def exact_matmul():
    """Full float32 matrix products (no TF32) for the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mt(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore on matching rows: t where the ray hits the
    two-sided triangle with t_min < t <= t_max, else inf."""
    p = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * p, -1)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    s = o - v0
    u = torch.sum(s * p, -1) * inv
    q = torch.linalg.cross(s, e1)
    v = torch.sum(d * q, -1) * inv
    t = (torch.sum(e2 * q, -1) * inv).float()
    good = ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > t_min) & (t <= t_max)
    return torch.where(good, t, float("inf"))


def cast(tri: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor, t_min, t_max,
         prec: Precision = FLOAT32, cells_per_chunk: int = 1 << 28):
    """Closest hits of rays grouped by origin.

    ``tri`` (F, 3, 3); ``origins`` (P, 3); ``dirs`` (P, R, 3) unit;
    ``t_min`` a number; ``t_max`` (P, R). A hit has t_min < t <= t_max.
    Every (ray, face) pair is first held against the face's bounding sphere
    seen from the ray's origin (a cone that a ray through the face cannot
    miss, in float64 with room to spare); the pairs that pass take the exact
    test in ``prec``. Returns t (P, R) (NO_HIT where missed) and the face
    index (P, R) (-1 where missed), in float32 and int64."""
    dev = tri.device
    P, R, _ = dirs.shape
    F = tri.shape[0]
    center = 0.5 * (tri.amin(1) + tri.amax(1)).double()
    radius = torch.linalg.norm(tri.double() - center[:, None], dim=-1).amax(1) * (1 + 1e-6) + 1e-6
    best_t = torch.full((P * R,), float("inf"), device=dev)
    best_f = torch.full((P * R,), -1, dtype=torch.int64, device=dev)
    t_hi = t_max.reshape(-1).float()
    d64 = dirs.double()
    chunk = max(1, min(F, cells_per_chunk // max(P * R, 1)))
    tri_d = tri.float()
    for f0 in range(0, F, chunk):
        rel = center[None, f0:f0 + chunk] - origins.double()[:, None]  # (P, Fc, 3)
        dist = torch.linalg.norm(rel, dim=-1)
        rad = radius[None, f0:f0 + chunk]
        inside = dist <= rad
        sin_thr = rad / torch.where(inside, rad, dist)
        cos_thr = torch.sqrt(torch.clamp(1.0 - sin_thr ** 2, min=0.0))
        # d . rel >= |rel| cos(theta) - slack, theta the sphere's half-angle
        thr = torch.where(inside, -torch.inf, dist * cos_thr - 1e-6 * dist - 1e-6)
        near = (dist - rad <= t_hi.view(P, R).amax(1, keepdim=True).double())
        thr = torch.where(near, thr, torch.inf)
        hit = torch.bmm(d64, rel.transpose(1, 2)) >= thr[:, None, :]  # (P, R, Fc)
        pi, ri, fi = torch.nonzero(hit, as_tuple=True)
        del hit
        if pi.numel() == 0:
            continue
        ray = pi * R + ri
        face = fi + f0
        tr = tri_d[face]
        o = origins[pi].float()
        d = dirs[pi, ri].float()
        t = _mt(o, d, tr[:, 0], tr[:, 1] - tr[:, 0], tr[:, 2] - tr[:, 0], t_min, t_hi[ray])
        m = torch.full((P * R,), float("inf"), device=dev).scatter_reduce(0, ray, t, "amin")
        win = torch.isfinite(t) & (t == m[ray])
        big = torch.iinfo(torch.int64).max
        f_win = torch.full((P * R,), big, dtype=torch.int64, device=dev).scatter_reduce(
            0, ray, torch.where(win, face, big), "amin")
        better = m < best_t
        best_t = torch.where(better, m, best_t)
        best_f = torch.where(better, f_win, best_f)
    hit = torch.isfinite(best_t)
    return (torch.where(hit, best_t, NO_HIT).view(P, R),
            torch.where(hit, best_f, -1).view(P, R))


def face_normals(tri: torch.Tensor, faces: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    """Unit geometric normals (..., 3) of the faces ``faces`` (any shape,
    -1 gives a zero vector)."""
    t = tri[faces.clamp(min=0)].float()
    n = torch.linalg.cross(t[..., 1, :] - t[..., 0, :], t[..., 2, :] - t[..., 0, :])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-30)
    return torch.where((faces >= 0)[..., None], n, torch.zeros_like(n))


def closest_on_triangles(p, a, b, c):
    """Closest point to ``p`` on each triangle (a, b, c) (all (..., 3)), by
    Ericson's Voronoi-region test (Real-Time Collision Detection, 5.1.5)."""
    def dot(x, y):
        return torch.sum(x * y, -1, keepdim=True)

    def div(x, y):
        return x / torch.where(y == 0, torch.ones_like(y), y)

    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - b
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - c
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    den = va + vb + vc
    out = a + ab * div(vb, den) + ac * div(vc, den)  # inside the face
    bc_w = div(d4 - d3, (d4 - d3) + (d5 - d6))
    out = torch.where((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + (c - b) * bc_w, out)
    out = torch.where((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * div(d2, d2 - d6), out)
    out = torch.where((d6 >= 0) & (d5 <= d6), c, out)
    out = torch.where((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * div(d1, d1 - d3), out)
    out = torch.where((d3 >= 0) & (d4 <= d3), b, out)
    out = torch.where((d1 <= 0) & (d2 <= 0), a, out)
    return out


def closest(tri: torch.Tensor, queries: torch.Tensor, max_dist: float, prec: Precision = FLOAT32,
            cell: float = 1.0, pairs_per_chunk: int = 1 << 24):
    """Nearest surface point within ``max_dist`` of each query (Q, 3).

    A face is a candidate for the queries of every grid cell that its box,
    grown by ``max_dist``, overlaps; that never leaves out a face within
    ``max_dist``. Returns (point (Q, 3), face (Q,) -1 where none lies within
    ``max_dist``, distance (Q,)); ties go to the lower face index."""
    dev = tri.device
    Q = queries.shape[0]
    lo = tri.amin(1) - max_dist
    hi = tri.amax(1) + max_dist
    origin = torch.minimum(lo.amin(0), queries.amin(0)) - cell
    c_lo = torch.floor((lo - origin) / cell).long()
    c_hi = torch.floor((hi - origin) / cell).long()
    dims = torch.maximum(c_hi.amax(0), torch.floor((queries - origin) / cell).long().amax(0)) + 1
    span = c_hi - c_lo + 1  # (F, 3)
    per_face = span.prod(-1)
    face_of = torch.repeat_interleave(torch.arange(tri.shape[0], device=dev), per_face)
    k = torch.arange(face_of.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(per_face, 0) - per_face, per_face)
    sp = span[face_of]
    ix = c_lo[face_of, 0] + k % sp[:, 0]
    iy = c_lo[face_of, 1] + (k // sp[:, 0]) % sp[:, 1]
    iz = c_lo[face_of, 2] + k // (sp[:, 0] * sp[:, 1])
    key = (ix * dims[1] + iy) * dims[2] + iz
    key, order = torch.sort(key)
    face_of = face_of[order]
    qc = torch.floor((queries - origin) / cell).long()
    qkey = (qc[:, 0] * dims[1] + qc[:, 1]) * dims[2] + qc[:, 2]
    start = torch.searchsorted(key, qkey)
    count = torch.searchsorted(key, qkey, right=True) - start

    best_d2 = torch.full((Q,), float("inf"), device=dev)
    best_f = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    best_p = torch.zeros((Q, 3), device=dev)
    cum = torch.cumsum(count, 0)
    q0 = 0
    while q0 < Q:
        base = int(cum[q0 - 1]) if q0 else 0
        q1 = int(torch.searchsorted(cum, torch.tensor(base + pairs_per_chunk, device=dev),
                                    right=True))
        q1 = min(max(q1, q0 + 1), Q)
        cnt = count[q0:q1]
        qi = torch.repeat_interleave(torch.arange(q0, q1, device=dev), cnt)
        off = torch.arange(qi.shape[0], device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        fi = face_of[start[qi] + off]
        t = tri[fi].float()
        p = queries[qi].float()
        cp = closest_on_triangles(p, t[:, 0], t[:, 1], t[:, 2])
        d2 = torch.sum((cp - p) ** 2, -1).float()
        d2 = torch.where(d2 <= max_dist * max_dist, d2, float("inf"))
        m = torch.full((q1 - q0,), float("inf"), device=dev).scatter_reduce(
            0, qi - q0, d2, "amin")
        win = torch.isfinite(d2) & (d2 == m[qi - q0])
        big = torch.iinfo(torch.int64).max
        f_win = torch.full((q1 - q0,), big, dtype=torch.int64, device=dev).scatter_reduce(
            0, qi - q0, torch.where(win, fi, big), "amin")
        sel = win & (fi == f_win[qi - q0])
        best_d2[q0:q1] = m
        best_f[q0:q1] = torch.where(torch.isfinite(m), f_win, -1)
        best_p[qi[sel]] = cp[sel].float()
        q0 = q1
    found = best_f >= 0
    return torch.where(found[:, None], best_p, 0.0), best_f, torch.sqrt(best_d2)
