"""Exact BVH traversal (K5): the hand-written CUDA kernel and its plain
PyTorch version, and MCL's ray-cast scoring on the same walk.

``traverse_rays`` ports the XLA device loop of the JAX package's exact
engine, ``rmcl_tpu/ops/raycast.py::_traverse_batch`` (:73, loop :131-211),
and its round scheduler ``_traverse_rounds`` (:226), which is bitwise
neutral. The kernel source is ``rmcl_tpu_torch/csrc/traverse_bvh.cu``; its
header says what bounds it on the card and what the design does about it.
One thread walks a ray.

Contract: ``nodes (N, 16)`` float32 threaded slots (words 12-14 int32 bit
patterns), ``root_link ()`` int32; rays ``o, d (R, 3)``, ``t_min, t_max
(R,)`` float32. Returns ``t_best (R,)`` float32 (t_max where nothing was
hit) and ``slot (R,)`` int32 (the winning leaf's slot, or -1); with
``visits=True`` also ``(R, 2)`` int32 visits per ray (internal, leaf).

:func:`walk_score_rc` is MCL's ray-cast sensor update from the particles'
sensor poses to each particle's folded likelihood, on the card in two
launches: K5 with its scoring epilogue (one float a ray reaches device
memory) and a fold kernel. Its plain version,
:func:`walk_score_rc_reference`, is the composition the MCL sensor update
runs for the other engines (the cast, ``score_rc``, ``fold``'s sums),
op for op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.types import SENTINEL_LINK
from rmcl_tpu_torch.ops.bvh_walk import check_rows, check_slots

Tensor = torch.Tensor

_SENT = int(SENTINEL_LINK)
_EPS = 1e-7
_ONE_PLUS_EPS = 1.0 + _EPS


@functools.lru_cache(maxsize=None)
def _library():
    return _build.load_library("traverse_bvh")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_traverse_bvh``), built on first use."""
    fn = _library().rmcl_traverse_bvh
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _score_kernel():
    """The scored walk's and the fold's C entry point
    (``rmcl_walk_score_rc``), built on first use."""
    fn = _library().rmcl_walk_score_rc
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) of each kernel of the library as built, by
    ``cudaFuncGetAttributes``: ``{"K5": (regs, local), "K5 ScoreRC": ...,
    "fold": ...}`` (K5 is the cast's instantiation). Needs a card."""
    out = {}
    for name, entry in (("K5", "rmcl_traverse_bvh_attrs"),
                        ("K5 ScoreRC", "rmcl_walk_score_rc_attrs"),
                        ("fold", "rmcl_mcl_fold_attrs")):
        fn = getattr(_library(), entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        regs, local = ctypes.c_int(), ctypes.c_int()
        if fn(ctypes.byref(regs), ctypes.byref(local)):
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name}")
        out[name] = (regs.value, local.value)
    return out


def traverse_rays(nodes: Tensor, root_link: Tensor, o: Tensor, d: Tensor, t_min: Tensor,
                  t_max: Tensor, visits: bool = False):
    """Closest hit per ray over the threaded BVH.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`traverse_rays_reference`. ``traverse_rays.launches`` counts the
    kernel launches."""
    check_slots(nodes, root_link)
    R = o.shape[0]
    dev = nodes.device
    check_rows(dev, o=(o, torch.float32, (R, 3)), d=(d, torch.float32, (R, 3)),
               t_min=(t_min, torch.float32, (R,)), t_max=(t_max, torch.float32, (R,)))
    if dev.type == "cpu":
        return traverse_rays_reference(nodes, root_link, o, d, t_min, t_max, visits)
    if dev.type != "cuda":
        raise ValueError(f"traverse_rays runs on cuda or cpu tensors, not {dev}")
    t_best = torch.empty((R,), dtype=torch.float32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    counts = torch.empty((R, 2), dtype=torch.int32, device=dev) if visits else None
    with torch.cuda.device(dev):
        err = _kernel()(
            nodes.data_ptr(), root_link.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), t_best.data_ptr(), slot.data_ptr(),
            0 if counts is None else counts.data_ptr(), R, nodes.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"traverse_rays kernel launch failed: cudaError {err}")
    traverse_rays.launches += 1
    return (t_best, slot, counts) if visits else (t_best, slot)


traverse_rays.launches = 0


def _safe_inv(v: Tensor) -> Tensor:
    # a tiny negative component becomes +1e20, as in the JAX code
    return 1.0 / torch.where(torch.abs(v) > 1e-20, v, 1e-20)


def _leaf_t(w, ox, oy, oz, dx, dy, dz, tmin):
    """Moller-Trumbore (the Pallas-form test) on the inline triangles of
    float slot rows ``w``: (t, whether the hit passes every gate but the
    compare with the best), the kernel's arithmetic term for term."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (w[:, k] for k in range(9))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = det_ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= _ONE_PLUS_EPS) & (t > tmin)
    return t, ok


def _box_enter(w, ox, oy, oz, ix, iy, iz, tmin, tb):
    """The slab test of the boxes of float slot rows ``w``: descend?"""
    tx0 = (w[:, 0] - ox) * ix
    tx1 = (w[:, 3] - ox) * ix
    ty0 = (w[:, 1] - oy) * iy
    ty1 = (w[:, 4] - oy) * iy
    tz0 = (w[:, 2] - oz) * iz
    tz1 = (w[:, 5] - oz) * iz
    t_near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
    t_far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                          torch.maximum(tz0, tz1))
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tb)


def traverse_rays_reference(nodes: Tensor, root_link: Tensor, o: Tensor, d: Tensor,
                            t_min: Tensor, t_max: Tensor, visits: bool = False,
                            seen: Tensor | None = None):
    """The same function in plain PyTorch: one step per visit over the rays
    still walking, reading slot rows of ``nodes.view(torch.int32)`` (the
    link words never pass through float arithmetic), with the kernel's
    arithmetic term for term. Runs on any device. ``seen``, an optional
    (N,) bool tensor, gets the slots read marked (a bound counts them)."""
    R = o.shape[0]
    dev = o.device
    nodes_i = nodes.view(torch.int32)
    ix, iy, iz = (_safe_inv(d[:, k]) for k in range(3))
    t_best = t_max.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((R, 2), dtype=torch.int32, device=dev)
    cur = torch.where(t_max > t_min, root_link.expand(R), _SENT)
    alive = torch.nonzero(cur != _SENT).squeeze(1)
    for _ in range(nodes.shape[0]):
        if alive.numel() == 0:
            break
        c = cur[alive]
        leaf = c < 0
        idx = torch.where(leaf, ~c, c)
        rows = nodes_i[idx.long()]  # (A, 16) int32
        if seen is not None:
            seen[idx.long()] = True
        w = rows.view(torch.float32)
        ox, oy, oz = (o[alive, k] for k in range(3))
        dx, dy, dz = (d[alive, k] for k in range(3))
        tmin, tb = t_min[alive], t_best[alive]

        # leaf: the inline triangle, taken at the strict t < t_best
        t_tri, ok = _leaf_t(w, ox, oy, oz, dx, dy, dz, tmin)
        leaf_hit = leaf & ok & (t_tri < tb)
        t_best[alive] = torch.where(leaf_hit, t_tri, tb)
        best[alive] = torch.where(leaf_hit, idx, best[alive])

        # internal: the node's own AABB, slab test
        descend = ~leaf & _box_enter(w, ox, oy, oz, ix[alive], iy[alive], iz[alive], tmin, tb)
        nxt = torch.where(descend, rows[:, 12], rows[:, 13])
        cur[alive] = nxt
        counts[alive, 0] += (~leaf).to(torch.int32)
        counts[alive, 1] += leaf.to(torch.int32)
        alive = alive[nxt != _SENT]
    return (t_best, best, counts) if visits else (t_best, best)


# the beam table's columns (score_beams in mcl/sensor_update.py builds it)
BEAM_WORDS = 8  # dx, dy, dz, range, t_max, real hit (1/0), sampled index, 0


def _gaussian_terms(dist_sigma: float):
    """(1 / sigma, 0.3989422804014327 / sigma) as float32 rounds them in
    :func:`~rmcl_tpu_torch.math.stats.gaussian_pdf`."""
    inv_s = 1.0 / torch.clamp(torch.tensor(dist_sigma, dtype=torch.float32), min=1e-12)
    return float(inv_s), float(0.3989422804014327 * inv_s)


def walk_score_rc(nodes: Tensor, root_link: Tensor, tsm: Tensor, beams: Tensor, *,
                  range_min: float, hit_miss: float, miss_hit: float, miss_miss: float,
                  dist_sigma: float, chunk_size: int = 262144, evals: bool = False):
    """MCL's ray-cast (RC) sensor update on the exact walk: every particle's
    S beams cast against the map, scored and folded.

    ``tsm`` (N, 7) float32: each particle's sensor pose (w, x, y, z, tx,
    ty, tz). ``beams`` (S, 8) float32, the beams in the walk's angular
    order (:data:`BEAM_WORDS`): the sensor-frame unit direction, the
    measured range, the ray's t_max, whether the measurement is a real hit
    (1.0/0.0), and the beam's index in the sampled order. Ray (p, b) starts
    at the pose's translation along its rotation of beam b's direction,
    t_min 0. Each ray's error is the absolute signed distance of the
    measured point to the plane of the face it hits past ``range_min``
    (the hit distance re-derived from the plane, as
    :func:`~rmcl_tpu_torch.ops.raycast.cast_rays` does), or a penalty:
    ``hit_miss`` (real hit, simulated miss), ``miss_hit``, ``miss_miss``;
    its eval N(error; 0, dist_sigma). Returns ``(e_mean, e_var)`` (N,): the
    mean of each particle's S evals and their mean squared deviation from
    it; with ``evals=True`` also the (N, S) evals in the sampled order.

    CUDA tensors launch K5's ScoreRC instantiation (counted in
    ``traverse_rays.launches``) and the fold kernel (counted in
    ``walk_score_rc.fold_launches``) on the current stream, with no sync;
    CPU tensors take :func:`walk_score_rc_reference` (``chunk_size`` bounds
    its walk's memory)."""
    check_slots(nodes, root_link)
    N, S = tsm.shape[0], beams.shape[0]
    dev = nodes.device
    check_rows(dev, tsm=(tsm, torch.float32, (N, 7)),
               beams=(beams, torch.float32, (S, BEAM_WORDS)))
    scalars = dict(range_min=range_min, hit_miss=hit_miss, miss_hit=miss_hit,
                   miss_miss=miss_miss, dist_sigma=dist_sigma)
    if dev.type == "cpu":
        return walk_score_rc_reference(nodes, root_link, tsm, beams, chunk_size=chunk_size,
                                       evals=evals, **scalars)
    if dev.type != "cuda":
        raise ValueError(f"walk_score_rc runs on cuda or cpu tensors, not {dev}")
    if N * S >= 2 ** 31:
        raise ValueError(f"walk_score_rc takes fewer than 2^31 rays, got {N} x {S}")
    if beams.data_ptr() % 16:
        raise ValueError("beams must start on a 16-byte boundary (the kernel reads a beam as "
                         "two 16-byte loads)")
    ev = torch.empty((N, S), dtype=torch.float32, device=dev)
    e_mean = torch.empty((N,), dtype=torch.float32, device=dev)
    e_var = torch.empty((N,), dtype=torch.float32, device=dev)
    inv_s, coef = _gaussian_terms(dist_sigma)
    with torch.cuda.device(dev):
        err = _score_kernel()(
            nodes.data_ptr(), root_link.data_ptr(), tsm.data_ptr(), beams.data_ptr(),
            ev.data_ptr(), e_mean.data_ptr(), e_var.data_ptr(), N, S, nodes.shape[0],
            range_min, hit_miss, miss_hit, miss_miss, inv_s, coef,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"walk_score_rc kernel launch failed: cudaError {err}")
    if N and S:
        traverse_rays.launches += 1
        walk_score_rc.fold_launches += 1
    return (e_mean, e_var, ev) if evals else (e_mean, e_var)


walk_score_rc.fold_launches = 0


def walk_score_rc_reference(nodes: Tensor, root_link: Tensor, tsm: Tensor, beams: Tensor, *,
                            range_min: float, hit_miss: float, miss_hit: float,
                            miss_miss: float, dist_sigma: float, chunk_size: int = 262144,
                            evals: bool = False):
    """The same function in plain PyTorch, op for op the composition that
    :func:`~rmcl_tpu_torch.mcl.sensor_update.sensor_update` runs on the
    other engines: the rays (``update_rays``), the cast in the beams'
    angular order (:func:`traverse_rays_reference` in chunks of
    ``chunk_size`` rays, then ``cast_rays``' re-derivation from the
    winner's plane), the hits put back into the sampled order,
    ``score_rc``, and ``fold``'s Gaussian and sums. Its results are that
    composition's bitwise. Runs on any device."""
    from rmcl_tpu_torch.math.se3 import Quaternion
    from rmcl_tpu_torch.math.stats import gaussian_pdf
    from rmcl_tpu_torch.ops.raycast import NO_HIT_T, _dot3

    N, S = tsm.shape[0], beams.shape[0]
    dev = tsm.device
    # the beams' sampled order: angular slot of each sampled index
    inv = torch.empty((S,), dtype=torch.long, device=dev)
    inv[beams[:, 6].long()] = torch.arange(S, device=dev)
    o = tsm[:, None, 4:7].expand(N, S, 3)
    d = Quaternion.rotate(tsm[:, None, 0:4], beams[:, 0:3])  # angular order
    o_f, d_f = o.reshape(-1, 3), d.reshape(-1, 3)
    t_max = beams[:, 4].expand(N, S).reshape(-1)
    t_min = torch.zeros_like(t_max)
    step = max(1, int(chunk_size))
    slot = torch.cat([traverse_rays_reference(nodes, root_link, o_f[s:s + step],
                                              d_f[s:s + step], t_min[s:s + step],
                                              t_max[s:s + step])[1]
                      for s in range(0, N * S, step)]) if N * S else torch.empty(
        (0,), dtype=torch.int32, device=dev)

    # cast_rays (flip_normals=False): t from the winner's plane
    hit = slot >= 0
    leaf = nodes.view(torch.int32)[torch.where(hit, slot, 0).long()][:, :12].contiguous().view(
        torch.float32)
    v0, normal = leaf[:, 0:3], leaf[:, 9:12]
    denom = _dot3(normal, d_f)
    safe_denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    t_plane = _dot3(normal, v0 - o_f) / safe_denom
    t = torch.where(hit, t_plane, NO_HIT_T)
    point = torch.where(hit[:, None], o_f + t_plane[:, None] * d_f, 0.0)
    normal = torch.where(hit[:, None], normal, 0.0)
    sampled = lambda x: x.reshape((N, S) + tuple(x.shape[1:]))[:, inv]

    # score_rc, in the sampled order
    ranges, real = beams[inv, 3], beams[inv, 5] > 0.0
    sim_hit = sampled(hit) & (sampled(t) > range_min)
    p_real = o + sampled(d_f) * ranges[None, :, None]
    signed = torch.sum(sampled(normal) * (sampled(point) - p_real), dim=-1)
    real = real[None, :]
    error = torch.where(sim_hit, torch.where(real, torch.abs(signed), miss_hit),
                        torch.where(real, hit_miss, miss_miss))

    # fold's Gaussian and sums
    ev = gaussian_pdf(error, dist_sigma)
    e_mean = torch.sum(ev, dim=-1) / S
    e_var = torch.sum((ev - e_mean[:, None]) ** 2, dim=-1) / S
    return (e_mean, e_var, ev) if evals else (e_mean, e_var)
