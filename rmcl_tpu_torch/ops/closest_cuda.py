"""Closest-point queries: the hand-written CUDA kernels and their plain
PyTorch versions.

``closest_bvh`` (K6) ports the XLA device loop of the JAX package's exact
closest-point walk, ``rmcl_tpu/ops/closest_point.py::_query_batch`` (:154,
loop :172-225); source ``rmcl_tpu_torch/csrc/closest_bvh.cu``.
``closest_bins`` (K6b) ports the chunk loop of ``closest_points_binned``
(:445-511); source ``rmcl_tpu_torch/csrc/closest_bins.cu``. Each source's
header says what bounds it on the card and what the design does about it.

Contract of ``closest_bvh``: ``nodes (N, 16)``, ``root_link ()`` as for
:func:`rmcl_tpu_torch.ops.traverse_cuda.traverse_rays`; queries ``q (R,
3)`` and bounds ``max_d2 (R,)`` float32. Returns ``best_d2 (R,)``,
``point (R, 3)`` (0 where nothing is nearer than the bound) and ``slot (R,)``
int32 (-1); with ``visits=True`` also ``(R, 2)`` int32 visits (internal,
leaf).

Contract of ``closest_bins``: triangle payload ``tri (n_rows, 14, B)``
with B a power of two; query blocks ``qb (n_blk, Rq, 3)`` and ``d2b
(n_blk, Rq)``; per block a nearest-first candidate list ``cand_bin (n_blk,
cb)`` int32 (-1 padding, valid entries first), ``cand_count (n_blk,)`` and
``cand_dlb (n_blk, cb)`` (squared-distance lower bounds, ascending).
Returns ``best_key (n_blk, Rq)`` int32 ((bits(d2) & ~(B-1)) | j, or the
bound's bits | (B-1)) and ``best_bin (n_blk, Rq)`` int32 (-1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.types import SENTINEL_LINK
from rmcl_tpu_torch.ops.traverse_cuda import check_rows, check_slots

Tensor = torch.Tensor

_SENT = int(SENTINEL_LINK)
_BIG = 3.0e38


@functools.lru_cache(maxsize=None)
def _bvh_kernel():
    """K6's C entry point (``rmcl_closest_bvh``), built on first use."""
    fn = _build.load_library("closest_bvh").rmcl_closest_bvh
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bins_kernel():
    """K6b's C entry point (``rmcl_closest_bins``), built on first use."""
    fn = _build.load_library("closest_bins").rmcl_closest_bins
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz):
    """Barycentric (v, w) of the closest point on triangle(s), on scalar
    component planes (elementwise, any broadcastable shapes): Ericson,
    Real-Time Collision Detection §5.1.5, the regions resolved by selects.
    The closest point is ``a + v*ab + w*ac``. The kernels' arithmetic
    (``csrc/ericson.cuh``), term for term."""
    apx, apy, apz = qx - ax, qy - ay, qz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    bpx, bpy, bpz = apx - abx, apy - aby, apz - abz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    cpx, cpy, cpz = apx - acx, apy - acy, apz - acz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_face = torch.clamp(va + vb + vc, min=1e-30)
    v_face = vb / denom_face
    w_face = vc / denom_face

    def safe_div(a, b):
        return a / torch.where(torch.abs(b) > 1e-30, b, 1e-30)

    v_ab = torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    no_vert = ~in_a & ~in_b & ~in_c
    in_ab = no_vert & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = no_vert & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = no_vert & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    v = torch.where(in_a | in_c, 0.0, torch.where(in_b, 1.0, v_face))
    w = torch.where(in_a | in_b, 0.0, torch.where(in_c, 1.0, w_face))
    v = torch.where(in_ab, v_ab, v)
    w = torch.where(in_ab, 0.0, w)
    v = torch.where(in_ac, 0.0, v)
    w = torch.where(in_ac, w_ac, w)
    v = torch.where(in_bc, 1.0 - t_bc, v)
    w = torch.where(in_bc, t_bc, w)
    return v, w


# --- K6: the exact walk over the BVH -------------------------------------


def closest_bvh(nodes: Tensor, root_link: Tensor, q: Tensor, max_d2: Tensor,
                visits: bool = False):
    """Closest mesh point per query over the threaded BVH.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`closest_bvh_reference`. ``closest_bvh.launches`` counts the
    kernel launches."""
    check_slots(nodes, root_link)
    R = q.shape[0]
    dev = nodes.device
    check_rows(dev, q=(q, torch.float32, (R, 3)), max_d2=(max_d2, torch.float32, (R,)))
    if dev.type == "cpu":
        return closest_bvh_reference(nodes, root_link, q, max_d2, visits)
    if dev.type != "cuda":
        raise ValueError(f"closest_bvh runs on cuda or cpu tensors, not {dev}")
    best_d2 = torch.empty((R,), dtype=torch.float32, device=dev)
    point = torch.empty((R, 3), dtype=torch.float32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    counts = torch.empty((R, 2), dtype=torch.int32, device=dev) if visits else None
    with torch.cuda.device(dev):
        err = _bvh_kernel()(
            nodes.data_ptr(), root_link.data_ptr(), q.data_ptr(), max_d2.data_ptr(),
            best_d2.data_ptr(), point.data_ptr(), slot.data_ptr(),
            0 if counts is None else counts.data_ptr(), R, nodes.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"closest_bvh kernel launch failed: cudaError {err}")
    closest_bvh.launches += 1
    return (best_d2, point, slot, counts) if visits else (best_d2, point, slot)


closest_bvh.launches = 0


def closest_bvh_reference(nodes: Tensor, root_link: Tensor, q: Tensor, max_d2: Tensor,
                          visits: bool = False, seen: Tensor | None = None):
    """The same function in plain PyTorch: one step per visit over the
    queries still walking, reading int32 slot rows, with the kernel's
    arithmetic term for term. Runs on any device. ``seen``, an optional
    (N,) bool tensor, gets the slots read marked (a bound counts them)."""
    R = q.shape[0]
    dev = q.device
    nodes_i = nodes.view(torch.int32)
    best_d2 = max_d2.clone()
    point = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((R, 2), dtype=torch.int32, device=dev)
    cur = root_link.expand(R).clone()
    alive = torch.nonzero(cur != _SENT).squeeze(1)
    for _ in range(nodes.shape[0]):
        if alive.numel() == 0:
            break
        c = cur[alive]
        leaf = c < 0
        idx = torch.where(leaf, ~c, c)
        rows = nodes_i[idx.long()]
        if seen is not None:
            seen[idx.long()] = True
        w = rows.view(torch.float32)
        qx, qy, qz = (q[alive, k] for k in range(3))
        bd = best_d2[alive]

        # leaf: the closest point on the inline triangle
        ax, ay, az, abx, aby, abz, acx, acy, acz = (w[:, k] for k in range(9))
        v, ww = ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz)
        px = ax + v * abx + ww * acx
        py = ay + v * aby + ww * acy
        pz = az + v * abz + ww * acz
        ex, ey, ez = qx - px, qy - py, qz - pz
        d2 = ex * ex + ey * ey + ez * ez
        better = leaf & (d2 < bd)
        best_d2[alive] = torch.where(better, d2, bd)
        point[alive] = torch.where(better[:, None], torch.stack([px, py, pz], -1), point[alive])
        best[alive] = torch.where(better, idx, best[alive])

        # internal: prune by the squared distance to the node's box
        cx = torch.clamp(qx, min=ax, max=abx) - qx
        cy = torch.clamp(qy, min=ay, max=aby) - qy
        cz = torch.clamp(qz, min=az, max=abz) - qz
        d2_box = cx * cx + cy * cy + cz * cz
        descend = ~leaf & (d2_box < bd)
        nxt = torch.where(descend, rows[:, 12], rows[:, 13])
        cur[alive] = nxt
        counts[alive, 0] += (~leaf).to(torch.int32)
        counts[alive, 1] += leaf.to(torch.int32)
        alive = alive[nxt != _SENT]
    return (best_d2, point, best, counts) if visits else (best_d2, point, best)


# --- K6b: the candidate-bin loop -------------------------------------------


def _check_bins(tri, qb, d2b, cand_bin, cand_count, cand_dlb):
    n_blk, Rq = qb.shape[0], qb.shape[1]
    cb = cand_bin.shape[1] if cand_bin.dim() == 2 else -1
    if tri.dtype != torch.float32 or tri.dim() != 3 or tri.shape[1] != 14:
        raise ValueError(f"tri must be (n_rows, 14, B) float32, got {tuple(tri.shape)}")
    if not tri.is_contiguous():
        raise ValueError("tri must be contiguous")
    B = tri.shape[2]
    if B < 1 or B & (B - 1):
        raise ValueError(f"bin size {B} must be a power of two (packed-key min)")
    if not 1 <= Rq <= 1024:
        raise ValueError(f"block size {Rq} must be in [1, 1024] (one CTA, a thread a query)")
    if cb < 1:
        raise ValueError("cand_bin must be (n_blk, cb) with cb >= 1")
    check_rows(tri.device, qb=(qb, torch.float32, (n_blk, Rq, 3)),
               d2b=(d2b, torch.float32, (n_blk, Rq)),
               cand_bin=(cand_bin, torch.int32, (n_blk, cb)),
               cand_count=(cand_count, torch.int32, (n_blk,)),
               cand_dlb=(cand_dlb, torch.float32, (n_blk, cb)))


def closest_bins(tri: Tensor, qb: Tensor, d2b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                 cand_dlb: Tensor):
    """Packed-key closest triangle per query over each block's candidates.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`closest_bins_reference`. ``closest_bins.launches`` counts the
    kernel launches."""
    _check_bins(tri, qb, d2b, cand_bin, cand_count, cand_dlb)
    dev = tri.device
    if dev.type == "cpu":
        return closest_bins_reference(tri, qb, d2b, cand_bin, cand_count, cand_dlb)
    if dev.type != "cuda":
        raise ValueError(f"closest_bins runs on cuda or cpu tensors, not {dev}")
    n_blk, Rq = qb.shape[0], qb.shape[1]
    best_key = torch.empty((n_blk, Rq), dtype=torch.int32, device=dev)
    best_bin = torch.empty((n_blk, Rq), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _bins_kernel()(
            tri.data_ptr(), qb.data_ptr(), d2b.data_ptr(), cand_bin.data_ptr(),
            cand_count.data_ptr(), cand_dlb.data_ptr(), best_key.data_ptr(), best_bin.data_ptr(),
            n_blk, Rq, cand_bin.shape[1], tri.shape[2],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"closest_bins kernel launch failed: cudaError {err}")
    closest_bins.launches += 1
    return best_key, best_bin


closest_bins.launches = 0

# plain-version pair elements per step (blocks x B x Rq): bounds memory
_REF_PAIRS_PER_STEP = 1 << 22


def closest_bins_reference(tri: Tensor, qb: Tensor, d2b: Tensor, cand_bin: Tensor,
                           cand_count: Tensor, cand_dlb: Tensor):
    """The same function in plain PyTorch: one step per candidate slot over
    the (blocks, B, Rq) pairs of the blocks still running, the same
    packed-key fold and the same per-block nearest-first exit, in slices of
    blocks that bound memory. Runs on any device."""
    n_blk, Rq = qb.shape[0], qb.shape[1]
    step = max(1, _REF_PAIRS_PER_STEP // (tri.shape[2] * Rq))
    outs = [_closest_bins_slice(tri, qb[s:s + step], d2b[s:s + step], cand_bin[s:s + step],
                                cand_count[s:s + step], cand_dlb[s:s + step])
            for s in range(0, n_blk, step)]
    if not outs:
        empty = torch.empty((0, Rq), dtype=torch.int32, device=qb.device)
        return empty, empty.clone()
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _closest_bins_slice(tri, qb, d2b, cand_bin, cand_count, cand_dlb):
    n, Rq = qb.shape[0], qb.shape[1]
    B = tri.shape[2]
    jmask = B - 1
    j_iota = torch.arange(B, dtype=torch.int32, device=tri.device)[None, :, None]
    best_key = d2b.view(torch.int32) | jmask
    best_bin = torch.full((n, Rq), -1, dtype=torch.int32, device=tri.device)
    running = torch.ones(n, dtype=torch.bool, device=tri.device)
    for c in range(cand_bin.shape[1]):
        worst = (torch.amax(best_key, dim=1) | jmask).view(torch.float32)
        running = running & (c < cand_count) & (cand_dlb[:, c] <= worst)
        live = torch.nonzero(running).squeeze(1)
        if live.numel() == 0:
            break
        bid = cand_bin[live, c]
        tw = tri[bid.long(), :9]  # (L, 9, B)
        ax, ay, az, abx, aby, abz, acx, acy, acz = (tw[:, k, :, None] for k in range(9))
        qx, qy, qz = (qb[live, None, :, k] for k in range(3))  # (L, 1, Rq)
        v, w = ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz)
        ex = (qx - ax) - v * abx - w * acx
        ey = (qy - ay) - v * aby - w * acy
        ez = (qz - az) - v * abz - w * acz
        d2 = ex * ex + ey * ey + ez * ez  # (L, B, Rq)
        edges = (torch.abs(abx) + torch.abs(aby) + torch.abs(abz) + torch.abs(acx)
                 + torch.abs(acy) + torch.abs(acz))
        d2 = torch.where(edges < 1e-30, _BIG, d2)  # padding rows of the bin
        key = (d2.view(torch.int32) & ~jmask) | j_iota
        key_min = torch.amin(key, dim=1)  # (L, Rq)
        bk = best_key[live]
        better = key_min < bk
        best_key[live] = torch.where(better, key_min, bk)
        best_bin[live] = torch.where(better, bid[:, None], best_bin[live])
    return best_key, best_bin
