"""Closest-point queries: the hand-written CUDA kernels and their plain
PyTorch versions.

``closest_bvh`` (K6) ports the XLA device loop of the JAX package's exact
closest-point walk, ``rmcl_tpu/ops/closest_point.py::_query_batch`` (:154,
loop :172-225); source ``rmcl_tpu_torch/csrc/closest_bvh.cu``.
``closest_bins`` (K6b) ports the chunk loop of ``closest_points_binned``
(:445-511); source ``rmcl_tpu_torch/csrc/closest_bins.cu``.
``cp_candidates`` (K7) ports the candidate cull that feeds it,
``_cp_candidates`` (:305, with ``_box_box_d2`` at :299); source
``rmcl_tpu_torch/csrc/cull_boxes.cu``, plain version
:func:`rmcl_tpu_torch.ops.closest_point._cp_candidates`. Each source's
header says what bounds it on the card and what the design does about it.
Both kernels spread a query over several lanes where queries are few
(:func:`walk_split`, :func:`bins_groups`): K6 walks P subtrees of the BVH
at once, K6b splits each bin's triangles over G lanes.

Contract of ``closest_bvh``: ``nodes (N, 16)``, ``root_link ()`` as for
:func:`rmcl_tpu_torch.ops.traverse_cuda.traverse_rays`; queries ``q (R,
3)`` and bounds ``max_d2 (R,)`` float32. Returns ``best_d2 (R,)``,
``point (R, 3)`` (0 where nothing is nearer than the bound) and ``slot (R,)``
int32 (-1); with ``visits=True`` also ``(R, 2)`` int32 visits (internal,
leaf) of the walk that ran: the serial walk at ``split=1``, else the split
walk's sum over its P lanes. The split walk's winners are the serial
walk's but at float near-ties (see :func:`closest_bvh_reference`), so a
query's result depends on the split, which the caller fixes for a batch.

Contract of ``closest_bins``: triangle payload ``tri (n_rows, 14, B)``
with B a power of two; query blocks ``qb (n_blk, Rq, 3)`` and ``d2b
(n_blk, Rq)``; per block a nearest-first candidate list ``cand_bin (n_blk,
cb)`` int32 (-1 padding, valid entries first), ``cand_count (n_blk,)`` and
``cand_dlb (n_blk, cb)`` (squared-distance lower bounds, ascending).
Returns ``best_key (n_blk, Rq)`` int32 ((bits(d2) & ~(B-1)) | j, or the
bound's bits | (B-1)) and ``best_bin (n_blk, Rq)`` int32 (-1).

Contract of ``cp_candidates``: the bins' ``super_aabb (n_super, 6)`` and
``bin_aabb (n_bins, 6)``; query blocks ``qb (n_blk, Rq, 3)`` and bounds
``d2b (n_blk, Rq)``; budgets ``cs <= n_super`` supers and ``1 <= cb <= cs
x S`` bins. Returns K6b's candidate lists ``cand_bin (n_blk, cb)`` int32,
``cand_count (n_blk,)`` int32 and ``cand_dlb (n_blk, cb)`` float32.
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
_BIG = 3.0e38
# the lane splits K6's entry point is built for
WALK_SPLITS = (1, 2, 4, 8)
# threads resident on the card the port targets, an H100 (132 SMs x 2048)
_H100_THREADS = 132 * 2048


@functools.lru_cache(maxsize=None)
def _bvh_kernel():
    """K6's C entry point (``rmcl_closest_bvh``), built on first use."""
    fn = _build.load_library("closest_bvh").rmcl_closest_bvh
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _BoxArgs(ctypes.Structure):
    """K7's argument struct (``BoxArgs`` in ``csrc/cull_boxes.cu``), field
    for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("qb", "d2b", "super_aabb", "bin_aabb",
                                                 "cand_bin", "cand_count", "cand_dlb")]
                + [(n, ctypes.c_int) for n in ("n_blk", "Rq", "n_super", "n_bins", "S", "cs",
                                               "cb")]
                + [("idm", ctypes.c_uint), ("packed", ctypes.c_int), ("threads", ctypes.c_int),
                   ("key_slots", ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _boxes_kernel():
    """K7's C entry point (``rmcl_cull_boxes``), built on first use."""
    fn = _build.load_library("cull_boxes").rmcl_cull_boxes
    fn.argtypes = [ctypes.POINTER(_BoxArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bins_kernel():
    """K6b's C entry point (``rmcl_closest_bins``), built on first use."""
    fn = _build.load_library("closest_bins").rmcl_closest_bins
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) of each closest-point kernel as built, by ``cudaFuncGetAttributes``:
    ``{"K6 P=1": (regs, local), ..., "K6b": (regs, local), "K7": (regs,
    local), "K7 wide": (regs, local)}`` (K7 at 128 and at 512 threads a
    CTA). Needs a card."""
    out = {}
    regs, local = ctypes.c_int(), ctypes.c_int()
    bvh = _build.load_library("closest_bvh").rmcl_closest_bvh_attrs
    bvh.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for P in WALK_SPLITS:
        if bvh(P, ctypes.byref(regs), ctypes.byref(local)):
            raise RuntimeError(f"cudaFuncGetAttributes failed for K6 at P={P}")
        out[f"K6 P={P}"] = (regs.value, local.value)
    bins = _build.load_library("closest_bins").rmcl_closest_bins_attrs
    bins.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if bins(ctypes.byref(regs), ctypes.byref(local)):
        raise RuntimeError("cudaFuncGetAttributes failed for K6b")
    out["K6b"] = (regs.value, local.value)
    boxes = _build.load_library("cull_boxes").rmcl_cull_boxes_attrs
    boxes.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    static = ctypes.c_int()
    for name, threads in (("K7", K7_NARROW), ("K7 wide", K7_WIDE)):
        if boxes(threads, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(static)):
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name}")
        if static.value > _K7_STATIC_SMEM:
            raise RuntimeError(f"{name} holds {static.value} bytes of static shared memory, "
                               f"more than the launch plan's {_K7_STATIC_SMEM}")
        out[name] = (regs.value, local.value)
    return out


@functools.lru_cache(maxsize=None)
def _card_threads(index: int) -> int:
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def fill_threads(device=None) -> int:
    """Threads the card holds at once: a CUDA device's SMs x threads per
    SM; for any other device an H100's (132 x 2048), so that the plain
    version on the CPU takes the launch shape an H100 would."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return _H100_THREADS
    return _card_threads(torch.cuda.current_device() if dev.index is None else dev.index)


def lane_groups(n_queries: int, limit: int, block: int | None = None, least: int = 1,
                device=None) -> int:
    """Lanes that share one query in a launch: from ``least`` (1 where it
    does not fit), the largest power of two <= ``limit`` that keeps
    ``n_queries`` x lanes within the threads the card holds
    (:func:`fill_threads` of ``device``) and, for queries in CTAs of
    ``block``, the CTA within 1024 threads. So the lanes multiply where the
    queries alone leave the card idle."""
    def fits(G):
        return G <= limit and (block is None or -(-block * G // 32) * 32 <= 1024)

    fill = fill_threads(device)
    G = least if fits(least) else 1
    while fits(2 * G) and n_queries * 2 * G <= fill:
        G *= 2
    return G


def walk_split(n_queries: int, device=None) -> int:
    """K6's lanes a query, P: on an H100 8 at one scan's 14,400 queries,
    1 at 14.4M. On an NVIDIA H100 80GB HBM3 at 700 W
    (scripts/torch_cp_split_probe.py, PERF.md) P = 8 walked phase 8's
    14,400 queries in 0.63 ms against 1.26 at P = 1, and P = 1 phase 9's
    14.4M in 8.75 ms against 12.63 at P = 2. Only those two sizes were
    timed: the rule's choice between them (P = 4 at 50,000 queries, 2 at
    100,000) is not measured."""
    return lane_groups(n_queries, WALK_SPLITS[-1], device=device)


def bins_groups(n_blk: int, Rq: int, B: int, device=None) -> int:
    """K6b's lanes a query, G: at least 2; on an H100 8 at one scan's 113
    blocks of 128 queries, 2 at 112,500. On an NVIDIA H100 80GB HBM3 at
    700 W (scripts/torch_cp_split_probe.py, PERF.md) G = 8 tested phase
    8's blocks in 0.63 ms against 1.30 at G = 1, and G = 2 phase 9's in
    14.7 ms against 16.4 at G = 1 and 15.1 at G = 4: a second lane halves
    each visit's chain of pairs even where the grid fills the card. Only
    those two sizes were timed: the rule's choice between them is not
    measured. G does not change the result."""
    return lane_groups(n_blk * Rq, min(8, B), block=Rq, least=2, device=device)


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
                visits: bool = False, split: int | None = None):
    """Closest mesh point per query over the threaded BVH.

    ``split`` lanes walk each query (1, 2, 4 or 8; default
    :func:`walk_split` of the query count on this device). CUDA tensors
    launch the kernel (or raise); CPU tensors take
    :func:`closest_bvh_reference` at the same split.
    ``closest_bvh.launches`` counts the kernel launches."""
    check_slots(nodes, root_link)
    R = q.shape[0]
    dev = nodes.device
    check_rows(dev, q=(q, torch.float32, (R, 3)), max_d2=(max_d2, torch.float32, (R,)))
    P = walk_split(R, dev) if split is None else split
    if P not in WALK_SPLITS:
        raise ValueError(f"split {P} must be one of {WALK_SPLITS}")
    if dev.type == "cpu":
        return closest_bvh_reference(nodes, root_link, q, max_d2, visits, split=P)
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
            0 if counts is None else counts.data_ptr(), R, nodes.shape[0], P,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"closest_bvh kernel launch failed: cudaError {err}")
    closest_bvh.launches += 1
    return (best_d2, point, slot, counts) if visits else (best_d2, point, slot)


closest_bvh.launches = 0


def closest_bvh_reference(nodes: Tensor, root_link: Tensor, q: Tensor, max_d2: Tensor,
                          visits: bool = False, seen: Tensor | None = None, split: int = 1):
    """The same function in plain PyTorch: one step per visit over the
    queries still walking, reading int32 slot rows, with the kernel's
    arithmetic term for term. ``split=1`` is the serial walk; 2, 4 or 8 the
    kernel's split walk, step for step (:func:`_closest_bvh_split`), whose
    best_d2, point and slot are the serial walk's but at float near-ties,
    where a leaf's point rounds outside its box: on an H100, 5 of one
    scan's 14,400 queries (0.035%) at every split, their distances within
    15 float32 spacings, and none of 14.4M queries on the 1M-face sphere
    (PERF.md); tests/test_torch_closest_point.py allows 1% and 1e-5
    relative. Runs on any device.
    ``seen``, an optional (N,) bool tensor, gets the slots read marked (a
    bound counts them)."""
    if split != 1:
        return _closest_bvh_split(nodes, root_link, q, max_d2, split, visits, seen)
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


def split_frontier(nodes: Tensor, root_link: Tensor, P: int):
    """The split walk's frontier: ``(start, end)`` links, (P,) int32, of the
    P subtrees that cover the BVH in preorder (lane p walks from start[p]
    until it reaches end[p], its subtree root's miss link; start = end for
    a lane with nothing). From the root, lane p's bits, highest first, pick
    the first or second child; a leaf met above depth log2(P) goes to the
    lane whose remaining bits are 0. The kernel's rule, in torch ops."""
    nodes_i = nodes.view(torch.int32)
    dev = nodes.device
    cur = root_link.reshape(1).expand(P).clone()
    end = torch.full((P,), _SENT, dtype=torch.int32, device=dev)
    lanes = torch.arange(P, device=dev)
    bit = P >> 1
    while bit:
        second_child = (lanes & bit) != 0
        open_ = cur != end
        internal = open_ & (cur >= 0)
        hit = nodes_i[torch.where(internal, cur, 0).long(), 12]
        first = torch.where(internal, torch.where(hit < 0, ~hit, hit), 0)
        second = nodes_i[first.long(), 13]
        emptied = open_ & (cur < 0) & second_child  # a leaf above the frontier's depth
        cur, end = (torch.where(internal, torch.where(second_child, second, hit),
                                torch.where(emptied, end, cur)),
                    torch.where(internal & ~second_child, second, end))
        bit >>= 1
    return cur, end


def _closest_bvh_split(nodes, root_link, q, max_d2, P, visits, seen):
    """The kernel's split walk in plain PyTorch: row r * P + p is lane p of
    query r. Each step, every lane still in its subtree takes one visit
    against the pair (best_d2, slot) its query held after the last step (a
    leaf is taken when its pair is lexicographically smaller, a box entered
    when d2_box <= best_d2); then each query keeps the least pair of its
    lanes. The winner's point is recomputed from its slot."""
    if P not in WALK_SPLITS:
        raise ValueError(f"split {P} must be one of {WALK_SPLITS}")
    R = q.shape[0]
    dev = q.device
    nodes_i = nodes.view(torch.int32)
    start, end = split_frontier(nodes, root_link, P)
    cur, end = start.repeat(R), end.repeat(R)
    query = torch.arange(R * P, device=dev) // P
    best_d2 = max_d2.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((R * P, 2), dtype=torch.int32, device=dev)
    no_key = torch.iinfo(torch.int64).max
    alive = torch.nonzero(cur != end).squeeze(1)
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
        qa = query[alive]
        qx, qy, qz = (q[qa, k] for k in range(3))
        bd, bs = best_d2[qa], best[qa]

        # leaf: the closest point on the inline triangle
        ax, ay, az, abx, aby, abz, acx, acy, acz = (w[:, k] for k in range(9))
        v, ww = ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz)
        px = ax + v * abx + ww * acx
        py = ay + v * aby + ww * acy
        pz = az + v * abz + ww * acz
        ex, ey, ez = qx - px, qy - py, qz - pz
        d2 = ex * ex + ey * ey + ez * ez
        better = leaf & ((d2 < bd) | ((d2 == bd) & (idx < bs)))
        # each query's least (d2, slot) among its lanes' taken leaves; d2 >= 0
        # orders like its bits, so one int64 key orders the pairs
        key = torch.where(better, (d2.view(torch.int32).long() << 32) | idx.long(), no_key)
        least = torch.full((R,), no_key, dtype=torch.int64, device=dev)
        least.scatter_reduce_(0, qa, key, "amin")
        took = least != no_key
        best_d2 = torch.where(took, (least >> 32).to(torch.int32).view(torch.float32), best_d2)
        best = torch.where(took, (least & 0xFFFFFFFF).to(torch.int32), best)

        # internal: prune by the squared distance to the node's box
        cx = torch.clamp(qx, min=ax, max=abx) - qx
        cy = torch.clamp(qy, min=ay, max=aby) - qy
        cz = torch.clamp(qz, min=az, max=abz) - qz
        d2_box = cx * cx + cy * cy + cz * cz
        descend = ~leaf & (d2_box <= bd)
        nxt = torch.where(descend, rows[:, 12], rows[:, 13])
        cur[alive] = nxt
        counts[alive, 0] += (~leaf).to(torch.int32)
        counts[alive, 1] += leaf.to(torch.int32)
        alive = alive[nxt != end[alive]]

    # the winner's point, with the serial walk's arithmetic
    found = best >= 0
    w = nodes_i[torch.where(found, best, 0).long()].view(torch.float32)
    ax, ay, az, abx, aby, abz, acx, acy, acz = (w[:, k] for k in range(9))
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    v, ww = ericson_vw_planes(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz)
    point = torch.stack([ax + v * abx + ww * acx, ay + v * aby + ww * acy,
                         az + v * abz + ww * acz], -1)
    point = torch.where(found[:, None], point, 0.0)
    counts = counts.view(R, P, 2).sum(1, dtype=torch.int32)
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
        raise ValueError(f"block size {Rq} must be in [1, 1024] (one CTA, a lane or more a query)")
    if cb < 1:
        raise ValueError("cand_bin must be (n_blk, cb) with cb >= 1")
    check_rows(tri.device, qb=(qb, torch.float32, (n_blk, Rq, 3)),
               d2b=(d2b, torch.float32, (n_blk, Rq)),
               cand_bin=(cand_bin, torch.int32, (n_blk, cb)),
               cand_count=(cand_count, torch.int32, (n_blk,)),
               cand_dlb=(cand_dlb, torch.float32, (n_blk, cb)))


def closest_bins(tri: Tensor, qb: Tensor, d2b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                 cand_dlb: Tensor, groups: int | None = None):
    """Packed-key closest triangle per query over each block's candidates.

    ``groups`` lanes share each query's triangles (a power of two <= min(B,
    32) whose CTA fits 1024 threads; default :func:`bins_groups`); the
    result does not depend on it. CUDA tensors launch the kernel (or
    raise); CPU tensors take :func:`closest_bins_reference`.
    ``closest_bins.launches`` counts the kernel launches."""
    _check_bins(tri, qb, d2b, cand_bin, cand_count, cand_dlb)
    n_blk, Rq, B = qb.shape[0], qb.shape[1], tri.shape[2]
    G = bins_groups(n_blk, Rq, B, tri.device) if groups is None else groups
    if G < 1 or G & (G - 1) or G > min(B, 32) or -(-Rq * G // 32) * 32 > 1024:
        raise ValueError(f"{G} lanes a query do not fit bins of {B} in a CTA of {Rq} queries")
    dev = tri.device
    if dev.type == "cpu":
        return closest_bins_reference(tri, qb, d2b, cand_bin, cand_count, cand_dlb)
    if dev.type != "cuda":
        raise ValueError(f"closest_bins runs on cuda or cpu tensors, not {dev}")
    best_key = torch.empty((n_blk, Rq), dtype=torch.int32, device=dev)
    best_bin = torch.empty((n_blk, Rq), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _bins_kernel()(
            tri.data_ptr(), qb.data_ptr(), d2b.data_ptr(), cand_bin.data_ptr(),
            cand_count.data_ptr(), cand_dlb.data_ptr(), best_key.data_ptr(), best_bin.data_ptr(),
            n_blk, Rq, cand_bin.shape[1], B, G, torch.cuda.current_stream(dev).cuda_stream,
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


# --- K7: the candidate cull of the binned query --------------------------

# shared memory one CTA may hold on an H100 (232,448 bytes)
_SMEM_CAP = 232448
# K7's static shared memory (its scratch and the warps' partial boxes, ~1.5
# KB at 512 threads), with room to spare; kernel_registers checks it
_K7_STATIC_SMEM = 2048
# K7's CTA widths, and the keys (a level's width or a kept list) past which
# a block takes the wide CTA when the grid fits the card at that width
K7_NARROW, K7_WIDE = 128, 512
_K7_WIDE_KEYS = 1024
# the most keys a level's stage holds; a level that passes more is streamed
_K7_STAGE_MAX = 16384


def cp_launch_plan(n_blk: int, n_super: int, S: int, cs: int, cb: int,
                   fill: int = _H100_THREADS) -> tuple[int, int, int]:
    """K7's launch shape for n_blk query blocks against n_super supers of S
    bins at budgets (cs, cb): ``(threads a CTA, key slots, dynamic shared
    bytes)``. Shared memory holds the kept supers' ids (4 B each) and the
    key slots (8 B each): a level's kept list (cs or cb) and past it the
    level's stage, up to ``_K7_STAGE_MAX`` keys where the level is wider
    than its list, cut to what fits; a level that passes more keys than its
    stage is streamed, so no width is refused. Raises ``ValueError`` when a
    kept list does not fit one CTA (cb, or cs, past ~28,000 keys). The wide
    CTA takes a block whose widest level or list passes ``_K7_WIDE_KEYS``
    keys when the whole grid is resident at that width (``fill``: the card's
    threads, as :func:`fill_threads` counts them)."""
    sup_bytes = 4 * cs
    most = (_SMEM_CAP - _K7_STATIC_SMEM - sup_bytes) // 8
    if max(cs, cb) > most:
        raise ValueError(f"cb={cb} candidate keys (cs={cs} supers) do not fit a CTA's shared "
                         f"memory: a kept list holds at most {most} keys")

    def level(n, keep):
        return keep + (min(n, _K7_STAGE_MAX) if n > keep else 0)

    slots = min(most, max(level(n_super, cs), level(cs * S, cb)))
    wide = max(n_super, cs * S, cb) > _K7_WIDE_KEYS and n_blk * K7_WIDE <= fill
    return (K7_WIDE if wide else K7_NARROW), slots, slots * 8 + sup_bytes


def cp_candidates(bins, qb: Tensor, d2b: Tensor, cs: int, cb: int, block_chunk: int = 256):
    """Nearest-first candidate bins per query block of the binned
    closest-point query: the cs nearest supers of each block's query box
    within its greatest bound, then the cb nearest of their bins.

    CUDA tensors launch K7 once for every block (or raise); CPU tensors take
    the plain version, :func:`rmcl_tpu_torch.ops.closest_point._cp_candidates`,
    ``block_chunk`` blocks at a time (memory only: each block's list is its
    own). ``cp_candidates.launches`` counts the kernel launches."""
    from rmcl_tpu_torch.ops import closest_point

    n_blk, Rq = qb.shape[0], qb.shape[1]
    S, n_super, n_bins = bins.bins_per_super, bins.n_super, bins.n_bins
    dev = qb.device
    if not 1 <= cs <= n_super or not 1 <= cb <= cs * S:
        raise ValueError(f"budgets cs={cs}, cb={cb} must satisfy 1 <= cs <= {n_super} and "
                         f"1 <= cb <= cs x {S}")
    check_rows(dev, qb=(qb, torch.float32, (n_blk, Rq, 3)),
               d2b=(d2b, torch.float32, (n_blk, Rq)),
               super_aabb=(bins.super_aabb, torch.float32, (n_super, 6)),
               bin_aabb=(bins.bin_aabb, torch.float32, (n_bins, 6)))
    if dev.type == "cpu":
        d2cap = torch.amax(d2b, dim=1)
        step = max(1, int(block_chunk))
        parts = [closest_point._cp_candidates(bins, qb[s:s + step], d2cap[s:s + step], cs, cb)
                 for s in range(0, max(n_blk, 1), step)]
        return tuple(torch.cat([p[k] for p in parts]) for k in range(3))
    if dev.type != "cuda":
        raise ValueError(f"cp_candidates runs on cuda or cpu tensors, not {dev}")
    threads, slots, _ = cp_launch_plan(n_blk, n_super, S, cs, cb, fill_threads(dev))
    id_bits = max(1, (n_bins - 1).bit_length())
    packed = id_bits <= closest_point._PACKED_ID_BITS
    cand_bin = torch.empty((n_blk, cb), dtype=torch.int32, device=dev)
    cand_count = torch.empty((n_blk,), dtype=torch.int32, device=dev)
    cand_dlb = torch.empty((n_blk, cb), dtype=torch.float32, device=dev)
    args = _BoxArgs(qb.data_ptr(), d2b.data_ptr(), bins.super_aabb.data_ptr(),
                    bins.bin_aabb.data_ptr(), cand_bin.data_ptr(), cand_count.data_ptr(),
                    cand_dlb.data_ptr(), n_blk, Rq, n_super, n_bins, S, cs, cb,
                    (1 << id_bits) - 1 if packed else 0, int(packed), threads, slots)
    with torch.cuda.device(dev):
        err = _boxes_kernel()(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cp_candidates kernel launch failed: cudaError {err}")
    cp_candidates.launches += 1
    return cand_bin, cand_count, cand_dlb


cp_candidates.launches = 0
