"""Exact BVH traversal (K5): the hand-written CUDA kernel and its plain
PyTorch version.

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


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) of K5's kernel as built, by ``cudaFuncGetAttributes``:
    ``{"K5": (regs, local)}``. Needs a card."""
    fn = _library().rmcl_traverse_bvh_attrs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    regs, local = ctypes.c_int(), ctypes.c_int()
    if fn(ctypes.byref(regs), ctypes.byref(local)):
        raise RuntimeError("cudaFuncGetAttributes failed for K5")
    return {"K5": (regs.value, local.value)}


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
