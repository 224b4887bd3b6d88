"""Candidate-bin intersection: the hand-written CUDA kernel and its plain
PyTorch version.

``intersect_bins`` is the port of the JAX package's only Pallas kernel,
``rmcl_tpu/ops/raycast_pallas.py::_intersect_kernel`` (wrapper
``intersect_bins_pallas``), and of the XLA chunk loop that the JAX library
runs in its place (``rmcl_tpu/ops/raycast_binned.py:951-1114``). The kernel
source is ``rmcl_tpu_torch/csrc/intersect_bins.cu``; its header says what
bounds it on the card and what the design does about that.

Contract (the Pallas kernel's): ray blocks ``ob, db (n_blk, Rb, 3)``,
``t_min_b, t_max_b (n_blk, Rb)``; per block a nearest-first candidate list
``cand_bin (n_blk, cb)`` int32 (-1 padding), ``cand_count (n_blk,)`` and
``cand_tnear (n_blk, cb)``; triangle payload ``tri (n_rows, 14, B)`` with B
a power of two. Returns ``t_best (n_blk, Rb)`` f32 (packed, rounded up) and
``ref (n_blk, Rb)`` int32 = bin * B + j, or -1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rmcl_tpu_torch import _build

Tensor = torch.Tensor

_BIG = 3.0e38
_EPS = 1e-7


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_intersect_bins``), built on first use."""
    fn = _build.load_library("intersect_bins").rmcl_intersect_bins
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear):
    n_blk, Rb = ob.shape[0], ob.shape[1]
    cb = cand_bin.shape[1] if cand_bin.dim() == 2 else -1
    expect = {
        "tri": (tri, torch.float32, None),
        "ob": (ob, torch.float32, (n_blk, Rb, 3)),
        "db": (db, torch.float32, (n_blk, Rb, 3)),
        "t_min_b": (t_min_b, torch.float32, (n_blk, Rb)),
        "t_max_b": (t_max_b, torch.float32, (n_blk, Rb)),
        "cand_bin": (cand_bin, torch.int32, (n_blk, cb)),
        "cand_count": (cand_count, torch.int32, (n_blk,)),
        "cand_tnear": (cand_tnear, torch.float32, (n_blk, cb)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != tri.device:
            raise ValueError(f"{name} is on {x.device}, tri on {tri.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tri.dim() != 3 or tri.shape[1] != 14:
        raise ValueError(f"tri must be (n_rows, 14, B), got {tuple(tri.shape)}")
    B = tri.shape[2]
    if B < 1 or B & (B - 1):
        raise ValueError(f"bin size {B} must be a power of two (packed-key min)")
    if not 1 <= Rb <= 1024:
        raise ValueError(f"block size {Rb} must be in [1, 1024] (one thread per ray)")
    if cb < 1:
        raise ValueError("cand_bin must be (n_blk, cb) with cb >= 1")


def intersect_bins(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor,
                   t_max_b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                   cand_tnear: Tensor):
    """Closest hit per ray over each block's candidate bins.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`intersect_bins_reference`. ``intersect_bins.launches`` counts the
    kernel launches."""
    _check_inputs(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear)
    dev = tri.device
    if dev.type == "cpu":
        return intersect_bins_reference(
            tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear)
    if dev.type != "cuda":
        raise ValueError(f"intersect_bins runs on cuda or cpu tensors, not {dev}")
    n_blk, Rb = ob.shape[0], ob.shape[1]
    t_best = torch.empty((n_blk, Rb), dtype=torch.float32, device=dev)
    ref = torch.empty((n_blk, Rb), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(
            tri.data_ptr(), ob.data_ptr(), db.data_ptr(),
            t_min_b.data_ptr(), t_max_b.data_ptr(),
            cand_bin.data_ptr(), cand_count.data_ptr(), cand_tnear.data_ptr(),
            t_best.data_ptr(), ref.data_ptr(),
            n_blk, Rb, cand_bin.shape[1], tri.shape[2],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"intersect_bins kernel launch failed: cudaError {err}")
    intersect_bins.launches += 1
    return t_best, ref


intersect_bins.launches = 0


def _moller_trumbore(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                     e2x, e2y, e2z, t_min):
    """Hit distance of rays against triangles (broadcast), 3e38 where the
    ray misses; the kernel's arithmetic, term for term."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = (torch.minimum(torch.minimum(u, v), (1.0 + _EPS) - (u + v)) >= -_EPS) & (t > t_min)
    return torch.where(ok, t, _BIG)


def winner_t(tri: Tensor, o: Tensor, d: Tensor, t_min: Tensor, ref: Tensor) -> Tensor:
    """The t that :func:`intersect_bins` would record for the triangle
    ``ref = bin * B + j`` names, per ray: its hit distance with the low
    log2(B) mantissa bits set, as the packed key leaves them; 3e38 where
    ``ref`` is -1 or the ray misses that triangle. Rays ``o, d (..., 3)``,
    ``t_min`` and ``ref (...)``.

    A winner that differs from another run's is a true near-tie only when
    this t agrees with the other run's ``t_best``."""
    B = tri.shape[2]
    jmask = B - 1
    r = ref.clamp(min=0).long()
    tw = tri[r // B, :9, r % B]  # (..., 9)
    t = _moller_trumbore(*o.unbind(-1), *d.unbind(-1), *tw.unbind(-1), t_min)
    t = torch.where(ref >= 0, t, _BIG)
    return ((t.view(torch.int32) & ~jmask) | jmask).view(torch.float32)


def intersect_bins_reference(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor,
                             t_max_b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                             cand_tnear: Tensor):
    """The same function in plain PyTorch: one step per candidate slot over
    (n_blk, B, Rb) pair tensors, the same packed-key fold and the same
    per-block nearest-first exit. Runs on any device."""
    n_blk, Rb, _ = ob.shape
    B = tri.shape[2]
    cb = cand_bin.shape[1]
    jmask = B - 1
    # zero sentinel row for finished blocks: all-zero triangles give
    # inv_det = 0 -> t = 0, which fails the strict t > t_min gate
    tri9 = torch.cat([tri[:, :9], tri.new_zeros((1, 9, B))], 0)
    sentinel = tri.shape[0]
    ox, oy, oz = (ob[:, None, :, k] for k in range(3))  # (n_blk, 1, Rb)
    dx, dy, dz = (db[:, None, :, k] for k in range(3))
    t_min = t_min_b[:, None, :]
    j_iota = torch.arange(B, dtype=torch.int32, device=tri.device)[None, :, None]
    t_best = t_max_b.clone()
    ref = torch.full((n_blk, Rb), -1, dtype=torch.int32, device=tri.device)
    running = torch.ones(n_blk, dtype=torch.bool, device=tri.device)
    for c in range(cb):
        running = running & (c < cand_count) & (
            cand_tnear[:, c] <= torch.max(t_best, dim=1).values)
        if not bool(running.any()):
            break
        bid = torch.where(running, cand_bin[:, c], sentinel)
        tw = tri9[bid]  # (n_blk, 9, B)
        t_cand = _moller_trumbore(
            ox, oy, oz, dx, dy, dz, *(tw[:, k, :, None] for k in range(9)),  # (n_blk, B, 1)
            t_min)
        key = (t_cand.view(torch.int32) & ~jmask) | j_iota
        key_min = torch.min(key, dim=1).values  # (n_blk, Rb)
        t_bin = (key_min | jmask).view(torch.float32)
        better = running[:, None] & (t_bin < t_best)
        t_best = torch.where(better, t_bin, t_best)
        ref = torch.where(better, bid[:, None] * B + (key_min & jmask), ref)
    return t_best, ref
