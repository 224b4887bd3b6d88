"""The batch corrector's epilogue, from K4's winning hits to each pose's
Umeyama increment, as one hand-written CUDA kernel and its plain version.

``batch_epilogue`` is the half of a batch correction after the cast
(:meth:`rmcl_tpu_torch.micp.batch.BatchCorrector.correct`): each winner's
plane, the hit point and normal, the point-to-plane pair and its gate, each
pose's cross-statistics and its Umeyama solve. It replaces no Pallas
kernel: the JAX package runs these steps as XLA ops of its batch
correction. The kernel source is ``rmcl_tpu_torch/csrc/batch_epilogue.cu``;
its header says what bounds it on the card and what the design does about
it. One launch a correction, and no host sync. Its plain version,
:func:`batch_epilogue_reference`, computes the same function in torch ops
and runs every CPU correction.

Contract: ``t_best`` (float32) and ``ref`` (int32), K4's packed t and
winner rows of the sweep's real blocks (:class:`~rmcl_tpu_torch.ops.
raycast_binned.FactoredWinners`, every block alive), which ``slots``
(int32 (N, D): the sweep's :meth:`~rmcl_tpu_torch.ops.raycast_binned.
TiledSweep.unpermute` of the slot numbers) index; ``planes`` (n_bins * B, 4) float32, the map's plane
table (:func:`winner_planes`), which the rows index; the
positions ``trans`` (N, 3) and the shared directions ``dirs`` (D, 3),
float32; ``data_points`` (N, D, 3) float32 in each sensor frame and
``data_mask`` (N, D) bool. Every tensor contiguous and on one device. Returns the increments (a Transform of
(N, 4) wxyz rotations and (N, 3) translations) and the pairs (N,) float32,
views of one (N, 8) tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.math.stats import umeyama_transform
from rmcl_tpu_torch.ops.raycast_cuda import plane_of

Tensor = torch.Tensor

OUT_WORDS = 8  # rotation (4), translation (3), pairs


@functools.lru_cache(maxsize=None)
def _library():
    return _build.load_library("batch_epilogue")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_batch_epilogue``), built on first use."""
    fn = _library().rmcl_batch_epilogue
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64)] + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) and static shared bytes a CTA of the kernel as built, by
    ``cudaFuncGetAttributes``: ``{"epilogue": (regs, local, static_shared)}``.
    Needs a card."""
    fn = _library().rmcl_batch_epilogue_attrs
    fn.argtypes = [ctypes.c_void_p] * 3
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if fn(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)):
        raise RuntimeError("cudaFuncGetAttributes failed for the epilogue kernel")
    return {"epilogue": (regs.value, local.value, smem.value)}


def winner_planes(tri: Tensor) -> Tensor:
    """The plane table of a map's triangle rows, (n_bins * B, 4) float32 on
    ``tri``'s device: row ``bin * B + lane`` holds (ng, c0), ng = e1 x e2
    and c0 = ng . v0 by the pair loop's formulas
    (:func:`~rmcl_tpu_torch.ops.raycast_cuda.plane_of`, each product and
    sum rounded in float32), what the plane payload derives from K4's
    winner row. Built once a map."""
    n_bins, _, B = tri.shape
    rows = tri[:, :9].permute(0, 2, 1).reshape(n_bins * B, 9)
    return torch.stack(plane_of(*rows.unbind(-1)), -1).contiguous()


def _check(dev, name: str, x, dtype, shape=None, dims=None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if dims is not None and x.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got shape {tuple(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, trans on {dev}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_epilogue_args(t_best, ref, planes, trans, dirs, data_points, data_mask,
                        slots) -> None:
    """Raise on what the kernel does not take: a dtype, a shape, a device or
    a layout other than the contract's. Reads only dtypes, shapes, devices
    and strides, so it runs on any tensors."""
    if not isinstance(trans, torch.Tensor) or trans.dim() != 2:
        raise ValueError("trans must be an (N, 3) tensor")
    dev = trans.device
    n, d = trans.shape[0], (dirs.shape[0] if isinstance(dirs, torch.Tensor) and dirs.dim() else -1)
    _check(dev, "trans", trans, torch.float32, (n, 3))
    _check(dev, "dirs", dirs, torch.float32, (d, 3))
    _check(dev, "data_points", data_points, torch.float32, (n, d, 3))
    _check(dev, "data_mask", data_mask, torch.bool, (n, d))
    _check(dev, "slots", slots, torch.int32, (n, d))
    _check(dev, "t_best", t_best, torch.float32)
    _check(dev, "ref", ref, torch.int32, tuple(t_best.shape))
    _check(dev, "planes", planes, torch.float32, dims=2)
    if planes.shape[1] != 4:
        raise ValueError(f"planes must have shape (n_rows, 4), got {tuple(planes.shape)}")
    if planes.data_ptr() % 16:
        raise ValueError("planes must start on a 16-byte boundary (one float4 load a row)")
    if t_best.numel() < n * d:
        raise ValueError(f"t_best holds {t_best.numel()} slots, fewer than the {n * d} pairs")
    if t_best.numel() >= 2 ** 31:
        raise ValueError("the slots are int32: t_best must hold fewer than 2**31 slots")


def batch_epilogue_reference(t_best: Tensor, ref: Tensor, planes: Tensor, trans: Tensor,
                             dirs: Tensor, data_points: Tensor, data_mask: Tensor, slots: Tensor,
                             max_dist: float, t_max: float) -> Tuple[Transform, Tensor]:
    """:func:`batch_epilogue`'s function in torch ops, on any device: each
    pair's plane, gate and projection in float32 as the kernel computes
    them, the sums in float64, Umeyama a pose."""
    s = slots.long()
    t = t_best.reshape(-1)[s]
    hit = (t < t_max) & (t < 3.0e38)
    ngx, ngy, ngz, c0 = planes[torch.clamp(ref.reshape(-1)[s], min=0).long()].unbind(-1)
    d = dirs[None].expand(data_points.shape)
    o = trans[:, None].expand(data_points.shape)
    denom = ngx * d[..., 0] + ngy * d[..., 1] + ngz * d[..., 2]
    safe = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    t_plane = (c0 - (ngx * o[..., 0] + ngy * o[..., 1] + ngz * o[..., 2])) / safe
    inv_len = 1.0 / torch.sqrt(torch.clamp(ngx * ngx + ngy * ngy + ngz * ngz, min=1e-30))
    normal = torch.stack([ngx, ngy, ngz], -1) * inv_len[..., None]
    normal = normal * torch.where(denom > 0, -1.0, 1.0)[..., None]
    p = o + t_plane[..., None] * d
    m = data_points + o
    diff = m - p
    signed = (normal[..., 0] * diff[..., 0] + normal[..., 1] * diff[..., 1]
              + normal[..., 2] * diff[..., 2])
    ok = data_mask & hit & (torch.abs(signed) <= max_dist)
    proj = torch.where(ok[..., None], m - signed[..., None] * normal, 0.0)
    stats = CrossStatistics.from_masked_points(m.double(), proj.double(), ok)
    delta = umeyama_transform(stats)
    out = torch.cat([delta.rot, delta.trans, stats.n_meas[:, None]], 1).float()
    return Transform(rot=out[:, 0:4], trans=out[:, 4:7]), out[:, 7]


def batch_epilogue(t_best: Tensor, ref: Tensor, planes: Tensor, trans: Tensor, dirs: Tensor,
                   data_points: Tensor, data_mask: Tensor, slots: Tensor, max_dist: float,
                   t_max: float) -> Tuple[Transform, Tensor]:
    """Each pose's increment and pairs from K4's winners (module docstring).

    Raises on what the kernel does not take. CUDA tensors launch the kernel
    (once, no host sync); CPU tensors take :func:`batch_epilogue_reference`.
    ``batch_epilogue.launches`` counts the kernel launches."""
    check_epilogue_args(t_best, ref, planes, trans, dirs, data_points, data_mask, slots)
    dev = trans.device
    if dev.type == "cpu":
        return batch_epilogue_reference(t_best, ref, planes, trans, dirs, data_points, data_mask,
                                        slots, max_dist, t_max)
    if dev.type != "cuda":
        raise ValueError(f"batch_epilogue runs on cuda or cpu tensors, not {dev}")
    n, d = trans.shape[0], dirs.shape[0]
    out = torch.empty((n, OUT_WORDS), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_uint64 * 9)(*[x.data_ptr() for x in (
        t_best, ref, planes, trans, dirs, data_points, data_mask, slots, out)])
    with torch.cuda.device(dev):
        err = _kernel()(ptrs, n, d, float(max_dist), float(t_max),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"batch_epilogue kernel launch failed: cudaError {err}")
    batch_epilogue.launches += 1
    return Transform(rot=out[:, 0:4], trans=out[:, 4:7]), out[:, 7]


batch_epilogue.launches = 0
