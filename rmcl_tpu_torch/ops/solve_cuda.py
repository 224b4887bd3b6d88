"""MICP-L's point-to-plane Gauss-Newton loop, unsharded, as one hand-written
CUDA kernel.

``p2l_gauss_newton`` is the optimisation half of a correction over fixed
correspondences (:func:`rmcl_tpu_torch.micp.pipeline.correct_from_correspondences`
with ``mesh`` None and ``solver="p2l_gn"``). It replaces no Pallas kernel:
the JAX package runs the same loop as XLA-fused code inside one jitted
program, ``rmcl_tpu/micp/pipeline.py::correct_once_jit``
(``correct_from_correspondences`` :349-548). The kernel source is
``rmcl_tpu_torch/csrc/p2l_gauss_newton.cu``; its header says what bounds it
on the card and what the design does about it. One launch a correction,
and no host sync. Its plain version is the pipeline's torch loop,
``rmcl_tpu_torch/micp/pipeline.py::_correct_torch``, which runs every other
case (CPU tensors, the sharded path, the Umeyama solver).

Contract: ``sensors``, each with ``points (N_s, 3)`` float32 (sensor
frame), ``mask (N_s,)`` bool, ``tsb`` (a Transform, rotation ``(4,)``,
translation ``(3,)``) and ``config`` (``max_dist``,
``adaptive_max_dist_min``, ``weight``); ``corrs``, each with
``model_points`` and ``model_normals (N_s, 3)`` float32 and ``found
(N_s,)`` bool; ``tom`` and ``tbo`` Transforms; ``convergence_progress ()``
float32; ``config`` with ``optimization_iterations``,
``adaptive_max_dist``, ``disable_correction`` and ``gn_damping``. Returns
``(12,)`` float32: the new ``tom``'s rotation and translation, then the
total and valid measurements, the valid matches, the covariance trace and
the convergence progress (:data:`OUT_SLICES`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.math.se3 import Transform

Tensor = torch.Tensor

# the output's fields, by position
OUT_SLICES = {"rot": slice(0, 4), "trans": slice(4, 7), "total_measurements": 7,
              "valid_measurements": 8, "valid_matches": 9, "covariance_trace": 10,
              "convergence_progress": 11}
OUT_WORDS = 12
# the kernel's limits and layout (csrc/p2l_gauss_newton.cu: kMaxSensors,
# kCluster)
MAX_SENSORS = 32
_CLUSTER = 8
_MAX_ROWS = (2 ** 31 - 1) // 3  # int32 word offsets into an (N, 3) array


@functools.lru_cache(maxsize=None)
def _library():
    return _build.load_library("p2l_gauss_newton")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_p2l_gauss_newton``), built on first use."""
    fn = _library().rmcl_p2l_gauss_newton
    u64, i32 = ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
    fn.argtypes = [u64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), i32, u64,
                   i32, i32, i32, ctypes.c_float, i32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) and static shared bytes a CTA of the kernel as built, by
    ``cudaFuncGetAttributes``: ``{"GN": (regs, local, static_shared)}``.
    Needs a card."""
    fn = _library().rmcl_p2l_gauss_newton_attrs
    fn.argtypes = [ctypes.c_void_p] * 3
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if fn(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)):
        raise RuntimeError("cudaFuncGetAttributes failed for the Gauss-Newton kernel")
    return {"GN": (regs.value, local.value, smem.value)}


def _check(dev, name: str, x, dtype, shape, contiguous: bool = True):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, tom on {dev}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_p2l_args(sensors, corrs, tom: Transform, tbo: Transform,
                   convergence_progress: Tensor) -> None:
    """Raise on what the kernel does not take: a dtype, a shape, a device
    or, for the per-pair arrays, a layout other than the contract's (the
    pose vectors may be strided views: the wrapper packs them). Reads only
    dtypes, shapes, devices and strides, so it runs on any tensors."""
    dev = tom.trans.device
    if len(sensors) != len(corrs):
        raise ValueError(f"{len(sensors)} sensors but {len(corrs)} correspondence sets")
    if len(sensors) > MAX_SENSORS:
        raise ValueError(f"the kernel takes at most {MAX_SENSORS} sensors, got {len(sensors)}")
    poses = {"tom": tom, "tbo": tbo}
    for k, (s, c) in enumerate(zip(sensors, corrs)):
        n = s.points.shape[0] if s.points.dim() else -1
        if n > _MAX_ROWS:
            raise ValueError(f"points[{k}] has {n} rows, the kernel takes at most {_MAX_ROWS}")
        for name, x, dtype, shape in (
                ("points", s.points, torch.float32, (n, 3)),
                ("mask", s.mask, torch.bool, (n,)),
                ("model_points", c.model_points, torch.float32, (n, 3)),
                ("model_normals", c.model_normals, torch.float32, (n, 3)),
                ("found", c.found, torch.bool, (n,))):
            _check(dev, f"{name}[{k}]", x, dtype, shape)
        poses[f"tsb[{k}]"] = s.tsb
    for name, t in poses.items():
        _check(dev, f"{name}.rot", t.rot, torch.float32, (4,), contiguous=False)
        _check(dev, f"{name}.trans", t.trans, torch.float32, (3,), contiguous=False)
    _check(dev, "convergence_progress", convergence_progress, torch.float32, ())


def _launch(sensors, corrs, tom: Transform, tbo: Transform, progress: Tensor, config,
            out: Tensor) -> int:
    """One launch on ``out``'s device and current stream; the cudaError_t."""
    dense = lambda t: (t.rot.contiguous(), t.trans.contiguous())  # noqa: E731
    tsbs = [dense(s.tsb) for s in sensors]
    (tbo_r, tbo_t), (tom_r, tom_t) = dense(tbo), dense(tom)
    S = len(sensors)
    ptrs = (ctypes.c_uint64 * (7 * S))(*[
        x.data_ptr() for s, c, (r, t) in zip(sensors, corrs, tsbs)
        for x in (s.points, c.model_points, c.model_normals, s.mask, c.found, r, t)])
    counts = (ctypes.c_int * S)(*[int(s.points.shape[0]) for s in sensors])
    cfg = (ctypes.c_float * (3 * S))(*[
        v for s in sensors
        for v in (s.config.max_dist, s.config.adaptive_max_dist_min, s.config.weight)])
    poses = (ctypes.c_uint64 * 6)(tbo_r.data_ptr(), tbo_t.data_ptr(), tom_r.data_ptr(),
                                  tom_t.data_ptr(), progress.data_ptr(), out.data_ptr())
    chunk = -(-sum(counts) // _CLUSTER)  # the cluster's CTAs split the pairs evenly
    dev = out.device
    with torch.cuda.device(dev):
        return _kernel()(ptrs, counts, cfg, S, poses, int(config.optimization_iterations),
                         int(bool(config.adaptive_max_dist)), int(bool(config.disable_correction)),
                         float(config.gn_damping), chunk,
                         torch.cuda.current_stream(dev).cuda_stream)


def p2l_gauss_newton(sensors: Sequence, corrs: Sequence, tom: Transform, tbo: Transform,
                     convergence_progress: Tensor, config) -> Tensor:
    """K damped point-to-plane Gauss-Newton iterations over fixed
    correspondences, the statistics, the guard and the progress, packed
    into one ``(12,)`` tensor (module docstring): one kernel launch on CUDA
    tensors. Raises on what the kernel does not take, CPU tensors
    included. ``p2l_gauss_newton.launches`` counts the launches."""
    dev = tom.trans.device
    if dev.type != "cuda":
        raise ValueError(f"p2l_gauss_newton launches a CUDA kernel, got tensors on {dev}")
    check_p2l_args(sensors, corrs, tom, tbo, convergence_progress)
    out = torch.empty((OUT_WORDS,), dtype=torch.float32, device=dev)
    err = _launch(sensors, corrs, tom, tbo, convergence_progress, config, out)
    if err:
        raise RuntimeError(f"p2l_gauss_newton kernel launch failed: cudaError {err}")
    p2l_gauss_newton.launches += 1
    return out


p2l_gauss_newton.launches = 0
