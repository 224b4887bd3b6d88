"""ctypes bindings for the native host builders (``builder.cpp``): the kd
median bin order and the binned-SAH BVH.

Counterpart of ``rmcl_tpu.bvh.native``; ``builder.cpp`` is a byte-for-byte
copy of that package's source. At first use ``g++`` compiles it with the
JAX package's ``Makefile`` flags into the git-ignored
``build/rmcl_tpu_torch/native/`` next to the package (the file name carries
a hash of the source and the flags, so an edited source is never served a
stale library). Nothing is built at import. Where the build fails (no
``g++``), :func:`available` is False and the callers take their numpy
paths, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from rmcl_tpu_torch._build import compile_once, hashed_path

SOURCE = Path(__file__).resolve().parent / "builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "rmcl_tpu_torch" / "native"
# the JAX package's Makefile (rmcl_tpu/bvh/native/Makefile)
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared"]


def library_path() -> Path:
    return hashed_path(BUILD_DIR, "librmcl_native", SOURCE.read_bytes(),
                       " ".join(CXX_FLAGS).encode())


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, "") once built and loaded, else (None, why not)."""
    try:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) on PATH")
        lib = ctypes.CDLL(str(compile_once(library_path(), [cxx, *CXX_FLAGS], SOURCE)))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return None, str(e)
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.rmcl_build_bvh_sah.restype = ctypes.c_int
    lib.rmcl_build_bvh_sah.argtypes = [f32, ctypes.c_int32, i32, ctypes.c_int32, f32, i32, i32,
                                       f32]
    lib.rmcl_bin_order.restype = ctypes.c_int
    lib.rmcl_bin_order.argtypes = [f32, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_int64)]
    return lib, ""


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None where it cannot be built."""
    return _load()[0]


def available() -> bool:
    return load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False ("" when it is True)."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native builder library unavailable: {unavailable_reason()}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_bvh_sah_arrays(vertices: np.ndarray, faces: np.ndarray
                         ) -> Tuple[np.ndarray, np.int32, np.ndarray, np.ndarray]:
    """Run the native binned-SAH builder. Returns (nodes (2T-1, 16) f32,
    root_link, leaf_order (T,) i32, scene_aabb (6,) f32). Raises if the
    library is unavailable."""
    lib = _lib()
    verts = np.ascontiguousarray(vertices, np.float32)
    fcs = np.ascontiguousarray(faces, np.int32)
    T = len(fcs)
    nodes = np.zeros((max(2 * T - 1, 1), 16), np.float32)
    leaf_order = np.zeros(T, np.int32)
    root = np.zeros(1, np.int32)
    aabb = np.zeros(6, np.float32)
    rc = lib.rmcl_build_bvh_sah(_ptr(verts, ctypes.c_float), np.int32(len(verts)),
                                _ptr(fcs, ctypes.c_int32), np.int32(T),
                                _ptr(nodes, ctypes.c_float), _ptr(root, ctypes.c_int32),
                                _ptr(leaf_order, ctypes.c_int32), _ptr(aabb, ctypes.c_float))
    if rc != 0:
        raise RuntimeError(f"native builder failed with code {rc}")
    return nodes, np.int32(root[0]), leaf_order, aabb


def bin_order(centroids: np.ndarray, bin_size: int) -> np.ndarray:
    """Native kd median-split bin order (the numpy version's splits, ties
    broken by ``std::nth_element``). Raises if the library is unavailable."""
    lib = _lib()
    c = np.ascontiguousarray(centroids, np.float32)
    out = np.empty(c.shape[0], np.int64)
    rc = lib.rmcl_bin_order(_ptr(c, ctypes.c_float), np.int64(c.shape[0]), np.int32(bin_size),
                            _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native bin_order failed with code {rc}")
    return out
