"""Build and load the port's CUDA kernels (and, through
:func:`compile_once`, its native host library).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/rmcl_tpu_torch/<name>-<hash>.so``
next to the package, and loaded with ctypes. The file name carries a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is never served a stale library. Nothing is built at import: the first launch on a CUDA tensor
builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rmcl_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # products and sums round like the plain PyTorch versions (no FMA
    # contraction), so kernel and plain version pick the same winners
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def hashed_path(out_dir: Path, stem: str, *parts: bytes) -> Path:
    """``out_dir/<stem>-<hash>.so``, the hash of ``parts`` (the source, the
    headers it includes, the flags): an edited source is never served a
    stale library."""
    return out_dir / f"{stem}-{hashlib.sha256(b''.join(parts)).hexdigest()[:16]}.so"


def compile_once(out: Path, cmd: "list[str]", source: Path) -> Path:
    """``out``, compiled by ``cmd -o out source`` unless it exists already
    (a temporary file of this process, then an atomic rename: a concurrent
    loader never sees half a file). Raises RuntimeError with the compiler's
    output where it fails."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {source.name} (exit "
                           f"{proc.returncode}):\n" + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library_path(name: str) -> Path:
    # the shared headers too: an edited header must not be served a stale library
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return hashed_path(BUILD_DIR, name, (CSRC / f"{name}.cu").read_bytes(), headers,
                       " ".join(NVCC_FLAGS).encode())


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` as a loaded shared library (compiled on first use)."""
    return ctypes.CDLL(str(compile_once(library_path(name), [_nvcc(), *NVCC_FLAGS],
                                        CSRC / f"{name}.cu")))
