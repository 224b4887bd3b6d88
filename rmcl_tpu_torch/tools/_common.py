"""Shared plumbing for the CLI tools."""

from __future__ import annotations

import argparse

import numpy as np

from rmcl_tpu_torch.convert import to_numpy as _np


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")


def load_map(path: str, bin_size: int = 64, bins_per_super: int = 64, device="cuda"):
    """The map file (any format of :func:`rmcl_tpu_torch.geom.mesh.load_mesh`)
    as a MeshMap on ``device``."""
    from rmcl_tpu_torch.geom.map import MeshMap

    return MeshMap.from_file(path, bin_size=bin_size, bins_per_super=bins_per_super,
                             device=device)


def load_config(path: str | None):
    from rmcl_tpu_torch.config.tree import ParamTree

    if path is None:
        return ParamTree()
    return ParamTree.from_yaml(path)


def save_track(path: str, stamps, poses) -> None:
    """Pose track NPZ: stamps (N,), trans (N, 3), rot (N, 4) wxyz."""
    np.savez_compressed(
        path,
        stamps=np.asarray(stamps, np.float64),
        trans=np.stack([_np(p.trans) for p in poses]),
        rot=np.stack([_np(p.rot) for p in poses]),
    )


def pose_tuple(vals, device="cuda"):
    from rmcl_tpu_torch.math.se3 import Transform

    return Transform.from_pose_tuple([float(v) for v in vals], device=device)
