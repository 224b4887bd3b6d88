"""Carry state across from arrays: the map's bins and poses.

The system has no weights; its state is the map. These helpers build the
port's objects from plain numpy arrays — for example the fields of another
package's ``TriangleBins`` — so that two implementations can be run on the
identical packing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.se3 import Transform

_BIN_FIELDS = ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
               "mid_aabb", "hyper_aabb")


def bins_from_arrays(arrays: Dict[str, Optional[np.ndarray]], *, bins_per_super: int,
                     bins_per_mid: int, supers_per_hyper: int,
                     device="cuda") -> TriangleBins:
    """``TriangleBins`` from its fields as numpy arrays (``mid_aabb`` and
    ``hyper_aabb`` may be None or absent)."""
    dev = resolve_device(device)
    unknown = set(arrays) - set(_BIN_FIELDS)
    if unknown:
        raise ValueError(f"unknown TriangleBins fields {sorted(unknown)}")
    put = lambda a: None if a is None else torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev)
    return TriangleBins(
        **{k: put(arrays.get(k)) for k in _BIN_FIELDS},
        bins_per_super=int(bins_per_super),
        bins_per_mid=int(bins_per_mid),
        supers_per_hyper=int(supers_per_hyper),
    )


def transform_from_arrays(rot: np.ndarray, trans: np.ndarray, device="cuda") -> Transform:
    """``Transform`` from a [w,x,y,z] quaternion array and a translation."""
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return Transform(rot=as_t(rot), trans=as_t(trans))
