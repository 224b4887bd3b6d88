"""Carry state across from arrays: the map's bins, its BVH, poses and scenes.

The system has no weights; its state is the map. These helpers build the
port's objects from plain numpy arrays — for example the fields of another
package's ``TriangleBins`` — so that two implementations can be run on the
identical packing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.builder import bvh_on_device
from rmcl_tpu_torch.bvh.types import BVH
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


def bvh_from_arrays(arrays: Dict[str, np.ndarray], device="cuda") -> BVH:
    """``BVH`` from its fields as numpy arrays (``nodes``, ``root_link``,
    ``aabb_min``, ``aabb_max``, ``n_tris``). The slot table's bits are
    copied as they are: its link and id words are int32 patterns that a
    float conversion could alter."""
    unknown = set(arrays) - {"nodes", "root_link", "aabb_min", "aabb_max", "n_tris"}
    if unknown:
        raise ValueError(f"unknown BVH fields {sorted(unknown)}")
    nodes = np.asarray(arrays["nodes"])
    if nodes.dtype != np.float32 or nodes.ndim != 2 or nodes.shape[1] != 16:
        raise ValueError(f"nodes must be (N, 16) float32, got {nodes.shape} {nodes.dtype}")
    return bvh_on_device(nodes, arrays["root_link"], arrays["aabb_min"], arrays["aabb_max"],
                         arrays["n_tris"], device=device)


def to_numpy(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, a numpy array or a sequence) as a
    numpy array, the way back from the port's objects to plain arrays."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def transform_from_arrays(rot: np.ndarray, trans: np.ndarray, device="cuda") -> Transform:
    """``Transform`` from a [w,x,y,z] quaternion array and a translation."""
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return Transform(rot=as_t(rot), trans=as_t(trans))


def particles_from_arrays(arrays: Dict[str, np.ndarray], device="cuda"):
    """``ParticleCloud`` from its fields as numpy arrays: ``rot`` (N, 4)
    [w,x,y,z], ``trans`` (N, 3), ``mean``, ``sigma``, ``n_meas`` (N,),
    ``state_sigma`` (N, 6) and ``alive`` (N,) — for example another
    package's cloud, so that both run from the identical particles."""
    from rmcl_tpu_torch.math.gaussian import Gaussian1D
    from rmcl_tpu_torch.mcl.particles import ParticleCloud

    fields = {"rot", "trans", "mean", "sigma", "n_meas", "state_sigma", "alive"}
    if set(arrays) != fields:
        raise ValueError(f"particle fields must be {sorted(fields)}, got {sorted(arrays)}")
    dev = resolve_device(device)
    f32 = lambda k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
    return ParticleCloud(
        poses=Transform(rot=f32("rot"), trans=f32("trans")),
        likelihood=Gaussian1D(mean=f32("mean"), sigma=f32("sigma"), n_meas=f32("n_meas")),
        state_sigma=f32("state_sigma"),
        alive=torch.from_numpy(np.array(arrays["alive"], dtype=bool)).to(dev),
    )


def scene_from_arrays(geometries: Mapping[str, Tuple[np.ndarray, np.ndarray]],
                      instances: Sequence[Mapping], device="cuda"):
    """``SceneGraph`` from numpy: ``geometries`` name -> (vertices (V, 3),
    faces (F, 3)); ``instances`` in order, each a mapping with ``geometry``,
    ``rot`` (4,) [w,x,y,z], ``trans`` (3,), ``scale`` and optionally
    ``name`` — for example another package's scene, so that both hold the
    identical instances. The poses live on ``device``."""
    from rmcl_tpu_torch.geom.mesh import TriangleMesh
    from rmcl_tpu_torch.geom.scene import SceneGraph

    scene = SceneGraph()
    for name, (vertices, faces) in geometries.items():
        scene.add_geometry(name, TriangleMesh(vertices, faces, name))
    for inst in instances:
        scene.add_instance(inst["geometry"],
                           transform_from_arrays(inst["rot"], inst["trans"], device=device),
                           scale=float(inst["scale"]), name=inst.get("name", ""))
    return scene
