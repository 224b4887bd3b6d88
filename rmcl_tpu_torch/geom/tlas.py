"""Two-level scene instancing (TLAS).

Counterpart of ``rmcl_tpu.geom.tlas``. The instances stay apart: every
geometry's bins and BVH are built once in its local frame and shared by its
instances, and a query loops over the instances:

    for each instance:
        rays -> instance frame (one batched rigid transform and 1/scale)
        closest hit against the geometry's bins (K3 + K1)
        running min-merge of (t, payload)

Each cast is seeded with ``t_max = best t so far``, so the cull drops the
blocks and bins that cannot beat it: the chained casts act as a top-level
traversal. The instance poses can change every call with no rebuild (the
flattened :class:`rmcl_tpu_torch.geom.scene.SceneAccel` bakes world-space
triangles instead). Hit ``t`` is re-derived from the winner's plane in the
instance frame, so it is differentiable with respect to the rays and, passed
as ``poses``/``scales``, the instance poses and scales.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import TriangleBins, build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.geom.scene import SceneGraph
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops.closest_point import ClosestPoints, closest_points
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits, _flat
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned

Tensor = torch.Tensor


@dataclasses.dataclass
class SceneTLAS:
    """Built two-level scene: per-geometry accelerators + instance table."""

    scene: SceneGraph
    geom_bins: Dict[str, TriangleBins]  # local-frame bins per geometry
    geom_bvh: Dict[str, BVH]  # local-frame BVH (closest-point queries)
    inst_geom: List[str]  # geometry name per instance
    poses: Transform  # (n_inst,) world pose per instance
    scales: Tensor  # (n_inst,) uniform scale per instance

    @property
    def n_instances(self) -> int:
        return len(self.inst_geom)

    @property
    def device(self) -> torch.device:
        return self.scales.device


def build_tlas(scene: SceneGraph, bin_size: int = 32, bins_per_super: int = 64,
               device="cuda") -> SceneTLAS:
    """Per-geometry accelerators on ``device`` (instances share their
    geometry's bins and BVH) + the instance pose table."""
    dev = resolve_device(device)
    used = sorted({i.geometry for i in scene.instances})
    geom_bins = {g: build_bins(scene.geometries[g], bin_size=bin_size,
                               bins_per_super=bins_per_super, device=dev) for g in used}
    geom_bvh = {g: build_bvh(scene.geometries[g], device=dev) for g in used}
    table = scene.instance_pose_table()
    return SceneTLAS(
        scene=scene,
        geom_bins=geom_bins,
        geom_bvh=geom_bvh,
        inst_geom=[i.geometry for i in scene.instances],
        poses=Transform(rot=table.rot.to(dev), trans=table.trans.to(dev)),
        scales=torch.tensor([i.scale for i in scene.instances], dtype=torch.float32,
                            device=dev),
    )


def _inst_pose(tlas: SceneTLAS, poses: Optional[Transform], i: int) -> Transform:
    p = tlas.poses if poses is None else poses
    return Transform(rot=p.rot[i], trans=p.trans[i])


def cast_rays_tlas(tlas: SceneTLAS, orig: Tensor, dirs: Tensor, t_min=0.0, t_max=NO_HIT_T,
                   poses: Optional[Transform] = None, scales: Optional[Tensor] = None,
                   flip_normals: bool = True, **cast_kw) -> RayHits:
    """Closest hit against all instances (a drop-in for cast_rays_binned;
    ``cast_kw`` go to every instance's cast).

    ``poses``/``scales`` override the build-time instance table (same
    leading n_instances dim): pass current estimates for moving scenes, or
    tensors that require grad for instance-pose refinement. Parametric
    ``t`` is kept across instance frames (directions are mapped by the
    inverse rigid transform and 1/scale, never renormalised), so
    ``t_min``/``t_max`` and the returned ``t`` mean what they mean in a
    world-frame cast."""
    dev = tlas.device
    orig, dirs = torch.broadcast_tensors(torch.as_tensor(orig, dtype=torch.float32, device=dev),
                                         torch.as_tensor(dirs, dtype=torch.float32, device=dev))
    batch_shape = tuple(orig.shape[:-1])
    o = orig.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    sc = tlas.scales if scales is None else scales

    t_best = _flat(t_max, batch_shape, dev)
    t_min_r = _flat(t_min, batch_shape, dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    normal = o.new_zeros((n, 3))
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)

    for i, gname in enumerate(tlas.inst_geom):
        pose = _inst_pose(tlas, poses, i)
        inv = pose.inverse()
        s = sc[i]
        # x_w = R (s x_l) + t  =>  o_l = R^-1 (o_w - t) / s, d_l = R^-1 d_w / s
        h = cast_rays_binned(tlas.geom_bins[gname], inv.apply(o) / s, inv.rotate(d) / s,
                             t_min=t_min_r,
                             # chained: only closer-than-best hits survive; the
                             # bound picks winners and carries no gradient
                             t_max=t_best.detach(), flip_normals=flip_normals, **cast_kw)
        better = h.hit & (h.t < t_best)
        t_best = torch.where(better, h.t, t_best)
        normal = torch.where(better[:, None], pose.rotate(h.normal), normal)
        prim = torch.where(better, h.prim_id, prim)
        inst = torch.where(better, i, inst)
        hit = hit | better

    point = torch.where(hit[:, None], o + t_best[:, None] * d, 0.0)
    t_out = torch.where(hit, t_best, NO_HIT_T)
    return RayHits(
        t=t_out.reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        prim_id=prim.reshape(batch_shape),
        inst_id=inst.reshape(batch_shape),
        point=point.reshape(batch_shape + (3,)),
        normal=torch.where(hit[:, None], normal, 0.0).reshape(batch_shape + (3,)),
    )


def closest_points_tlas(tlas: SceneTLAS, queries: Tensor, max_dist=3.0e38,
                        poses: Optional[Transform] = None,
                        scales: Optional[Tensor] = None) -> Tuple[ClosestPoints, Tensor]:
    """Closest surface point over all instances. Returns (ClosestPoints,
    inst_id); inst_id is -1 where nothing is within ``max_dist``.

    Chained like the ray cast: each instance's query (K6 on its geometry's
    BVH) is bounded by the best distance so far, so far-away instances prune
    at once. The surface point is found in the instance frame; its world
    position and distance follow the instance's pose and scale (the walk
    itself carries no gradient)."""
    dev = tlas.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    batch_shape = tuple(queries.shape[:-1])
    q = queries.reshape(-1, 3)
    n = q.shape[0]
    sc = tlas.scales if scales is None else scales

    best = _flat(max_dist, batch_shape, dev)
    point = q.new_zeros((n, 3))
    normal = q.new_zeros((n, 3))
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)

    for i, gname in enumerate(tlas.inst_geom):
        pose = _inst_pose(tlas, poses, i)
        s = sc[i]
        q_l = pose.inverse().apply(q) / s
        cp = closest_points(tlas.geom_bvh[gname], q_l.detach(), max_dist=(best / s).detach())
        d_w = cp.dist * s
        better = cp.found & (d_w < best)
        best = torch.where(better, d_w, best)
        point = torch.where(better[:, None], pose.apply(cp.point * s), point)
        normal = torch.where(better[:, None], pose.rotate(cp.normal), normal)
        prim = torch.where(better, cp.prim_id, prim)
        inst = torch.where(better, i, inst)
        found = found | better

    return (
        ClosestPoints(
            point=point.reshape(batch_shape + (3,)),
            normal=normal.reshape(batch_shape + (3,)),
            dist=torch.where(found, best, 3.0e38).reshape(batch_shape),
            prim_id=prim.reshape(batch_shape),
            found=found.reshape(batch_shape),
        ),
        inst.reshape(batch_shape),
    )
