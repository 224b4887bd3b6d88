"""Geometric scene graphs: instanced meshes with per-instance transforms.

Counterpart of ``rmcl_tpu.geom.scene``. The scene is *flattened* at build
time: every instance's triangles are transformed into world space and
concatenated, with ``inst_id``/``prim_id`` written into the acceleration
structures, so queries run the single-mesh engines unchanged (the bins on
K3 + K1, the BVH on K5 and K6). :mod:`rmcl_tpu_torch.geom.tlas` keeps the
instances apart instead (one cast per instance, poses that move without a
rebuild).

:func:`refine_instance_pose` fits one instance's pose to measured ranges by
damped Newton steps on the plane-equation ranges, with the gradient and
Hessian from ``torch.func``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import TriangleBins, build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.geom.mesh import TriangleMesh
from rmcl_tpu_torch.math.se3 import Quaternion, Transform, transform_stack

Tensor = torch.Tensor


@dataclasses.dataclass
class Instance:
    """One placed mesh: geometry reference + world pose (+ scale)."""

    geometry: str
    pose: Transform
    scale: float = 1.0
    name: str = ""


@dataclasses.dataclass
class SceneGraph:
    """Named geometries + instance list (host-side)."""

    geometries: Dict[str, TriangleMesh] = dataclasses.field(default_factory=dict)
    instances: List[Instance] = dataclasses.field(default_factory=list)

    def add_geometry(self, name: str, mesh: TriangleMesh) -> None:
        self.geometries[name] = mesh

    def add_instance(self, geometry: str, pose: Transform, scale: float = 1.0,
                     name: str = "") -> int:
        if geometry not in self.geometries:
            raise KeyError(f"unknown geometry '{geometry}'")
        self.instances.append(Instance(geometry, pose, scale, name))
        return len(self.instances) - 1

    def instance_pose_table(self) -> Transform:
        """Stacked (n_instances,) pose batch, shared by the flattened-scene
        and TLAS paths."""
        return transform_stack([i.pose for i in self.instances])

    def flatten(self) -> Tuple[TriangleMesh, np.ndarray, np.ndarray]:
        """World-space triangle soup + per-face (prim_id, inst_id).

        prim_id = face index within the instance's GEOMETRY (hits map back
        to source-mesh faces); inst_id = index into ``self.instances``. The
        rotation matrix comes from the pose's quaternion in float32 torch
        ops, the transform itself in numpy."""
        verts_out, faces_out, prim_ids, inst_ids = [], [], [], []
        v_off = 0
        for ii, inst in enumerate(self.instances):
            g = self.geometries[inst.geometry]
            R = Quaternion.to_matrix(inst.pose.rot.detach()).cpu().numpy()
            t = inst.pose.trans.detach().cpu().numpy()
            verts = (g.vertices * inst.scale) @ R.T + t
            verts_out.append(verts.astype(np.float32))
            faces_out.append(g.faces + v_off)
            prim_ids.append(np.arange(g.n_faces, dtype=np.int32))
            inst_ids.append(np.full(g.n_faces, ii, np.int32))
            v_off += g.n_vertices
        mesh = TriangleMesh(np.concatenate(verts_out), np.concatenate(faces_out), "scene")
        return mesh, np.concatenate(prim_ids), np.concatenate(inst_ids)

    def build(self, bin_size: int = 64, bins_per_super: int = 64,
              device="cuda") -> "SceneAccel":
        """The flattened scene's BVH and bins on ``device``."""
        resolve_device(device)  # refuse a missing card before the host build
        mesh, prim_ids, inst_ids = self.flatten()
        return SceneAccel(
            scene=self,
            world_mesh=mesh,
            bvh=build_bvh(mesh, prim_ids=prim_ids, inst_ids=inst_ids, device=device),
            bins=build_bins(mesh, bin_size=bin_size, bins_per_super=bins_per_super,
                            prim_ids=prim_ids, inst_ids=inst_ids, device=device),
        )


@dataclasses.dataclass
class SceneAccel:
    """Built scene: world mesh + acceleration structures with instance ids."""

    scene: SceneGraph
    world_mesh: TriangleMesh
    bvh: BVH
    bins: TriangleBins

    def instance_poses(self) -> Transform:
        return self.scene.instance_pose_table()


def refine_instance_pose(accel: SceneAccel, inst_id: int, orig: Tensor, dirs: Tensor,
                         measured_ranges: Tensor, steps: int = 8,
                         damping: float = 1e-3) -> Tuple[Transform, Tensor]:
    """Gradient-based pose refinement of one instance through hit distances.

    Iterates { cast the rays against the instance at the current pose
    estimate (K5 on a BVH of the instance's geometry, built on the scene's
    device), linearise the plane-equation ranges in the 6 pose parameters,
    damped Newton step }. The rays move into the instance frame instead of
    the scene being rebuilt, so each step is one cast. Returns (delta_pose,
    to apply as ``delta @ instance.pose``; the per-step losses)."""
    from rmcl_tpu_torch.ops.raycast import cast_rays

    dev = accel.bvh.device
    inst = accel.scene.instances[inst_id]
    geom = accel.scene.geometries[inst.geometry]
    if inst.scale != 1.0:
        geom = TriangleMesh(geom.vertices * inst.scale, geom.faces)
    local_bvh = build_bvh(geom, device=dev)

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).detach()
    orig, dirs, measured_ranges = f32(orig), f32(dirs), f32(measured_ranges)
    start = Transform(rot=f32(inst.pose.rot), trans=f32(inst.pose.trans))
    pose = start
    valid_meas = measured_ranges < 1e30
    zeros6 = torch.zeros(6, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    losses = []
    for _ in range(steps):
        inv = pose.inverse()
        hits = cast_rays(local_bvh, inv.apply(orig), inv.rotate(dirs))
        # world-frame plane of each hit
        n_w = pose.rotate(hits.normal)
        p_w = pose.apply(hits.point)
        denom0 = torch.sum(n_w * dirs, dim=-1)
        mask = hits.hit & valid_meas & (torch.abs(denom0) > 0.2)
        n_eff = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)

        def loss_fn(delta6):
            dq = Quaternion.exp(delta6[3:])
            n_d = Quaternion.rotate(dq, n_w)
            p_d = Quaternion.rotate(dq, p_w) + delta6[:3]
            denom = torch.sum(n_d * dirs, dim=-1)
            safe = torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
            t = torch.sum(n_d * (p_d - orig), dim=-1) / safe
            r = torch.where(mask, t - measured_ranges, 0.0)
            r = torch.clamp(r, -2.0, 2.0)
            return torch.sum(r * r) / n_eff

        g, val = torch.func.grad_and_value(loss_fn)(zeros6)
        H = torch.func.hessian(loss_fn)(zeros6)
        H = H + damping * eye6 * torch.clamp(torch.trace(H), min=1.0)
        step = -torch.linalg.solve(H, g)
        delta = Transform(rot=Quaternion.exp(step[3:]), trans=step[:3])
        pose = (delta @ pose).normalized()
        losses.append(val)

    return pose @ start.inverse(), torch.stack(losses)
