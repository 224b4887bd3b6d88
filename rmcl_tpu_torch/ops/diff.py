"""Range queries differentiable with respect to the MESH VERTICES.

Counterpart of ``rmcl_tpu.ops.diff``. The ray engines re-derive the hit
distance from the winning triangle's plane, which makes ranges
differentiable with respect to ray origins and directions, but the plane
coefficients live in the acceleration structure built on the host, so no
gradient reaches the vertex array.

:func:`cast_rays_diff` closes that gap: the *discrete* winner (prim_id)
comes from a regular cast against any engine's structure (the kernels
launch as usual), then the hit is recomputed from the differentiable
``vertices`` tensor with torch ops:

    n  = normalize((v1 - v0) x (v2 - v0))
    t  = (n . v0 - n . o) / (n . d)

so autograd reaches ``vertices``, ``orig`` and ``dirs``. The winner is
frozen, which is exact wherever the hit topology is locally stable (away
from silhouette edges).
"""

from __future__ import annotations

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits, cast_rays

Tensor = torch.Tensor


def recompute_hits_from_vertices(prim_id: Tensor, hit: Tensor, vertices: Tensor, faces,
                                 orig: Tensor, dirs: Tensor,
                                 flip_normals: bool = True) -> RayHits:
    """Re-derive (t, point, normal) for known winners from ``vertices``
    (V, 3), which may require grad; ``faces`` (F, 3) integer."""
    dev = vertices.device
    batch_shape = tuple(prim_id.shape)
    o = torch.as_tensor(orig, dtype=torch.float32, device=dev).broadcast_to(batch_shape + (3,))
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev).broadcast_to(batch_shape + (3,))
    faces = torch.as_tensor(faces, device=dev).long()

    # a missed ray gathers some real face (every value it produces is
    # selected away): face k mod F for the k-th ray, not face 0 for all as
    # the JAX package does, so that the gradient's scatter-add does not pile
    # every missed ray onto one face's vertices (chip_smoke.py phase 14a on
    # an NVIDIA H100 80GB HBM3 at 700 W: 847 ms against a 10 ms forward cast
    # with 86% of 1.44M rays missing)
    spread = torch.arange(hit.numel(), device=dev).reshape(batch_shape) % faces.shape[0]
    safe = torch.where(hit, prim_id.long(), spread)
    tri = faces[safe]  # (..., 3)
    v0, v1, v2 = vertices[tri[..., 0]], vertices[tri[..., 1]], vertices[tri[..., 2]]

    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    # the 1e-30 floor and the safe denominator keep degenerate (padding)
    # triangles from putting a NaN into any gradient through the selects
    n = n * torch.rsqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True), min=1e-30))
    denom = torch.sum(n * d, dim=-1)
    safe_denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    t = torch.sum(n * (v0 - o), dim=-1) / safe_denom

    point = torch.where(hit[..., None], o + t[..., None] * d, 0.0)
    if flip_normals:
        n = n * torch.where(denom > 0, -1.0, 1.0)[..., None]
    return RayHits(
        t=torch.where(hit, t, NO_HIT_T),
        hit=hit,
        prim_id=prim_id,
        inst_id=torch.where(hit, 0, -1).to(torch.int32),
        point=point,
        normal=torch.where(hit[..., None], n, 0.0),
    )


def cast_rays_diff(struct, vertices: Tensor, faces, orig: Tensor, dirs: Tensor, t_min=0.0,
                   t_max=NO_HIT_T, flip_normals: bool = True, **engine_kw) -> RayHits:
    """Closest-hit query differentiable with respect to ``vertices`` (and
    the rays).

    ``struct`` is the acceleration structure built from (vertices, faces)
    and selects the engine: ``TriangleBins`` casts on the binned engine
    (:func:`~rmcl_tpu_torch.ops.raycast_binned.cast_rays_binned`, K3 + K1,
    or K2g with ``dir_groups``), a ``BVH`` on the exact engine
    (:func:`~rmcl_tpu_torch.ops.raycast.cast_rays`, K5); ``engine_kw`` go to
    that cast. The structure must match the vertices up to small
    perturbations: the winners come from the baked geometry, the values and
    gradients from the live one."""
    o = torch.as_tensor(orig, dtype=torch.float32, device=struct.device)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=struct.device)
    if isinstance(struct, TriangleBins):
        from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned

        base = cast_rays_binned(struct, o.detach(), d.detach(), t_min=t_min, t_max=t_max,
                                flip_normals=flip_normals, **engine_kw)
    else:
        base = cast_rays(struct, o.detach(), d.detach(), t_min=t_min, t_max=t_max,
                         flip_normals=flip_normals, **engine_kw)
    o, d = torch.broadcast_tensors(o, d)
    return recompute_hits_from_vertices(base.prim_id, base.hit, vertices, faces, o, d,
                                        flip_normals=flip_normals)
