"""Sharded differentiable range queries.

Counterpart of ``rmcl_tpu.parallel.diff_sharded``. The rays and their pose
assignment are split over the mesh's ``"rays"`` axis; the bins, vertices,
faces and pose translations are whole on every rank. Each rank casts its own
rays through :func:`~rmcl_tpu_torch.ops.diff.cast_rays_diff` (the winners
from the binned engine, K3 + K1, the hit re-derived from the live vertices),
takes its partial loss's gradient by autograd, and one packed all-reduce
sums the loss and the gradient together.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.ops.diff import cast_rays_diff
from rmcl_tpu_torch.parallel.mesh import RAY_AXIS, Mesh

Tensor = torch.Tensor


def sharded_range_value_and_grad(bins: TriangleBins, verts: Tensor, faces: Tensor,
                                 trans: Tensor, dirs: Tensor, pose_id: Tensor, mesh: Mesh,
                                 wrt: str = "pose", **cast_kw) -> Tuple[Tensor, Tensor]:
    """loss = sum over all ranks' rays of the hit range; returns (loss,
    grad), the gradient with respect to the pose translations ``trans``
    ((Np, 3), ``wrt="pose"``) or the vertices ``verts`` ((V, 3),
    ``wrt="verts"``), the same on every rank.

    ``dirs`` (r, 3) and ``pose_id`` (r,) are this rank's shard of the rays
    (ray i starts at ``trans[pose_id[i]]``); ``cast_kw`` go to the cast.
    Exactly one all-reduce an evaluation."""
    if wrt not in ("pose", "verts"):
        raise ValueError(f"wrt must be 'pose' or 'verts', got {wrt!r}")
    trans = trans.detach().requires_grad_(wrt == "pose")
    verts = verts.detach().requires_grad_(wrt == "verts")
    target = trans if wrt == "pose" else verts
    with torch.enable_grad():
        h = cast_rays_diff(bins, verts, faces, trans[pose_id.long()], dirs, **cast_kw)
        loss = torch.sum(torch.where(h.hit, h.t, 0.0))
        (grad,) = torch.autograd.grad(loss, [target], allow_unused=True)
    if grad is None:  # no ray of this rank reaches the target
        grad = torch.zeros_like(target)
    packed = mesh.psum(torch.cat([loss.detach().reshape(1), grad.reshape(-1)]), RAY_AXIS)
    return packed[0], packed[1:].reshape(grad.shape)
