"""Batched BVH ray casting: the exact engine, and the ray-hit record shared
by the ray engines.

Counterpart of ``rmcl_tpu.ops.raycast``. :func:`cast_rays` walks the
preorder-threaded BVH (:mod:`rmcl_tpu_torch.bvh.types`) with the K5 kernel
(:func:`rmcl_tpu_torch.ops.traverse_cuda.traverse_rays`), which gives each
ray's closest leaf slot. The rest stays torch ops after the kernel: one
int32 row gather of the winners, and the hit distance re-derived from the
winner's plane, so that gradients flow exactly through ray origins and
directions (the slot is discrete; it carries none).

``cast_rays_seeded`` waits for the MCL slice (it needs the dense engine's
lossless flags).
"""

from __future__ import annotations

import dataclasses

import torch

from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

Tensor = torch.Tensor

# t of a ray that hit nothing
NO_HIT_T = 3.0e38


@dataclasses.dataclass(frozen=True)
class RayHits:
    """SoA hit record for a batch of rays."""

    t: Tensor  # (...,) hit distance (NO_HIT_T when missed)
    hit: Tensor  # (...,) bool
    prim_id: Tensor  # (...,) int32 original face id (-1 when missed)
    inst_id: Tensor  # (...,) int32 instance id (-1 when missed)
    point: Tensor  # (..., 3) hit point in ray frame (orig + t*dir)
    normal: Tensor  # (..., 3) geometric unit normal


def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _flat(x, batch_shape, dev) -> Tensor:
    """A scalar or tensor broadcast to ``batch_shape``, flattened, float32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return x.broadcast_to(batch_shape).reshape(-1).contiguous()


def cast_rays(bvh: BVH, orig: Tensor, dirs: Tensor, t_min=0.0, t_max=NO_HIT_T,
              chunk_size: int = 262144, flip_normals: bool = True) -> RayHits:
    """Batch closest-hit query.

    orig, dirs: (..., 3), broadcastable ray origins and (unit) directions.
    Returns a RayHits with the same leading batch shape. ``t`` is
    differentiable with respect to ``orig`` and ``dirs``.

    The kernel walks every ray to its end in one launch, so the JAX
    version's ``rounds`` (a schedule of its lockstep loop that changes no
    result) has no counterpart here; ``chunk_size`` bounds the memory of the
    plain version on the CPU only."""
    dev = bvh.device
    orig = torch.as_tensor(orig, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    orig, dirs = torch.broadcast_tensors(orig, dirs)
    batch_shape = orig.shape[:-1]
    o = orig.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    lo = _flat(t_min, batch_shape, dev)
    hi = _flat(t_max, batch_shape, dev)

    o_k, d_k = o.detach().contiguous(), d.detach().contiguous()
    lo_k, hi_k = lo.detach(), hi.detach()
    if dev.type == "cpu":
        step = max(1, int(chunk_size))
        slot = torch.cat([traverse_rays(bvh.nodes, bvh.root_link, o_k[s:s + step],
                                        d_k[s:s + step], lo_k[s:s + step],
                                        hi_k[s:s + step])[1]
                          for s in range(0, n, step)]) if n else torch.empty(
            (0,), dtype=torch.int32)
    else:
        _, slot = traverse_rays(bvh.nodes, bvh.root_link, o_k, d_k, lo_k, hi_k)

    # differentiable re-derivation of the hit distance from the winner's plane
    hit = slot >= 0
    safe_slot = torch.where(hit, slot, 0).long()
    leaf_i = bvh.nodes.view(torch.int32)[safe_slot]  # (n, 16): an int32 row gather
    leaf = leaf_i[:, :12].contiguous().view(torch.float32)
    v0 = leaf[:, 0:3]
    normal = leaf[:, 9:12]
    prim_id = torch.where(hit, leaf_i[:, 12], -1)
    inst_id = torch.where(hit, leaf_i[:, 14], -1)

    denom = _dot3(normal, d)
    safe_denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    t_plane = _dot3(normal, v0 - o) / safe_denom
    t = torch.where(hit, t_plane, NO_HIT_T)
    point = torch.where(hit[:, None], o + t_plane[:, None] * d, 0.0)
    if flip_normals:
        # orient normals against the ray, so the signed point-to-plane
        # distance is well defined
        normal = normal * torch.where(denom > 0, -1.0, 1.0)[:, None]
    return RayHits(
        t=t.reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        prim_id=prim_id.reshape(batch_shape),
        inst_id=inst_id.reshape(batch_shape),
        point=point.reshape(batch_shape + (3,)),
        normal=torch.where(hit[:, None], normal, 0.0).reshape(batch_shape + (3,)),
    )


def cast_ranges(bvh: BVH, orig: Tensor, dirs: Tensor, t_min=0.0, t_max=NO_HIT_T,
                chunk_size: int = 262144) -> Tensor:
    """Differentiable range-only convenience wrapper (NO_HIT_T on miss)."""
    return cast_rays(bvh, orig, dirs, t_min, t_max, chunk_size=chunk_size).t


def occluded(bvh: BVH, orig: Tensor, target: Tensor, eps: float = 1e-3,
             chunk_size: int = 262144) -> Tensor:
    """Any-hit segment query: is the straight segment orig→target blocked?

    The motion update's mesh collision kill uses it. A segment no longer
    than 2 * eps has t_max <= t_min and visits nothing (the traversal's
    entry rule), so it is never blocked."""
    dev = bvh.device
    orig = torch.as_tensor(orig, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    seg = target - orig
    dist = torch.sqrt(torch.sum(seg * seg, dim=-1))
    d = seg / torch.clamp(dist, min=1e-12)[..., None]
    hits = cast_rays(bvh, orig, d, t_min=eps, t_max=torch.clamp(dist - eps, min=0.0),
                     chunk_size=chunk_size)
    return hits.hit
