"""Batched BVH ray casting: the exact engine, and the ray-hit record shared
by the ray engines.

Counterpart of ``rmcl_tpu.ops.raycast``. :func:`cast_rays` walks the
preorder-threaded BVH (:mod:`rmcl_tpu_torch.bvh.types`) with the K5 kernel
(:func:`rmcl_tpu_torch.ops.traverse_cuda.traverse_rays`), which gives each
ray's closest leaf slot. The rest stays torch ops after the kernel: one
int32 row gather of the winners, and the hit distance re-derived from the
winner's plane, so that gradients flow exactly through ray origins and
directions (the slot is discrete; it carries none).

:func:`cast_rays_seeded` is the exact query with a dense seed: the binned
engine (K3 + K1) certifies the rays whose blocks no budget truncated, and
only the others walk the BVH (K5), primed with the seed's hit.
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


def _map_hits(fn, hits: RayHits) -> RayHits:
    """``fn`` applied to every field of a hit record."""
    return RayHits(**{f.name: fn(getattr(hits, f.name)) for f in dataclasses.fields(hits)})


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


def cast_rays_seeded(bvh: BVH, bins, orig: Tensor, dirs: Tensor, t_min=0.0, t_max=NO_HIT_T,
                     chunk_size: int = 262144, flip_normals: bool = True,
                     block_size: int = 128, c_super: int = 24, c_bin: int = 96,
                     c_mid: int = 0, c_hyper: int = 0, sub_blocks: int = 4,
                     sort: bool = True) -> RayHits:
    """Exact closest-hit query with a dense-engine seed pass (trust or
    refine).

    The dense engine is exact for every ray whose block's candidate budgets
    truncated nothing, so the seed pass runs with ``with_lossless=True``
    and certified rays keep its result: their traversal bound is -1, and
    the walk's entry rule (t_max <= t_min visits nothing) skips them. A
    suspect ray walks the BVH with t_max at the seed's hit inflated by
    1e-5 relative + 1e-6 (a dense hit is a real intersection, so an upper
    bound on the closest t), or at its own t_max when the seed missed; a
    per-ray fallback takes the seed's record where the walk found nothing
    (a grazing hit whose traversal t passes the inflated bound).

    ``sort`` orders the rays by bound before the walk and puts them back
    after: on the card the certified rays fill warps that exit at once. It
    changes no result. ``bins`` is the map's TriangleBins on the BVH's
    device."""
    from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned

    dev = bvh.device
    orig = torch.as_tensor(orig, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    orig, dirs = torch.broadcast_tensors(orig, dirs)
    batch_shape = orig.shape[:-1]
    o = orig.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    lo = _flat(t_min, batch_shape, dev)
    hi = _flat(t_max, batch_shape, dev)
    seed, lossless = cast_rays_binned(
        bins, o, d, t_min=lo, t_max=hi, block_size=block_size, flip_normals=flip_normals,
        c_super=c_super, c_bin=c_bin, c_mid=c_mid, c_hyper=c_hyper, with_lossless=True,
        sub_blocks=sub_blocks)
    bound = torch.where(seed.hit, seed.t * (1.0 + 1e-5) + 1e-6, hi)
    bound = torch.minimum(bound, hi)
    bound = torch.where(lossless, -1.0, bound)
    if sort:
        order = torch.argsort(bound, stable=True)
        out = cast_rays(bvh, o[order], d[order], t_min=lo[order], t_max=bound[order],
                        chunk_size=chunk_size, flip_normals=flip_normals)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=dev)
        out = _map_hits(lambda x: x[inv], out)
    else:
        out = cast_rays(bvh, o, d, t_min=lo, t_max=bound, chunk_size=chunk_size,
                        flip_normals=flip_normals)
    # the seed's hit is a real surface intersection: never report a miss
    # that the unseeded walk would not have reported
    fb = seed.hit & ~out.hit
    pick = lambda a, b: torch.where(fb if a.dim() == 1 else fb[:, None], a, b)
    out = RayHits(t=pick(seed.t, out.t), hit=out.hit | seed.hit,
                  prim_id=pick(seed.prim_id, out.prim_id),
                  inst_id=pick(seed.inst_id, out.inst_id),
                  point=pick(seed.point, out.point), normal=pick(seed.normal, out.normal))
    return _map_hits(lambda x: x.reshape(batch_shape + tuple(x.shape[1:])), out)


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
