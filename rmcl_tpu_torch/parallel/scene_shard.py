"""Spatially partitioned scenes across ranks.

Counterpart of ``rmcl_tpu.parallel.scene_shard``: each rank of the mesh's
``"scene"`` axis owns a spatially compact shard of the triangle bins and
casts its rays against that shard only; the per-ray winners are then
elected across the scene axis. The shards are contiguous super ranges of the
kd bin order (spatially compact by construction), padded to equal sizes with
sentinel boxes that no slab or cone test passes.

The election (:func:`_elect_and_broadcast`) packs the shard id into the low
mantissa bits of the positive hit distance, so that one integer ``pmin``
finds the nearest hit and a unique owner (ties to the lower shard), and the
owner's payload (hit, t, point, normal, prim and instance ids) travels as
int32 bit patterns in one all-reduce sum to which every other shard adds
zeros: two collectives a cast, where the JAX package spends one ``pmin``
and six ``psum``s. Every bit of the winner's payload arrives unchanged (a
-0.0 normal component included, which JAX's float sum turns into +0.0).

On a 2-D ``("rays", "scene")`` mesh the rays are split over ``"rays"`` and
each rank passes its ray shard; on a 1-D ``("scene",)`` mesh every rank
passes all the rays. Results come back for the rays the rank passed.

The port's ``cast_rays_binned`` has no ``use_pallas``, ``pallas_interpret``
or ``shared_dir``, so the casts take none of them.
"""

from __future__ import annotations

import numpy as np
import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.convert import to_numpy
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from rmcl_tpu_torch.parallel.mesh import SCENE_AXIS, Mesh

Tensor = torch.Tensor

_BIG = 3.0e38
# sentinel AABB (min > max) for padded bins and supers: every slab or cone
# test yields t_near > t_far, so padded entries are never candidates
_PAD_LO = 1.0e38
_PAD_HI = -1.0e38


def partition_bins(bins: TriangleBins, n_shards: int) -> TriangleBins:
    """Split bins into ``n_shards`` spatially compact shards stacked along a
    new leading axis of every tensor (host numpy, the JAX package's arrays
    bit for bit), on the bins' device.

    Shards are contiguous super ranges, padded to the same super and bin
    counts with sentinel never-hit entries. An empty shard (more shards than
    supers) keeps its sentinel boxes and a zero scene box."""
    S = bins.bins_per_super
    n_super, n_bins, B = bins.n_super, bins.n_bins, bins.bin_size
    sup_per = -(-n_super // n_shards)
    bins_per = sup_per * S

    tri = np.zeros((n_shards, bins_per, bins.tri.shape[1], B), np.float32)
    bin_aabb = np.empty((n_shards, bins_per, 6), np.float32)
    bin_aabb[..., 0:3] = _PAD_LO
    bin_aabb[..., 3:6] = _PAD_HI
    super_aabb = np.empty((n_shards, sup_per, 6), np.float32)
    super_aabb[..., 0:3] = _PAD_LO
    super_aabb[..., 3:6] = _PAD_HI
    tri_h, bin_h, sup_h = (to_numpy(x) for x in (bins.tri, bins.bin_aabb, bins.super_aabb))

    aabb_min = np.zeros((n_shards, 3), np.float32)
    aabb_max = np.zeros((n_shards, 3), np.float32)
    for s in range(n_shards):
        s0 = s * sup_per
        s1 = min(s0 + sup_per, n_super)
        if s1 <= s0:
            continue
        b0, b1 = s0 * S, min(s1 * S, n_bins)
        tri[s, : b1 - b0] = tri_h[b0:b1]
        bin_aabb[s, : b1 - b0] = bin_h[b0:b1]
        super_aabb[s, : s1 - s0] = sup_h[s0:s1]
        aabb_min[s] = sup_h[s0:s1, 0:3].min(axis=0)
        aabb_max[s] = sup_h[s0:s1, 3:6].max(axis=0)

    dev = bins.device
    return TriangleBins(tri=torch.from_numpy(tri).to(dev),
                        bin_aabb=torch.from_numpy(bin_aabb).to(dev),
                        super_aabb=torch.from_numpy(super_aabb).to(dev), bins_per_super=S,
                        aabb_min=torch.from_numpy(aabb_min).to(dev),
                        aabb_max=torch.from_numpy(aabb_max).to(dev))


def _shard(sbins: TriangleBins, i: int, device=None) -> TriangleBins:
    """Shard ``i`` of a :func:`partition_bins` result as bins of its own."""
    dev = sbins.device if device is None else device
    return TriangleBins(tri=sbins.tri[i].to(dev), bin_aabb=sbins.bin_aabb[i].to(dev),
                        super_aabb=sbins.super_aabb[i].to(dev),
                        bins_per_super=sbins.bins_per_super,
                        aabb_min=sbins.aabb_min[i].to(dev), aabb_max=sbins.aabb_max[i].to(dev))


def put_scene_sharded(sbins: TriangleBins, mesh: Mesh) -> TriangleBins:
    """This rank's shard of a :func:`partition_bins` result (its index on the
    scene axis), on the mesh's device. The stack's depth must equal the
    scene axis' size."""
    n_scene = mesh.axis_size(SCENE_AXIS)
    if sbins.tri.shape[0] != n_scene:
        raise ValueError(f"bins stacked to {sbins.tri.shape[0]} shards but the mesh's "
                         f"{SCENE_AXIS!r} axis has {n_scene} ranks")
    return _shard(sbins, mesh.axis_index(SCENE_AXIS), mesh.device)


def shard_boxes(sbins: TriangleBins) -> Tensor:
    """(n_shards, 6) [min, max] boxes of a :func:`partition_bins` result, to
    be passed whole to every rank for the per-ray routing of
    :func:`cast_rays_scene_forwarded`."""
    return torch.cat([sbins.aabb_min, sbins.aabb_max], dim=-1)


def _id_mask(n_scene: int) -> int:
    return (1 << max(1, (n_scene - 1).bit_length())) - 1


def _elect_and_broadcast(h: RayHits, mesh: Mesh) -> RayHits:
    """The global winner over the scene axis: an integer ``pmin`` of the
    packed (distance, shard) keys, then one all-reduce sum of the winner's
    payload bits (the other shards add zeros)."""
    idm = _id_mask(mesh.axis_size(SCENE_AXIS))
    t_loc = torch.where(h.hit, h.t, _BIG).to(torch.float32)
    key = (t_loc.view(torch.int32) & ~idm) | mesh.axis_index(SCENE_AXIS)
    win = key == mesh.pmin(key, SCENE_AXIS)
    own = win & h.hit
    n = h.t.shape[0]
    payload = torch.cat([
        own.to(torch.int32)[:, None],
        torch.where(own, h.prim_id, 0).to(torch.int32)[:, None],
        torch.where(own, h.inst_id, 0).to(torch.int32)[:, None],
        torch.where(own[:, None], torch.cat([h.t[:, None], h.point, h.normal], 1),
                    0.0).to(torch.float32).view(torch.int32),
    ], dim=1)
    payload = mesh.psum(payload, SCENE_AXIS)
    hit = payload[:, 0] > 0
    floats = payload[:, 3:].contiguous().view(torch.float32)
    return RayHits(
        t=torch.where(hit, floats[:, 0], NO_HIT_T),
        hit=hit,
        prim_id=torch.where(hit, payload[:, 1], -1),
        inst_id=torch.where(hit, payload[:, 2], -1),
        point=floats[:, 1:4].reshape(n, 3),
        normal=floats[:, 4:7].reshape(n, 3),
    )


def _flat_rays(orig, dirs, t_min, t_max, device):
    orig, dirs = torch.broadcast_tensors(
        torch.as_tensor(orig, dtype=torch.float32, device=device),
        torch.as_tensor(dirs, dtype=torch.float32, device=device))
    batch_shape = orig.shape[:-1]
    flat = lambda t: torch.as_tensor(t, dtype=torch.float32, device=device).broadcast_to(
        batch_shape).reshape(-1)
    return (orig.reshape(-1, 3), dirs.reshape(-1, 3), flat(t_min), flat(t_max),
            tuple(batch_shape))


def _unflatten(h: RayHits, batch_shape) -> RayHits:
    return RayHits(t=h.t.reshape(batch_shape), hit=h.hit.reshape(batch_shape),
                   prim_id=h.prim_id.reshape(batch_shape),
                   inst_id=h.inst_id.reshape(batch_shape),
                   point=h.point.reshape(batch_shape + (3,)),
                   normal=h.normal.reshape(batch_shape + (3,)))


def cast_rays_scene_sharded(bins_local: TriangleBins, orig: Tensor, dirs: Tensor, mesh: Mesh,
                            t_min=0.0, t_max=NO_HIT_T, **cast_kw) -> RayHits:
    """Closest hit over a scene partitioned across the scene axis.

    ``bins_local``: this rank's shard (:func:`put_scene_sharded`); ``orig``,
    ``dirs`` (..., 3): the rays this rank passes (module docstring);
    ``cast_kw`` go to :func:`cast_rays_binned`. Every rank casts its rays on
    its own shard; the election costs two collectives."""
    o, d, tmin, tmax, batch_shape = _flat_rays(orig, dirs, t_min, t_max, mesh.device)
    h = cast_rays_binned(bins_local, o, d, t_min=tmin, t_max=tmax, **cast_kw)
    return _unflatten(_elect_and_broadcast(h, mesh), batch_shape)


def _route(o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor, boxes: Tensor):
    """Per-ray slab tests against every shard box (the scene axis is small):
    ``(order, assigned, crosses, t_enter)``, the rays' assigned-shard-major
    order (stable, the same on every rank) and, in that order, each ray's
    assigned shard (the first its segment enters), the (n, n_scene) shards
    it crosses and their entry distances (3e38 where it does not cross)."""
    inv = 1.0 / torch.where(torch.abs(d) > 1e-30, d, torch.where(d >= 0, 1e-30, -1e-30))
    lo = (boxes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    hi = (boxes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    t_near = torch.amax(torch.minimum(lo, hi), dim=-1)
    t_far = torch.amin(torch.maximum(lo, hi), dim=-1)
    t_enter = torch.maximum(t_near, t_min[:, None])
    crosses = ((t_far >= t_enter) & (t_enter <= t_max[:, None])
               & (boxes[None, :, 0] <= boxes[None, :, 3]))  # sentinel empty shards
    t_enter = torch.where(crosses, t_enter, _BIG)
    assigned = torch.argmin(t_enter, dim=1)
    order = torch.argsort(assigned, stable=True)
    return order, assigned[order], crosses[order], t_enter[order]


def _round1_t_max(shard: int, assigned: Tensor, crosses: Tensor, t_max: Tensor) -> Tensor:
    """Round 1's reach on ``shard``: the rays assigned to it keep theirs,
    the others are dead (0)."""
    return torch.where((assigned == shard) & torch.any(crosses, dim=1), t_max, 0.0)


def _round2_t_max(shard: int, assigned: Tensor, crosses: Tensor, t_enter: Tensor,
                  t_max: Tensor, t1_all: Tensor) -> Tensor:
    """Round 2's reach on ``shard`` from the round-1 distances ``t1_all``
    (summed over the shards): a ray escalates iff another crossed shard's
    entry precedes its round-1 result, and is cast here, up to that result,
    iff it crosses this shard and is not assigned to it."""
    t1_all = torch.where(torch.any(crosses, dim=1), t1_all, 0.0)
    col = torch.arange(crosses.shape[1], device=crosses.device)[None, :]
    other = crosses & (col != assigned[:, None])
    escal = torch.any(other & (t_enter < t1_all[:, None]), dim=1)
    mine2 = escal & crosses[:, shard] & (assigned != shard)
    return torch.where(mine2, torch.minimum(t_max, t1_all), 0.0)


def cast_rays_scene_forwarded(bins_local: TriangleBins, orig: Tensor, dirs: Tensor, mesh: Mesh,
                              boxes: Tensor, t_min=0.0, t_max=NO_HIT_T, **cast_kw) -> RayHits:
    """Scene-partitioned closest hit with ray forwarding by masking: each ray
    is assigned to the shard its segment enters first, and every other
    shard sees it dead (t_max 0), so dead blocks cost almost nothing.

    Round 1 casts every ray on its assigned shard only; one all-reduce
    shares the round-1 distances. A ray escalates iff another crossed
    shard's box entry lies before its round-1 hit (or it missed and crosses
    other shards): a shard's geometry lies inside its box, so a later entry
    cannot win. Round 2 casts the escalated rays on the other crossed shards
    with t_max clamped to the round-1 hit; then the election (two
    collectives), three collectives a cast in all. ``boxes``: the
    (n_scene, 6) :func:`shard_boxes`, whole on every rank. Rays run in
    assigned-shard order (blocks stay alive or dead together) and come back
    in the order given."""
    cast_kw.setdefault("sort_blocks", True)
    o_l, d_l, tmin_l, tmax_l, batch_shape = _flat_rays(orig, dirs, t_min, t_max, mesh.device)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=mesh.device)
    my = mesh.axis_index(SCENE_AXIS)

    order, assigned_s, crosses_s, t_enter_s = _route(o_l, d_l, tmin_l, tmax_l, boxes)
    inv_order = torch.argsort(order, stable=True)
    o_s, d_s, tmin_s, tmax_s = o_l[order], d_l[order], tmin_l[order], tmax_l[order]

    # round 1: this shard's rays only
    t1_max = _round1_t_max(my, assigned_s, crosses_s, tmax_s)
    h1 = cast_rays_binned(bins_local, o_s, d_s, t_min=tmin_s, t_max=t1_max, **cast_kw)
    # the round-1 distances: owners contribute, the others zero
    t1_all = mesh.psum(torch.where(h1.hit, h1.t, t1_max), SCENE_AXIS)
    # round 2: escalated rays that cross this shard and are not assigned to it
    h2 = cast_rays_binned(bins_local, o_s, d_s, t_min=tmin_s,
                          t_max=_round2_t_max(my, assigned_s, crosses_s, t_enter_s, tmax_s,
                                              t1_all), **cast_kw)

    pick1 = h1.hit & (~h2.hit | (h1.t <= h2.t))
    sel = lambda a, b: torch.where(pick1 if a.dim() == 1 else pick1[:, None], a, b)
    h_loc = RayHits(t=sel(h1.t, h2.t), hit=h1.hit | h2.hit, prim_id=sel(h1.prim_id, h2.prim_id),
                    inst_id=sel(h1.inst_id, h2.inst_id), point=sel(h1.point, h2.point),
                    normal=sel(h1.normal, h2.normal))
    out = _elect_and_broadcast(h_loc, mesh)
    out = RayHits(t=out.t[inv_order], hit=out.hit[inv_order], prim_id=out.prim_id[inv_order],
                  inst_id=out.inst_id[inv_order], point=out.point[inv_order],
                  normal=out.normal[inv_order])
    return _unflatten(out, batch_shape)
