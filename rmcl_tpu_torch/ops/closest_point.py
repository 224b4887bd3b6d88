"""Batched closest-point-on-mesh queries: the exact BVH engine and the dense
binned engine.

Counterpart of ``rmcl_tpu.ops.closest_point``. :func:`closest_points` walks
the threaded BVH with the K6 kernel
(:func:`rmcl_tpu_torch.ops.closest_cuda.closest_bvh`), pruned by the
point-to-AABB distance; :func:`closest_points_binned` culls query blocks
against the bins by box-box distance lower bounds with the K7 kernel
(:func:`rmcl_tpu_torch.ops.closest_cuda.cp_candidates`, whose plain version
is :func:`_cp_candidates`) and tests the surviving bins with the K6b kernel
(:func:`rmcl_tpu_torch.ops.closest_cuda.closest_bins`);
:func:`closest_points_seeded` seeds the exact walk with the binned result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bvh, cp_candidates, walk_split
from rmcl_tpu_torch.ops.order import cluster_order

Tensor = torch.Tensor

# widest bin id that the candidate selection packs into the low mantissa bits
# of a lower bound; wider ids take the float top-k path
_PACKED_ID_BITS = 20


@dataclasses.dataclass(frozen=True)
class ClosestPoints:
    point: Tensor  # (..., 3) closest surface point (map frame)
    normal: Tensor  # (..., 3) geometric normal of the supporting triangle
    dist: Tensor  # (...,) unsigned distance
    prim_id: Tensor  # (...,) int32 (-1 if none within max_dist)
    found: Tensor  # (...,) bool


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def closest_point_on_triangle(q: Tensor, v0: Tensor, e1: Tensor, e2: Tensor) -> Tensor:
    """Closest point on triangle(s), batched over leading dims: Ericson,
    Real-Time Collision Detection §5.1.5, the regions resolved by selects
    (the vector form of the JAX package, which forms ``b - p`` as
    ``q - (a + ab)``)."""
    a, ab, ac = v0, e1, e2
    ap = q - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = q - (a + ab)
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = q - (a + ac)
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_face = torch.clamp(va + vb + vc, min=1e-30)
    v_face = vb / denom_face
    w_face = vc / denom_face

    def safe_div(x, y):
        return x / torch.where(torch.abs(y) > 1e-30, y, 1e-30)

    v_ab = torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    no_vert = ~in_vert_a & ~in_vert_b & ~in_vert_c
    in_edge_ab = no_vert & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = no_vert & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = no_vert & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    v = torch.where(in_vert_a | in_vert_c, 0.0, torch.where(in_vert_b, 1.0, v_face))
    w = torch.where(in_vert_a | in_vert_b, 0.0, torch.where(in_vert_c, 1.0, w_face))
    v = torch.where(in_edge_ab, v_ab, v)
    w = torch.where(in_edge_ab, 0.0, w)
    v = torch.where(in_edge_ac, 0.0, v)
    w = torch.where(in_edge_ac, w_ac, w)
    v = torch.where(in_edge_bc, 1.0 - t_bc, v)
    w = torch.where(in_edge_bc, t_bc, w)
    return a + v[..., None] * ab + w[..., None] * ac


def _max_d2(max_dist, batch_shape, dev, cap=None) -> Tensor:
    """float32 max_dist (clamped to ``cap``) squared, broadcast and flattened."""
    m = torch.as_tensor(max_dist, dtype=torch.float32, device=dev)
    if cap is not None:
        m = torch.clamp(m, max=cap)
    return (m * m).broadcast_to(batch_shape).reshape(-1).contiguous()


def closest_points(bvh: BVH, queries: Tensor, max_dist=3.0e38,
                   chunk_size: int = 65536) -> ClosestPoints:
    """Closest mesh surface point for each query point (map frame), within
    ``max_dist``. ``chunk_size`` bounds the plain version's memory on the
    CPU only; the kernel takes every query in one launch. The walk's split
    (:func:`walk_split` of the whole batch) is fixed once, so each chunk
    walks as the kernel would and the CPU gives the card's result."""
    dev = bvh.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    batch_shape = queries.shape[:-1]
    q = queries.reshape(-1, 3).contiguous()
    n = q.shape[0]
    max_d2 = _max_d2(max_dist, batch_shape, dev)
    P = walk_split(n, dev)
    if dev.type == "cpu" and n:
        step = max(1, int(chunk_size))
        parts = [closest_bvh(bvh.nodes, bvh.root_link, q[s:s + step], max_d2[s:s + step],
                             split=P) for s in range(0, n, step)]
        d2, point, slot = (torch.cat([p[k] for p in parts]) for k in range(3))
    else:
        d2, point, slot = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, split=P)

    found = slot >= 0
    safe_slot = torch.where(found, slot, 0).long()
    # an int32 row gather: small prim ids are denormal float patterns
    leaf_i = bvh.nodes.view(torch.int32)[safe_slot]
    normal = torch.where(found[:, None], leaf_i[:, 9:12].contiguous().view(torch.float32), 0.0)
    prim_id = torch.where(found, leaf_i[:, 12], -1)
    return ClosestPoints(
        point=torch.where(found[:, None], point, 0.0).reshape(batch_shape + (3,)),
        normal=normal.reshape(batch_shape + (3,)),
        dist=torch.where(found, torch.sqrt(d2), 3.0e38).reshape(batch_shape),
        prim_id=prim_id.reshape(batch_shape),
        found=found.reshape(batch_shape),
    )


# ---------------------------------------------------------------------------
# Dense binned closest-point engine
# ---------------------------------------------------------------------------


def _box_box_d2(qlo: Tensor, qhi: Tensor, bmin: Tensor, bmax: Tensor) -> Tensor:
    """Squared-distance lower bound between two AABBs, (..., K)."""
    gap = torch.clamp(torch.maximum(bmin - qhi, qlo - bmax), min=0.0)
    g = gap * gap
    return g[..., 0] + g[..., 1] + g[..., 2]


def _topk_stable(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest along the last axis, ties toward the lower index (the
    order of XLA's top_k, which ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cp_candidates(bins: TriangleBins, q_blk: Tensor, d2cap: Tensor, cs: int, cb: int):
    """Distance-ordered candidate bins per query block: K7's plain version
    (:func:`rmcl_tpu_torch.ops.closest_cuda.cp_candidates` takes it for CPU
    tensors; it runs on any device).

    Two-level cull by box-box distance lower bounds. Returns (cand_bin (Cb,
    cb) int32 -1-padded, cand_count (Cb,) int32, cand_dlb (Cb, cb)
    squared-distance lower bounds, ascending)."""
    Cb = q_blk.shape[0]
    S = bins.bins_per_super
    n_super = bins.n_super
    n_bins = bins.n_bins
    dev = q_blk.device

    qlo = torch.amin(q_blk, dim=1)  # (Cb, 3)
    qhi = torch.amax(q_blk, dim=1)

    # level 0: supers
    d2s = _box_box_d2(qlo[:, None], qhi[:, None], bins.super_aabb[None, :, 0:3],
                      bins.super_aabb[None, :, 3:6])  # (Cb, n_super)
    ok_s = d2s <= d2cap[:, None]
    sup_score, sup_ids = _topk_stable(torch.where(ok_s, -d2s, -3.0e38), cs)
    sup_valid = sup_score > -3.0e38

    # level 1: the candidate supers' bins
    bin_aabb_g = bins.bin_aabb
    pad_bins = n_super * S - n_bins
    if pad_bins:
        bin_aabb_g = torch.cat([bin_aabb_g, bin_aabb_g.new_zeros((pad_bins, 6))], 0)
    sub = bin_aabb_g.reshape(n_super, S, 6)[sup_ids]  # (Cb, cs, S, 6)
    d2b = _box_box_d2(qlo[:, None, None], qhi[:, None, None], sub[..., 0:3], sub[..., 3:6])
    gbin = (sup_ids[..., None] * S + torch.arange(S, device=dev)[None, None, :]).to(torch.int32)
    valid = ((d2b <= d2cap[:, None, None]) & sup_valid[..., None] & (gbin < n_bins)
             ).reshape(Cb, cs * S)
    gbin = gbin.reshape(Cb, cs * S)
    d2f = torch.clamp(d2b.reshape(Cb, cs * S), min=0.0)

    # packed keys: the bin id in the low mantissa bits of the (non-negative)
    # lower bound, so one integer selection orders ids and bounds together
    id_bits = max(1, (n_bins - 1).bit_length())
    if id_bits <= _PACKED_ID_BITS:
        idm = (1 << id_bits) - 1
        key = torch.where(valid, (d2f.view(torch.int32) & ~idm) | gbin, 0x7FFFFFF0)
        kmin = -_topk_stable(-key, cb)[0]
        cand_ok = kmin != 0x7FFFFFF0
        cand_bin = torch.where(cand_ok, kmin & idm, -1)
        cand_dlb = torch.where(cand_ok, (kmin & ~idm).view(torch.float32), 3.0e38)
    else:
        score = torch.where(valid, -d2f, -3.0e38)
        cand_score, cand_pos = _topk_stable(score, cb)
        cand_bin = torch.where(cand_score > -3.0e38, torch.gather(gbin, 1, cand_pos), -1)
        cand_dlb = torch.where(cand_bin >= 0, -cand_score, 3.0e38)
    cand_count = torch.sum(cand_bin >= 0, dim=1).to(torch.int32)
    return cand_bin.to(torch.int32).contiguous(), cand_count, cand_dlb.contiguous()


def binned_inputs(bins: TriangleBins, q: Tensor, max_d2: Tensor, block_size: int = 128,
                  c_super: int = 24, c_bin: int = 96, block_chunk: int = 256):
    """K6b's inputs for queries ``q (n, 3)`` in the order given: the query
    blocks (the last padded with origin queries at max_d2 = 0, as the JAX
    package pads) and their candidate lists, from one K7 launch on the
    card. Returns ``(qb, d2b, cand_bin, cand_count, cand_dlb)``; on the CPU
    ``block_chunk`` blocks at a time go through the plain cull (memory
    only: each block's list is its own)."""
    B = bins.bin_size
    if B & (B - 1):
        raise ValueError("bin_size must be a power of two (packed-key min)")
    n = q.shape[0]
    Rq = block_size
    n_pad = (-n) % Rq
    if n_pad:
        q = torch.cat([q, q.new_zeros((n_pad, 3))], 0)
        max_d2 = torch.cat([max_d2, max_d2.new_zeros((n_pad,))], 0)
    n_blk = (n + n_pad) // Rq
    qb = q.reshape(n_blk, Rq, 3).contiguous()
    d2b = max_d2.reshape(n_blk, Rq).contiguous()
    cs = min(c_super, bins.n_super)
    cb = min(c_bin, bins.n_bins, cs * bins.bins_per_super)
    return (qb, d2b) + cp_candidates(bins, qb, d2b, cs, cb, block_chunk)


def closest_points_binned(bins: TriangleBins, queries: Tensor, max_dist=3.0e38,
                          block_size: int = 128, c_super: int = 24, c_bin: int = 96,
                          block_chunk: int = 256, cluster: bool = True) -> ClosestPoints:
    """Dense closest-point query (drop-in for :func:`closest_points`).

    Query blocks are culled against super-bins and bins by box-box distance
    lower bounds (never a false cull); the surviving bins are tested by the
    K6b kernel, nearest first with a block-wide early exit.
    ``cluster=True`` Morton-sorts the queries so arbitrary orders form
    tight blocks (the result order is restored).

    Candidate budgets (c_super, c_bin) follow the binned ray caster's
    contract: a block needing more candidates than the budget may return a
    farther-than-true point. ``block_chunk`` blocks at a time go through the
    candidate cull on the CPU (memory only)."""
    dev = bins.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    batch_shape = queries.shape[:-1]
    q = queries.reshape(-1, 3)
    n = q.shape[0]
    # clamp so max_dist^2 stays finite: an inf bound bitcasts to a
    # NaN-pattern packed key, which would disable the early-exit compare
    max_d2 = _max_d2(max_dist, batch_shape, dev, cap=1.7e19)

    inv_perm = None
    if cluster and n > block_size:
        order, inv_perm = cluster_order(q, None)
        q = q[order.long()]
        max_d2 = max_d2[order.long()]

    inputs = binned_inputs(bins, q, max_d2, block_size, c_super, c_bin, block_chunk)
    best_key, best_bin = closest_bins(bins.tri, *inputs)
    out = binned_winners(bins, q, max_d2, best_key, best_bin, inv_perm)
    return ClosestPoints(**{f.name: getattr(out, f.name).reshape(
        batch_shape + getattr(out, f.name).shape[1:]) for f in dataclasses.fields(out)})


def binned_winners(bins: TriangleBins, q: Tensor, max_d2: Tensor, best_key: Tensor,
                   best_bin: Tensor, inv_perm: Tensor | None = None) -> ClosestPoints:
    """The winners of K6b's packed keys for the (n, 3) queries ``q`` in
    block order: each winner's exact closest point, normal, distance and
    id, in the caller's order again when ``inv_perm`` is given."""
    n = q.shape[0]
    B = bins.bin_size
    jmask = B - 1
    best_key = best_key.reshape(-1)[:n]
    best_bin = best_bin.reshape(-1)[:n]
    found = best_bin >= 0
    slot = best_key & jmask
    safe_bin = torch.where(found, best_bin, 0).long()
    # one batched winner gather and the exact closest point (the loop's
    # packed key truncated the low mantissa bits)
    tw = bins.tri[safe_bin, :, torch.where(found, slot, 0).long()]  # (n, 14)
    v0, e1, e2 = tw[:, 0:3], tw[:, 3:6], tw[:, 6:9]
    point = closest_point_on_triangle(q, v0, e1, e2)
    diff = q - point
    d2 = torch.sum(diff * diff, dim=-1)
    found = found & (d2 <= max_d2)
    out = ClosestPoints(
        point=torch.where(found[:, None], point, 0.0),
        normal=torch.where(found[:, None], tw[:, 9:12], 0.0),
        dist=torch.where(found, torch.sqrt(d2), 3.0e38),
        prim_id=torch.where(found, tw[:, 12].to(torch.int32), -1),
        found=found,
    )
    if inv_perm is not None:
        inv = inv_perm.long()
        out = ClosestPoints(**{f.name: getattr(out, f.name)[inv]
                               for f in dataclasses.fields(out)})
    return out


def closest_points_seeded(bvh: BVH, bins: TriangleBins, queries: Tensor, max_dist=3.0e38,
                          chunk_size: int = 65536, c_super: int = 24,
                          c_bin: int = 96) -> ClosestPoints:
    """Exact closest-point query with a binned-engine seed pass.

    The dense result is a true upper bound wherever it finds a triangle, so
    seeding the exact walk with ``dist * (1 + 1e-5) + 1e-6`` prunes it to
    near the winning path and keeps the result exact: the optimal leaf's box
    lies within d2_opt < seed, so it is always visited and beats the
    inflated bound. Queries the dense pass misses keep ``max_dist``; a query
    the exact pass leaves unfound where the seed holds a real surface point
    (the two engines round apart) falls back to the seed."""
    dev = bvh.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    batch_shape = queries.shape[:-1]
    q = queries.reshape(-1, 3)
    seed = closest_points_binned(bins, q, max_dist=max_dist, c_super=c_super, c_bin=c_bin)
    md = torch.as_tensor(max_dist, dtype=torch.float32, device=dev)
    bound = torch.where(seed.found, seed.dist * float(np.float32(1.0 + 1e-5))
                        + float(np.float32(1e-6)), md.broadcast_to(seed.dist.shape))
    bound = torch.minimum(bound, md)
    # sorted by bound: a warp's queries then walk similar distances
    order = torch.argsort(bound, stable=True)
    inv = torch.argsort(order, stable=True)
    out = closest_points(bvh, q[order], max_dist=bound[order], chunk_size=chunk_size)
    out = ClosestPoints(**{f.name: getattr(out, f.name)[inv] for f in dataclasses.fields(out)})
    fb = seed.found & ~out.found
    out = ClosestPoints(
        point=torch.where(fb[:, None], seed.point, out.point),
        normal=torch.where(fb[:, None], seed.normal, out.normal),
        dist=torch.where(fb, seed.dist, out.dist),
        prim_id=torch.where(fb, seed.prim_id, out.prim_id),
        found=out.found | seed.found,
    )
    return ClosestPoints(**{f.name: getattr(out, f.name).reshape(
        batch_shape + getattr(out, f.name).shape[1:]) for f in dataclasses.fields(out)})
