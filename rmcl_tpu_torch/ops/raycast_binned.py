"""Dense binned ray caster.

Counterpart of ``rmcl_tpu.ops.raycast_binned``: rays are processed in
coherent blocks; each block is culled against super-bins and bins with a
conservative cone test (never false-culls), nearest first, down to at most
``c_bin`` candidate bins; the candidates are intersected by one launch of
the hand-written kernel :func:`rmcl_tpu_torch.ops.raycast_cuda.intersect_bins`;
the winner's triangle row is gathered once per ray and t, point and normal
are re-derived from its plane.

The cull (``_block_bounds`` … ``_chunk_candidates``) is plain PyTorch tensor
code, run per chunk of ``block_chunk`` blocks to bound its intermediates.

Budgets truncate candidate lists nearest-first: a block needing more than
``c_super`` supers or ``c_bin`` bins may miss geometry (``candidate_stats``
shows the counts). The JAX package's ``c_mid`` / ``c_hyper`` levels,
``dir_groups``, ``sort_blocks`` and ``with_lossless`` are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits
from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins

Tensor = torch.Tensor

_BIG = 3.0e38
_SENTINEL_KEY = 0x7FFFFFF0


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _top_k_desc(score: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` on float scores: k largest, ties to the lower index
    (``torch.topk`` promises no tie order; a stable sort does)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cone_box_test(oc, oh, a, tan_th, t_hi, bmin, bmax):
    """Conservative (origin-box x direction-cone) vs AABB test.

    The ray block is the Minkowski sum of an origin box (center ``oc``,
    half-extents ``oh``) and a direction cone (unit axis ``a``, ``tan_th``
    = tan of the max angular deviation); intersected with the ball bound.
    Never false-culls.

    Shapes: oc/oh/a (..., 1, 3), tan_th/t_hi (..., 1), bmin/bmax (..., K, 3).
    Returns (pass (..., K), t_near (..., K), t_far (..., K))."""
    a_safe = torch.where(torch.abs(a) < 1e-30, 1e-30, a)
    inv = 1.0 / a_safe
    b0 = bmin - oh - oc
    b1 = bmax + oh - oc
    gap = torch.clamp(torch.maximum(b0, -b1), min=0.0)
    d_near = _norm(gap)
    sep = torch.maximum(b1, -b0)
    d_far = _norm(sep)
    # the cone's displacement off the axis is perpendicular to it: its reach
    # along axis k is r * sqrt(1 - a_k^2)
    s_perp = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))

    def slab(r):
        rk = r * s_perp
        t0 = (b0 - rk) * inv
        t1 = (b1 + rk) * inv
        tn = torch.amax(torch.minimum(t0, t1), dim=-1)
        tf = torch.amin(torch.maximum(t0, t1), dim=-1)
        return tn, tf

    r0 = (t_hi * tan_th)[..., None]
    _, tf0 = slab(r0)
    # refine: over the box's own window the cone radius is tf0 * tan_th
    r1 = (torch.minimum(torch.clamp(tf0, min=0.0), t_hi) * tan_th)[..., None]
    tn, tf = slab(r1)
    tn = torch.maximum(tn, d_near)
    tf = torch.minimum(tf, d_far)
    ok = (tn <= tf) & (tf >= 0.0) & (tn <= t_hi) & (d_near <= t_hi)
    return ok, torch.clamp(tn, min=0.0), tf


def _block_bounds(ob, db, t_min_b, t_max_b):
    """Per-block cone/box bounds from rays (n_blk, Rb, 3).

    Returns oc, oh, axis, tan_th, t_hi, n_hi, dead. Rays with
    t_max <= t_min are inert and excluded from the bounds."""
    live = (t_max_b > t_min_b)[..., None]
    any_live = torch.any(live[..., 0], dim=1)
    o_lo = torch.amin(torch.where(live, ob, _BIG), dim=1)
    o_hi = torch.amax(torch.where(live, ob, -_BIG), dim=1)
    o_lo = torch.where(any_live[:, None], o_lo, 0.0)
    o_hi = torch.where(any_live[:, None], o_hi, 0.0)
    oc = 0.5 * (o_lo + o_hi)
    oh = 0.5 * (o_hi - o_lo)

    # unit mean direction; rays need not be normalized — normalize locally
    dn = db * torch.rsqrt(torch.clamp(torch.sum(db * db, -1, keepdim=True), min=1e-30))
    dsum = torch.sum(torch.where(live, dn, 0.0), dim=1)
    a = dsum * torch.rsqrt(torch.clamp(torch.sum(dsum * dsum, -1, keepdim=True), min=1e-30))
    ca = torch.amin(
        torch.where(live[..., 0], torch.sum(dn * a[:, None, :], -1), 1.0), dim=1
    )
    # degenerate spread (>= ~87 deg): huge tan -> conservative pass-all
    ca = torch.clamp(ca, 0.05, 1.0)
    tan_th = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0)) / ca
    # parametric t reaches geometric distance t*|d|: bound the reach by
    # max(t_max*|d|)
    nrm = torch.sqrt(torch.clamp(torch.sum(db * db, -1), min=1e-30))
    n_hi = torch.amax(torch.where(live[..., 0], nrm, 1e-30), dim=1)
    t_hi = torch.amax(torch.where(live[..., 0], t_max_b * nrm, 0.0), dim=1)
    return oc, oh, a, tan_th, t_hi, n_hi, ~any_live


def _dead_axis(axis, dead):
    x_axis = axis.new_tensor([1.0, 0.0, 0.0])
    return torch.where(dead[..., None], x_axis, axis)


def _scene_exit_cap(bins, oc, oh, axis, tan_th, t_hi):
    """Cap each block's reach at its conservative exit from the scene box.
    Bounds have a leading batch shape L; returns t_hi (L)."""
    scene_c = 0.5 * (bins.aabb_min + bins.aabb_max)
    scene_h = 0.5 * (bins.aabb_max - bins.aabb_min)
    t_cap = _norm(oc - scene_c) + _norm(scene_h) + _norm(oh)
    lead = (1,) * oc.dim()
    _, _, scene_far = _cone_box_test(
        oc[..., None, :], oh[..., None, :], axis[..., None, :],
        tan_th[..., None], t_cap[..., None],
        bins.aabb_min.reshape(lead[:-1] + (1, 3)),
        bins.aabb_max.reshape(lead[:-1] + (1, 3)),
    )
    return torch.minimum(t_hi, scene_far[..., 0] * 1.0001 + 1e-3)


def _bins_by_super(bins):
    """bin AABBs as (n_super, S, 6), zero-padded to whole supers."""
    S = bins.bins_per_super
    pad_bins = bins.n_super * S - bins.n_bins
    g = bins.bin_aabb
    if pad_bins:
        g = torch.cat([g, g.new_zeros((pad_bins, 6))], 0)
    return g.reshape(bins.n_super, S, 6)


def _global_bin_ids(sup_ids, S):
    iota = torch.arange(S, dtype=torch.int32, device=sup_ids.device)
    return sup_ids.to(torch.int32)[..., None] * S + iota


def _build_candidates(bins, ob, db, t_min_b, t_max_b, cs, cb):
    """Two-level cull with one fat cone per block: nearest-first candidate
    bins per ray block (the Pallas kernel's input in the JAX package).

    Returns (cand_bin (n_blk, cb) int32 with -1 padding, cand_count
    (n_blk,) int32, cand_tnear (n_blk, cb) conservative parametric entry)."""
    n_blk = ob.shape[0]
    S = bins.bins_per_super
    oc, oh, axis, tan_th, t_hi, n_hi, block_dead = _block_bounds(
        ob, db, t_min_b, t_max_b)
    axis = _dead_axis(axis, block_dead)
    t_hi = torch.where(block_dead, 0.0, t_hi)
    t_hi = _scene_exit_cap(bins, oc, oh, axis, tan_th, t_hi)

    # level 0: block x supers
    pass_sup, tn_sup, _ = _cone_box_test(
        oc[:, None], oh[:, None], axis[:, None], tan_th[:, None], t_hi[:, None],
        bins.super_aabb[None, :, 0:3], bins.super_aabb[None, :, 3:6],
    )  # (n_blk, n_super)
    score = torch.where(pass_sup, -tn_sup, -_BIG)
    sup_score, sup_ids = _top_k_desc(score, cs)
    sup_valid = sup_score > -_BIG

    # level 1: block x candidate supers' bins
    sub = _bins_by_super(bins)[sup_ids]  # (n_blk, cs, S, 6)
    pass_bin, tn_bin, _ = _cone_box_test(
        oc[:, None, None], oh[:, None, None], axis[:, None, None],
        tan_th[:, None, None], t_hi[:, None, None], sub[..., 0:3], sub[..., 3:6],
    )  # (n_blk, cs, S)
    gbin = _global_bin_ids(sup_ids, S)
    valid_bin = (pass_bin & sup_valid[..., None] & (gbin < bins.n_bins)).reshape(n_blk, cs * S)
    tn_flat = torch.clamp(tn_bin.reshape(n_blk, cs * S), min=0.0)
    return _chunk_select(bins, valid_bin, gbin.reshape(n_blk, cs * S), tn_flat, n_hi, cb)


def _pad_rays(o, d, t_min_r, t_max_r, Rb):
    """Pad the ray list to whole blocks with inert rays (t_max = 0) and
    reshape it into blocks (n_blk, Rb, ...)."""
    n_pad = (-o.shape[0]) % Rb
    if n_pad:
        o = torch.cat([o, o.new_zeros((n_pad, 3))], 0)
        d = torch.cat([d, d.new_ones((n_pad, 3))], 0)
        t_min_r = torch.cat([t_min_r, t_min_r.new_zeros(n_pad)], 0)
        t_max_r = torch.cat([t_max_r, t_max_r.new_zeros(n_pad)], 0)
    n_blk = o.shape[0] // Rb
    return (o.reshape(n_blk, Rb, 3).contiguous(), d.reshape(n_blk, Rb, 3).contiguous(),
            t_min_r.reshape(n_blk, Rb).contiguous(), t_max_r.reshape(n_blk, Rb).contiguous())


def _flat_rays(orig, dirs, t_min, t_max):
    """Broadcast rays and gates to one flat list on the rays' device."""
    orig, dirs = torch.broadcast_tensors(orig.to(torch.float32), dirs.to(torch.float32))
    batch_shape = tuple(orig.shape[:-1])
    gate = lambda x: torch.as_tensor(x, dtype=torch.float32, device=orig.device).expand(
        batch_shape).reshape(-1)
    return (orig.reshape(-1, 3), dirs.reshape(-1, 3), gate(t_min), gate(t_max),
            batch_shape)


def _resolve_budgets(bins, c_super, c_bin):
    """The cull budgets clamped to the structure's level sizes: (cs, cb)."""
    cs = min(c_super, bins.n_super)
    return cs, min(c_bin, bins.n_bins, cs * bins.bins_per_super)


def candidate_stats(bins: TriangleBins, orig: Tensor, dirs: Tensor,
                    t_min=0.0, t_max=NO_HIT_T, block_size: int = 256,
                    c_super: int = 48, c_bin: int = 192) -> Tensor:
    """Candidate-bin count per ray block from the fat-block cull (counts
    saturating at c_bin mean budget overflow, i.e. potential false
    misses)."""
    o, d, t_min_r, t_max_r, _ = _flat_rays(orig, dirs, t_min, t_max)
    cs, cb = _resolve_budgets(bins, c_super, c_bin)
    _, cand_count, _ = _build_candidates(
        bins, *_pad_rays(o, d, t_min_r, t_max_r, block_size), cs, cb)
    return cand_count


def _subblock_bounds(ob, db, t_min_b, t_max_b, sub_blocks):
    """Per-sub-block cone/box bounds: rays (n_blk, Rb, 3) split into
    ``sub_blocks`` contiguous groups; outputs lead with (n_blk, R)."""
    n_blk, Rb, _ = ob.shape
    R = sub_blocks
    rs = lambda x: x.reshape((n_blk * R, Rb // R) + tuple(x.shape[2:]))
    out = _block_bounds(rs(ob), rs(db), rs(t_min_b), rs(t_max_b))
    return tuple(x.reshape((n_blk, R) + tuple(x.shape[1:])) for x in out)


def _chunk_level0(bins, ob, db, t_min_b, t_max_b, cs, sub_blocks):
    """Front of the chunk cull: sub-block cone bounds, scene-exit cap,
    level-0 super tests + nearest-first selection of ``cs`` supers.

    Returns (bounds, sup_ids, sup_valid, n_hi_b, sat0) with bounds = (oc,
    oh, axis, tan_th, t_hi) of shapes (Cb, R, ...); sat0 (Cb,) is True when
    more supers passed than the budget kept."""
    oc, oh, axis, tan_th, t_hi, n_hi, dead = _subblock_bounds(
        ob, db, t_min_b, t_max_b, sub_blocks)
    axis = _dead_axis(axis, dead)
    t_hi = torch.where(dead, 0.0, t_hi)
    t_hi = _scene_exit_cap(bins, oc, oh, axis, tan_th, t_hi)
    bounds = (oc, oh, axis, tan_th, t_hi)
    n_hi_b = torch.amax(n_hi, dim=1)  # (Cb,) |d| scale, max over sub-blocks

    # level 0: sub-block cones x supers -> OR over sub-blocks
    pass_sup, tn_sup, _ = _cone_box_test(
        oc[:, :, None], oh[:, :, None], axis[:, :, None], tan_th[:, :, None],
        t_hi[:, :, None],
        bins.super_aabb[None, None, :, 0:3], bins.super_aabb[None, None, :, 3:6],
    )  # (Cb, R, n_super)
    tn_sup = torch.amin(torch.where(pass_sup, tn_sup, _BIG), dim=1)
    any_sup = torch.any(pass_sup, dim=1)  # (Cb, n_super)
    score = torch.where(any_sup, -tn_sup, -_BIG)
    sup_score, sup_ids = _top_k_desc(score, cs)
    sup_valid = sup_score > -_BIG
    sat0 = torch.sum(any_sup, dim=1) > cs
    return bounds, sup_ids, sup_valid, n_hi_b, sat0


def _group_box_tests(bounds, boxes):
    """Sub-block cone tests against grouped boxes (Cb, K, G, 6), OR over
    sub-blocks. Returns (any (Cb, K, G), tn (Cb, K, G))."""
    oc, oh, axis, tan_th, t_hi = bounds
    Cb, K, G, _ = boxes.shape
    bf = boxes.reshape(Cb, 1, K * G, 6)
    pass_b, tn_b, _ = _cone_box_test(
        oc[:, :, None], oh[:, :, None], axis[:, :, None], tan_th[:, :, None],
        t_hi[:, :, None], bf[..., 0:3], bf[..., 3:6],
    )  # (Cb, R, K*G)
    tn = torch.amin(torch.where(pass_b, tn_b, _BIG), dim=1).reshape(Cb, K, G)
    return torch.any(pass_b, dim=1).reshape(Cb, K, G), tn


def _chunk_cull_tests(bins, ob, db, t_min_b, t_max_b, cs, sub_blocks):
    """Box-test phase of the two-level chunk cull: bounds + level 0 +
    level-1 bin tests over the cs candidate supers. Returns (valid_bin
    (Cb, cs*S), gbin, tn_flat, n_hi_b, sat0) for :func:`_chunk_select`."""
    Cb = ob.shape[0]
    S = bins.bins_per_super
    bounds, sup_ids, sup_valid, n_hi_b, sat0 = _chunk_level0(
        bins, ob, db, t_min_b, t_max_b, cs, sub_blocks)
    sub = _bins_by_super(bins)[sup_ids]  # (Cb, cs, S, 6)
    any_bin, tn_bin = _group_box_tests(bounds, sub)  # (Cb, cs, S)
    gbin = _global_bin_ids(sup_ids, S)
    valid_bin = (any_bin & sup_valid[..., None] & (gbin < bins.n_bins)).reshape(Cb, cs * S)
    tn_flat = torch.clamp(tn_bin.reshape(Cb, cs * S), min=0.0)
    return valid_bin, gbin.reshape(Cb, cs * S), tn_flat, n_hi_b, sat0


def _chunk_select(bins, valid_bin, gbin, tn_flat, n_hi_b, cb):
    """Selection phase of the cull: the cb nearest valid bins per block.
    Returns (cand_bin (Cb, cb), cand_count (Cb,), cand_tnear (Cb, cb))."""
    id_bits = max(1, (bins.n_bins - 1).bit_length())
    if id_bits <= 20:
        # the bin id rides in the low mantissa bits of the (positive) entry
        # distance: ONE int top-k selects ids and distances together; keys
        # are unique, so the tie order of torch.topk does not matter.
        # Truncation only rounds tnear down — still a conservative bound.
        idm = (1 << id_bits) - 1
        tb = tn_flat.view(torch.int32)
        key = torch.where(valid_bin, (tb & ~idm) | gbin, _SENTINEL_KEY)
        kmin = torch.topk(key, cb, dim=1, largest=False, sorted=True).values
        cand_ok = kmin != _SENTINEL_KEY
        cand_bin = torch.where(cand_ok, kmin & idm, -1)
        cand_tnear = torch.where(
            cand_ok, (kmin & ~idm).view(torch.float32) / n_hi_b[:, None], _BIG)
    else:  # ids don't fit the mantissa — sort scores and carry ids along
        bscore = torch.where(valid_bin, -tn_flat, -_BIG)
        cand_score, cand_pos = _top_k_desc(bscore, cb)
        cand_bin = torch.where(cand_score > -_BIG, torch.gather(gbin, 1, cand_pos), -1)
        cand_tnear = torch.where(cand_bin >= 0, -cand_score / n_hi_b[:, None], _BIG)
    cand_count = torch.sum(cand_bin >= 0, dim=1).to(torch.int32)
    return cand_bin.to(torch.int32).contiguous(), cand_count, cand_tnear.contiguous()


def _chunk_candidates(bins, ob, db, t_min_b, t_max_b, cs, cb, sub_blocks):
    """Per-sub-block chunk cull: the contract of :func:`_build_candidates`,
    tighter (a union of R narrow cones instead of one fat block cone).

    Returns (cand_bin (Cb, cb), cand_count (Cb,), cand_tnear (Cb, cb), sat
    (Cb,) bool — True when a budget level truncated this block's candidate
    set)."""
    valid_bin, gbin, tn_flat, n_hi_b, sat0 = _chunk_cull_tests(
        bins, ob, db, t_min_b, t_max_b, cs, sub_blocks)
    sat = sat0 | (torch.sum(valid_bin, dim=1) > cb)
    cand_bin, cand_count, cand_tnear = _chunk_select(
        bins, valid_bin, gbin, tn_flat, n_hi_b, cb)
    return cand_bin, cand_count, cand_tnear, sat


def _kernel_inputs(bins, o, d, t_min_r, t_max_r, block_size, c_super, c_bin,
                   block_chunk, sub_blocks):
    """Blocked rays and their candidate lists: exactly what
    :func:`cast_rays_binned` hands :func:`intersect_bins`.

    Returns ((ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear),
    sat): the kernel's inputs, and per block whether a budget truncated its
    candidate set."""
    Rb = block_size
    if Rb % sub_blocks:
        raise ValueError(f"block_size ({Rb}) must be a multiple of sub_blocks ({sub_blocks})")
    B = bins.bin_size
    if B & (B - 1):
        raise ValueError("bin_size must be a power of two (packed-key min)")
    cs, cb = _resolve_budgets(bins, c_super, c_bin)
    ob, db, t_min_b, t_max_b = _pad_rays(o, d, t_min_r, t_max_r, Rb)
    n_blk = ob.shape[0]
    dev = ob.device
    cand_bin = torch.empty((n_blk, cb), dtype=torch.int32, device=dev)
    cand_count = torch.empty((n_blk,), dtype=torch.int32, device=dev)
    cand_tnear = torch.empty((n_blk, cb), dtype=torch.float32, device=dev)
    sat = torch.empty((n_blk,), dtype=torch.bool, device=dev)
    for s in range(0, n_blk, block_chunk):
        sl = slice(s, s + block_chunk)
        cand_bin[sl], cand_count[sl], cand_tnear[sl], sat[sl] = _chunk_candidates(
            bins, ob[sl], db[sl], t_min_b[sl], t_max_b[sl], cs, cb, sub_blocks)
    return (ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear), sat


def cast_rays_binned(
    bins: TriangleBins,
    orig: Tensor,
    dirs: Tensor,
    t_min=0.0,
    t_max=NO_HIT_T,
    block_size: int = 128,
    c_super: int = 24,
    c_bin: int = 96,
    block_chunk: int = 256,
    flip_normals: bool = True,
    payload: "bool | str" = True,
    sub_blocks: int = 4,
    dir_groups: int = 0,
    sort_blocks: bool = False,
    c_mid: int = 0,
    c_hyper: int = 0,
    with_lossless: bool = False,
) -> RayHits:
    """Dense closest-hit query; rays (..., 3) on the bins' device.

    ``payload``: True/"select" and "index" give the same outputs (the
    winner's triangle row is gathered once per ray after the kernel);
    False/"none" is the occlusion query (t only, the packed-key t).
    ``block_chunk`` bounds the cull's intermediates and changes no result.
    Rays should come in a spatially coherent order (scan grids are)."""
    for name, value in (("dir_groups", dir_groups), ("sort_blocks", sort_blocks),
                        ("c_mid", c_mid), ("c_hyper", c_hyper),
                        ("with_lossless", with_lossless)):
        if value:
            raise NotImplementedError(f"cast_rays_binned: {name} is not ported yet")
    pmode = {True: "select", False: "none"}.get(payload, payload)
    if pmode not in ("select", "index", "none"):
        raise ValueError(f"unknown payload mode {payload!r}")
    o, d, t_min_r, t_max_r, batch_shape = _flat_rays(orig, dirs, t_min, t_max)
    n = o.shape[0]
    inputs, _ = _kernel_inputs(bins, o, d, t_min_r, t_max_r, block_size, c_super, c_bin,
                               block_chunk, sub_blocks)
    t_best_b, ref_b = intersect_bins(bins.tri, *inputs)
    t_best = t_best_b.reshape(-1)[:n]
    hit = (t_best < t_max_r) & (t_best < _BIG)
    out_shape = lambda x: x.reshape(batch_shape + tuple(x.shape[1:]))

    if pmode == "none":
        neg1 = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        zero3 = o.new_zeros((n, 3))
        return RayHits(
            t=out_shape(torch.where(hit, t_best, NO_HIT_T)), hit=out_shape(hit),
            prim_id=out_shape(neg1), inst_id=out_shape(neg1),
            point=out_shape(zero3), normal=out_shape(zero3),
        )

    # one row gather per ray resolves the winner's payload; misses read
    # zeros, like the JAX package's all-zero sentinel bin
    B = bins.bin_size
    ref = torch.where(hit, ref_b.reshape(-1)[:n], 0).to(torch.int64)
    base = (ref // B) * (14 * B) + ref % B
    flat = bins.tri.reshape(-1)
    comp = lambda k: torch.where(hit, flat[base + k * B], 0.0)
    nx, ny, nz = comp(9), comp(10), comp(11)
    d0 = nx * comp(0) + ny * comp(1) + nz * comp(2)

    # differentiable plane re-derivation of t, point and normal
    normal = torch.stack([nx, ny, nz], dim=-1)
    denom = nx * d[:, 0] + ny * d[:, 1] + nz * d[:, 2]
    safe_denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    num = d0 - (nx * o[:, 0] + ny * o[:, 1] + nz * o[:, 2])
    t_plane = num / safe_denom
    t_out = torch.where(hit, t_plane, NO_HIT_T)
    point = torch.where(hit[..., None], o + t_plane[..., None] * d, 0.0)
    if flip_normals:
        normal = normal * torch.where(denom > 0, -1.0, 1.0)[..., None]
    normal = torch.where(hit[..., None], normal, 0.0)
    ids = lambda k: torch.where(hit, comp(k), -1.0).to(torch.int32)
    return RayHits(
        t=out_shape(t_out), hit=out_shape(hit),
        prim_id=out_shape(ids(12)), inst_id=out_shape(ids(13)),
        point=out_shape(point), normal=out_shape(normal),
    )
