"""Block cull: the hand-written CUDA kernel and its plain PyTorch version.

The port of the block cull that the JAX package runs as XLA device code
inside its casts (``rmcl_tpu/ops/raycast_binned.py``): the per-sub-block
cone bounds of ``_block_bounds`` / ``_subblock_bounds`` and the factored
cull's ``fact_bounds`` / ``margin_sb_bounds`` with the scene-exit cap, then
the box tests and nearest-first selections of ``_chunk_level0`` (level 0
over all supers, or its ``c_hyper`` branch: hypers, then the selected
hypers' supers), ``_group_box_tests``, ``_chunk_cull_tests`` (or, with the
mid level, ``_chunk_cull_tests3``), ``_chunk_select`` and
``_chunk_candidates``. One kernel does all of it,
``rmcl_tpu_torch/csrc/cull_blocks.cu``; its header says what bounds it on
the card and what the design does about that. Three wrappers launch it:

* :func:`cull_rays`: blocks of rays ``(Cb, Rb, 3)`` with per-ray gates,
  split into R contiguous sub-blocks (the dense engine);
* :func:`cull_factored`: blocks of P pose origins x G shared directions
  (ray g*P + p), with the reuse margins (the factored engine);
* :func:`cull_blocks`: the back end alone, on cones computed beforehand.

Each has a plain version in this module (``*_reference``) that the CPU
takes: the bounds in plain tensor ops, then :func:`cull_blocks_reference`.
The bounds sum in one fixed order that the kernel repeats — three
components left to right (:func:`_dot3`), sums over rays as a halving tree
over a zero-padded power of two (:func:`_tree_sum`), ``1 / sqrt`` in place
of ``rsqrt`` — so the kernel, built without FMA contraction, agrees with
them bitwise.

Back-end contract (:func:`cull_blocks`): ``cones (Cb, R, 12)`` per block R
sub-block cones ``[oc(3), oh(3), axis(3), tan_th, t_hi, t_len]`` (``t_hi``
the reach along the axis, ``t_len`` along a ray: see
:func:`_cone_box_test`); ``fat (Cb, 12)`` one block cone for the coarse levels (used only when ``ch > 0``);
``n_hi (Cb,)`` the blocks' direction-length scale; boxes ``bin_aabb
(n_bins, 6)``, ``super_aabb (n_super, 6)``, ``hyper_aabb (n_hyper, 6)``
with ``S`` bins per super and ``H`` supers per hyper; budgets ``ch`` (0: no
hyper level), ``cs``, ``cb``; optionally the mid level, ``mid_aabb
(n_super * S / M, 6)`` with ``M`` bins a mid and budget ``cm`` (0: none),
between the supers and the bins. Every wrapper returns ``cand_bin (Cb, cb)``
int32 (-1 padding, nearest first), ``cand_count (Cb,)`` int32,
``cand_tnear (Cb, cb)`` f32 (3e38 padding) and ``sat (Cb,)`` bool, True
where a budget truncated the block's set.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from rmcl_tpu_torch import _build

Tensor = torch.Tensor

_BIG = 3.0e38
_SENTINEL_KEY = 0x7FFFFFF0
CONE_WIDTH = 12  # oc(3), oh(3), axis(3), tan_th, t_hi, t_len


def _dot3(x: Tensor, y: Tensor) -> Tensor:
    """Dot product over the last axis of 3, summed in a fixed order (the
    kernel's), so that CPU and card round alike."""
    return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]


def _norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis of 3 (the kernel's order)."""
    return torch.sqrt(_dot3(x, x))


def _tree_sum(x: Tensor, dim: int) -> Tensor:
    """Sum over ``dim`` in the kernel's order: zero-padded to a power of
    two, then halved pairwise (element j adds element j + w)."""
    n = x.shape[dim]
    p2 = 1 << max(0, (n - 1).bit_length())
    if p2 > n:
        pad = list(x.shape)
        pad[dim] = p2 - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    while p2 > 1:
        p2 //= 2
        x = x.narrow(dim, 0, p2) + x.narrow(dim, p2, p2)
    return x.squeeze(dim)


def _top_k_desc(score: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` on float scores: k largest, ties to the lower index
    (``torch.topk`` promises no tie order; a stable sort does)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cone_box_test(oc, oh, a, tan_th, t_hi, bmin, bmax, t_len=None):
    """Conservative (origin-box x direction-cone) vs AABB test.

    The ray block is the Minkowski sum of an origin box (center ``oc``,
    half-extents ``oh``) and a direction cone (unit axis ``a``, ``tan_th``
    = tan of the max angular deviation); intersected with the ball bound.
    Never false-culls.

    Two reaches: ``t_hi`` bounds a ray's distance along the axis (it sizes
    the cone's radii), ``t_len`` its length (default ``t_hi``). The slab
    interval is axial; ``d_near``, the boxes' Euclidean distance, bounds a
    ray's length, so a ray at most theta_max off the axis enters the box at
    an axial distance of at least ``d_near * cos(theta_max)``: the slab is
    held against that, never against ``d_near`` itself (JAX's
    ``_cone_box_test`` compares the two directly and drops flat boxes seen
    off-axis). The entry distance returned, ``max(slab tn, d_near)``, is
    JAX's: a lower bound on the ray's length, held against ``t_len``.

    Shapes: oc/oh/a (..., 1, 3), tan_th/t_hi/t_len (..., 1), bmin/bmax (..., K, 3).
    Returns (pass (..., K), t_near (..., K) >= +0.0, t_far (..., K))."""
    if t_len is None:
        t_len = t_hi
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
    cos_th = 1.0 / torch.sqrt(1.0 + tan_th * tan_th)

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
    tn_s, tf = slab(r1)
    tn = torch.maximum(tn_s, d_near)
    tf = torch.minimum(tf, d_far)
    ok = (torch.maximum(tn_s, d_near * cos_th) <= tf) & (tf >= 0.0) & (tn <= t_len)
    # +0.0 for every non-positive entry: the packed keys take tn's bits, and
    # torch.clamp keeps the sign of -0.0
    return ok, torch.where(tn > 0.0, tn, 0.0), tf


def pack_cones(oc, oh, axis, tan_th, t_hi, t_len) -> Tensor:
    """Cone bounds (L..., 3) x 3 and (L...,) x 3 as one (L..., 12) tensor."""
    return torch.cat([oc, oh, axis, tan_th[..., None], t_hi[..., None], t_len[..., None]],
                     dim=-1).contiguous()


# --- the cone bounds: plain versions of the kernel's front ends ---

# plain-version rays per step of blocks: bounds the bounds' intermediates
# (every block is culled on its own, so steps change no result)
_REF_RAYS_PER_STEP = 1 << 21


def _unit(v: Tensor) -> Tensor:
    """v / |v| over the last axis of 3, as the kernel forms it."""
    return v * (1.0 / torch.sqrt(torch.clamp(_dot3(v, v), min=1e-30)))[..., None]


def _unit_dirs(d: Tensor) -> Tuple[Tensor, Tensor]:
    """(|d|, d / |d|) of directions (..., 3), as the kernel forms them."""
    nrm = torch.sqrt(torch.clamp(_dot3(d, d), min=1e-30))
    return nrm, d * (1.0 / nrm)[..., None]


def _tan_of(ca: Tensor) -> Tensor:
    """tan of the half-angle whose cosine is ca; a degenerate spread (>=
    ~87 deg) gives a huge tan, a conservative pass-all."""
    ca = torch.clamp(ca, 0.05, 1.0)
    return torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0)) / ca


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
    nrm, dn = _unit_dirs(db)
    a = _unit(_tree_sum(torch.where(live, dn, 0.0), 1))
    tan_th = _tan_of(torch.amin(torch.where(live[..., 0], _dot3(dn, a[:, None, :]), 1.0), dim=1))
    # parametric t reaches geometric distance t*|d|: bound the reach by
    # max(t_max*|d|)
    n_hi = torch.amax(torch.where(live[..., 0], nrm, 1e-30), dim=1)
    t_hi = torch.amax(torch.where(live[..., 0], t_max_b * nrm, 0.0), dim=1)
    return oc, oh, a, tan_th, t_hi, n_hi, ~any_live


def _subblock_bounds(ob, db, t_min_b, t_max_b, sub_blocks):
    """Per-sub-block cone/box bounds: rays (n_blk, Rb, 3) split into
    ``sub_blocks`` contiguous groups; outputs lead with (n_blk, R)."""
    n_blk, Rb, _ = ob.shape
    R = sub_blocks
    rs = lambda x: x.reshape((n_blk * R, Rb // R) + tuple(x.shape[2:]))
    out = _block_bounds(rs(ob), rs(db), rs(t_min_b), rs(t_max_b))
    return tuple(x.reshape((n_blk, R) + tuple(x.shape[1:])) for x in out)


def _factored_bounds(o_c, d_c, alive_c, t_min_s, t_max_s, sub_blocks, origin_margin,
                     dir_margin):
    """The raw sub-block bounds function ``r -> (oc, oh, axis, tan_th, t_hi,
    n_hi, dead)`` of factored blocks (Cb, P, 3) x (Cb, G, 3) (ray g*P + p),
    with the margins applied."""
    Cb, P, _ = o_c.shape
    G = d_c.shape[1]
    Rb = P * G
    tan_dm = math.tan(dir_margin) if dir_margin else 0.0

    def widen_cone(tan_th):
        """tan(theta + dir_margin), conservatively pass-all past ~89 deg."""
        if not tan_dm:
            return tan_th
        den = 1.0 - tan_th * tan_dm
        return torch.where(den > 1e-4, (tan_th + tan_dm) / torch.clamp(den, min=1e-4), 1e4)

    def fact_bounds(r):
        """Sub-block bounds straight from the factored structure (sub-block
        r = directions [r*G/R, ...) x all origins)."""
        live = alive_c > 0.0
        o_lo = torch.where(live[:, None], torch.amin(o_c, dim=1), 0.0)
        o_hi = torch.where(live[:, None], torch.amax(o_c, dim=1), 0.0)
        oc1 = 0.5 * (o_lo + o_hi)
        oh1 = 0.5 * (o_hi - o_lo)
        if origin_margin:
            oh1 = oh1 + torch.where(live[:, None], origin_margin, 0.0)
        oc = oc1[:, None].expand(Cb, r, 3)
        oh = oh1[:, None].expand(Cb, r, 3)
        nrm, dn = _unit_dirs(d_c.reshape(Cb, r, G // r, 3))
        a = _unit(_tree_sum(dn, 2))
        tan_th = widen_cone(_tan_of(torch.amin(_dot3(dn, a[:, :, None, :]), dim=2)))
        n_hi = torch.amax(nrm, dim=2)
        t_hi = torch.where(live, t_max_s, 0.0)[:, None] * n_hi
        dead = (~live)[:, None].expand(Cb, r)
        return oc, oh, a, tan_th, t_hi, n_hi, dead

    def margin_sb_bounds(r):
        """_subblock_bounds on the expanded rays, then the margins."""
        ob = o_c[:, None].expand(Cb, G, P, 3).reshape(Cb, Rb, 3)
        db = d_c[:, :, None].expand(Cb, G, P, 3).reshape(Cb, Rb, 3)
        tmin_b = o_c.new_full((Cb, Rb), t_min_s)
        tmax_b = (alive_c * t_max_s)[:, None].expand(Cb, Rb)
        oc, oh, a, tan_th, t_hi, n_hi, dead = _subblock_bounds(ob, db, tmin_b, tmax_b, r)
        oh = oh + torch.where(dead[..., None], 0.0, origin_margin)
        return oc, oh, a, widen_cone(tan_th), t_hi, n_hi, dead

    return fact_bounds if G % sub_blocks == 0 else margin_sb_bounds


def _dead_axis(axis, dead):
    x_axis = axis.new_tensor([1.0, 0.0, 0.0])
    return torch.where(dead[..., None], x_axis, axis)


def _scene_exit_cap(bins, oc, oh, axis, tan_th, t_hi):
    """Cap each block's reach at its conservative exit from the scene box.
    Bounds have a leading batch shape L; returns (t_hi, t_len) (L): the
    reach along the axis, capped at the scene's axial exit, and along a
    ray, capped at that exit over cos(theta_max) (no ray leaves the scene
    later); each is at least the uncapped reach where that is smaller."""
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
    far = scene_far[..., 0]
    sec = torch.sqrt(1.0 + tan_th * tan_th)
    t_len = torch.minimum(t_hi, (torch.where(far > 0.0, far, 0.0) * sec) * 1.0001 + 1e-3)
    return torch.minimum(t_hi, far * 1.0001 + 1e-3), t_len


def _capped_bounds(bins, raw):
    """Sub-block bounds ``raw = (oc, oh, axis, tan_th, t_hi, n_hi, dead)``
    (Cb, r, ...) with dead sub-blocks parked and every reach capped at the
    scene's exit: (cones (Cb, r, 12), n_hi (Cb, r))."""
    oc, oh, axis, tan_th, t_hi, n_hi, dead = raw
    axis = _dead_axis(axis, dead)
    t_hi = torch.where(dead, 0.0, t_hi)
    t_hi, t_len = _scene_exit_cap(bins, oc, oh, axis, tan_th, t_hi)
    return pack_cones(oc, oh, axis, tan_th, t_hi, t_len), n_hi


def _cull_args(bins, raw_bounds, sub_blocks, cs, cb, ch, cm=0):
    """The arguments of :func:`cull_blocks` for bounds from
    ``raw_bounds(r)`` (r cones per block). With the hyper level (ch > 0),
    the coarse levels use ONE fat block cone (r = 1) and the sub-block cones
    stay for the mid and bin tests, as in the JAX package."""
    cones, n_hi = _capped_bounds(bins, raw_bounds(sub_blocks))
    fat = None
    if ch:
        fat = (_capped_bounds(bins, raw_bounds(1))[0] if sub_blocks > 1 else cones)[:, 0]
        fat = fat.contiguous()
    return (cones, fat, torch.amax(n_hi, dim=1).contiguous(), *_bins_boxes(bins, ch, cs, cb, cm))


def _by_blocks(fn, step, *blocked):
    """``fn(*blocked)`` over steps of ``step`` blocks of the leading axis,
    concatenated."""
    n_blk = blocked[0].shape[0]
    if n_blk <= step:
        return fn(*blocked)
    parts = [fn(*(x[s:s + step] for x in blocked)) for s in range(0, n_blk, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _group_box_tests(cones: Tensor, boxes: Tensor) -> Tuple[Tensor, Tensor]:
    """Every cone of a block against boxes (Cb or 1, K, 6), OR over the
    cones. Returns (any (Cb, K), tn (Cb, K): the least t_near over the
    passing cones, 3e38 where none passes)."""
    c = cones[:, :, None]
    pass_b, tn_b, _ = _cone_box_test(c[..., 0:3], c[..., 3:6], c[..., 6:9], c[..., 9],
                                     c[..., 10], boxes[:, None, :, 0:3], boxes[:, None, :, 3:6],
                                     c[..., 11])
    return torch.any(pass_b, dim=1), torch.amin(torch.where(pass_b, tn_b, _BIG), dim=1)


def _select(valid: Tensor, tn: Tensor, ids: Tensor, n_ids: int, k: int,
            packed: bool) -> Tuple[Tensor, Tensor]:
    """The k nearest valid entries, nearest first, as the JAX package picks
    them. Packed: one int top-k over ``(bits(tn) & ~idm) | id`` (unique
    keys; tn truncated down). Otherwise float scores, ties to the lower
    position. Returns (ids (Cb, k) with -1 padding, tn (Cb, k), 3e38
    padding)."""
    if packed:
        idm = (1 << max(1, (n_ids - 1).bit_length())) - 1
        key = torch.where(valid, (tn.view(torch.int32) & ~idm) | ids, _SENTINEL_KEY)
        kmin = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        ok = kmin != _SENTINEL_KEY
        return (torch.where(ok, kmin & idm, -1),
                torch.where(ok, (kmin & ~idm).view(torch.float32), _BIG))
    score, pos = _top_k_desc(torch.where(valid, -tn, -_BIG), k)
    ok = score > -_BIG
    return torch.where(ok, torch.gather(ids, 1, pos), -1), torch.where(ok, -score, _BIG)


def _packs(n_ids: int) -> bool:
    """Whether ids below n_ids fit the 20 low mantissa bits of a key."""
    return max(1, (n_ids - 1).bit_length()) <= 20


def _pad_rows(boxes: Tensor, n: int) -> Tensor:
    """Boxes zero-padded to n rows (whole groups)."""
    pad = n - boxes.shape[0]
    return torch.cat([boxes, boxes.new_zeros((pad, 6))], 0) if pad else boxes


def _level0(cones, fat, super_aabb, hyper_aabb, H, ch, cs):
    """The super selection: (sup_ids (Cb, cs) with -1 padding, sat0 (Cb,))."""
    Cb = cones.shape[0]
    dev = cones.device
    n_super = super_aabb.shape[0]
    if not ch:
        # sub-block cones x all supers, float scores
        any_sup, tn_sup = _group_box_tests(cones, super_aabb[None])
        ids = torch.arange(n_super, dtype=torch.int32, device=dev).expand(Cb, n_super)
        sup_ids, _ = _select(any_sup, tn_sup, ids, n_super, cs, packed=False)
        return sup_ids, torch.sum(any_sup, dim=1) > cs
    # level -1: the fat block cone x hypers, then the selected hypers' supers
    n_hyper = hyper_aabb.shape[0]
    fat1 = fat[:, None]
    anyh, tnh = _group_box_tests(fat1, hyper_aabb[None])
    hids = torch.arange(n_hyper, dtype=torch.int32, device=dev).expand(Cb, n_hyper)
    hyp_sel, _ = _select(anyh, tnh, hids, n_hyper, ch, _packs(n_hyper))
    safe_hyp = hyp_sel.clamp(min=0)
    boxes = _pad_rows(super_aabb, n_hyper * H).reshape(n_hyper, H, 6)[safe_hyp]
    any_sup, tn_sup = _group_box_tests(fat1, boxes.reshape(Cb, ch * H, 6))
    gsup = safe_hyp[..., None] * H + torch.arange(H, dtype=torch.int32, device=dev)
    valid_sup = (any_sup.reshape(Cb, ch, H) & (hyp_sel >= 0)[..., None]
                 & (gsup < n_super)).reshape(Cb, ch * H)
    sup_ids, _ = _select(valid_sup, tn_sup, gsup.reshape(Cb, ch * H), n_super, cs,
                         _packs(n_super))
    sat0 = (torch.sum(anyh, dim=1) > ch) | (torch.sum(valid_sup, dim=1) > cs)
    return sup_ids, sat0


def _mid_level(cones, sup_ids, mid_aabb, n_bins, S, M, cm):
    """The mid level (``_chunk_cull_tests3``'s level 1a): the R cones x
    the S / M mids of each selected super, mids made only of padding bins
    excluded, the cm nearest kept. Returns (mid_sel (Cb, cm) with -1
    padding, sat (Cb,): more than cm mids passed)."""
    Cb, cs = sup_ids.shape
    Sm = S // M
    n_mid = mid_aabb.shape[0]
    safe = sup_ids.clamp(min=0)
    boxes = mid_aabb.reshape(n_mid // Sm, Sm, 6)[safe]  # (Cb, cs, Sm, 6)
    any_mid, tn_mid = _group_box_tests(cones, boxes.reshape(Cb, cs * Sm, 6))
    gmid = safe[..., None] * Sm + torch.arange(Sm, dtype=torch.int32, device=cones.device)
    valid = (any_mid.reshape(Cb, cs, Sm) & (sup_ids >= 0)[..., None]
             & (gmid * M < n_bins)).reshape(Cb, cs * Sm)
    mid_sel, _ = _select(valid, tn_mid, gmid.reshape(Cb, cs * Sm), n_mid, cm, _packs(n_mid))
    return mid_sel, torch.sum(valid, dim=1) > cm


def _level1_groups(cones, fat, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, mid_aabb, M,
                   cm):
    """The groups whose bins level 1 tests: (ids (Cb, k) with -1 padding,
    group size, number of groups, sat of the levels above) — the selected
    supers (S bins each), or with the mid level (cm > 0) the selected mids
    (M bins each)."""
    sup_ids, sat0 = _level0(cones, fat, super_aabb, hyper_aabb, H, ch, cs)
    if not cm:
        return sup_ids, S, super_aabb.shape[0], sat0
    mid_sel, sat_mid = _mid_level(cones, sup_ids, mid_aabb, bin_aabb.shape[0], S, M, cm)
    return mid_sel, M, mid_aabb.shape[0], sat0 | sat_mid


def cull_tests(cones: Tensor, fat: Optional[Tensor], bin_aabb: Tensor, super_aabb: Tensor,
               hyper_aabb: Optional[Tensor], S: int, H: int, ch: int, cs: int,
               mid_aabb: Optional[Tensor] = None, M: int = 1, cm: int = 0) -> Tensor:
    """Cone-box tests per block that the kernel runs on these inputs (the
    work its bound counts): every hyper or super of level 0, the selected
    hypers' supers, R tests for each mid of a selected super (those not all
    padding) with the mid level, and R tests for each bin of a selected
    super or mid."""
    Cb, R, _ = cones.shape
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    groups, g, _, _ = _level1_groups(cones, fat, bin_aabb, super_aabb, hyper_aabb, S, H, ch,
                                     cs, mid_aabb, M, cm)
    bins_of = torch.clamp(n_bins - groups.clamp(min=0).long() * g, 0, g)
    tests = R * torch.sum(torch.where(groups >= 0, bins_of, 0), dim=1)
    if cm:
        sup_ids, _ = _level0(cones, fat, super_aabb, hyper_aabb, H, ch, cs)
        Sm = S // M
        n_mid_ids = -(-n_bins // M)
        mids_of = torch.clamp(n_mid_ids - sup_ids.clamp(min=0).long() * Sm, 0, Sm)
        tests = tests + R * torch.sum(torch.where(sup_ids >= 0, mids_of, 0), dim=1)
    if not ch:
        return tests + R * n_super
    n_hyper = hyper_aabb.shape[0]
    anyh, tnh = _group_box_tests(fat[:, None], hyper_aabb[None])
    hids = torch.arange(n_hyper, dtype=torch.int32, device=cones.device).expand(Cb, n_hyper)
    hyp_sel, _ = _select(anyh, tnh, hids, n_hyper, ch, _packs(n_hyper))
    sups_of = torch.clamp(n_super - hyp_sel.clamp(min=0).long() * H, 0, H)
    return tests + n_hyper + torch.sum(torch.where(hyp_sel >= 0, sups_of, 0), dim=1)


def _check_tensors(dev, **named):
    """Each ``name=(tensor, shape)`` float32, contiguous, on ``dev`` and of
    that shape (any shape for None)."""
    for name, (x, shape) in named.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_boxes(dev, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb=None, M=1,
                 cm=0):
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    boxes = {"bin_aabb": (bin_aabb, (n_bins, 6)), "super_aabb": (super_aabb, (n_super, 6))}
    if cm:
        if mid_aabb is None:
            raise ValueError("the mid level (cm > 0) needs mid_aabb")
        if M < 1 or S % M or S // M < 2:
            raise ValueError(f"the mid level needs M={M} to divide S={S} at least twice")
        Sm = S // M
        boxes["mid_aabb"] = (mid_aabb, (n_super * Sm, 6))
        if not 1 <= cm <= n_super * Sm or cb > cm * M:
            raise ValueError(f"mid budget cm={cm} out of range (cb={cb}, M={M})")
    if ch:
        if hyper_aabb is None:
            raise ValueError("the hyper level (ch > 0) needs hyper_aabb")
        boxes["hyper_aabb"] = (hyper_aabb, (hyper_aabb.shape[0], 6))
        if not 1 <= ch <= hyper_aabb.shape[0]:
            raise ValueError(f"ch={ch} must be in [1, n_hyper={hyper_aabb.shape[0]}]")
        if cs > ch * H:
            raise ValueError(f"cs={cs} exceeds the ch*H={ch * H} supers of the hypers kept")
    _check_tensors(dev, **boxes)
    if not (1 <= cs <= n_super and 1 <= cb <= min(n_bins, cs * S)):
        raise ValueError(f"budgets cs={cs}, cb={cb} out of range")
    if n_super * S < n_bins:
        raise ValueError("S bins per super do not cover the bins")


def _check_inputs(cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb,
                  mid_aabb=None, M=1, cm=0):
    if cones.dim() != 3 or cones.shape[2] != CONE_WIDTH:
        raise ValueError(f"cones must be (Cb, R, {CONE_WIDTH}), got {tuple(cones.shape)}")
    Cb = cones.shape[0]
    if ch and fat is None:
        raise ValueError("the hyper level (ch > 0) needs fat")
    extra = {"fat": (fat, (Cb, CONE_WIDTH))} if ch else {}
    _check_tensors(cones.device, cones=(cones, None), n_hi=(n_hi, (Cb,)), **extra)
    _check_boxes(cones.device, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb, M,
                 cm)


def _bins_boxes(bins, ch, cs, cb, cm=0):
    """The back end's box arguments from TriangleBins."""
    return (bins.bin_aabb, bins.super_aabb, bins.hyper_aabb, bins.bins_per_super,
            bins.supers_per_hyper, ch, cs, cb, bins.mid_aabb if cm else None,
            bins.bins_per_mid, cm)


def _check_scene(dev, bins):
    _check_tensors(dev, aabb_min=(bins.aabb_min, (3,)), aabb_max=(bins.aabb_max, (3,)))


# --- the kernel ---

_PTRS = ("cones", "fat", "n_hi", "o", "d", "t_min", "t_max", "alive", "scene_min", "scene_max",
         "bin_aabb", "super_aabb", "hyper_aabb", "mid_aabb", "cand_bin", "cand_count",
         "cand_tnear", "sat")
_INTS = ("mode", "Cb", "R", "Rb", "P", "G", "n_bins", "n_super", "n_hyper", "S", "H", "ch",
         "cs", "cb", "M", "Sm", "cm", "n_mid_ids", "threads", "key_slots", "smem_bytes", "stream")
_UINTS = ("idm_hyp", "idm_sup", "idm_bin", "idm_mid")
_FLAGS = ("hyp_packed", "sup_packed", "bin_packed", "mid_packed")
_FLOATS = ("t_min_s", "t_max_s", "origin_margin", "tan_dm")
# the kernel's front ends
_MODES = {"cones": 0, "rays": 1, "expanded": 2, "factored": 3}
# cones a block the kernel holds in registers (4 a lane)
MAX_CONES = 128


class _CullArgs(ctypes.Structure):
    """The kernel's argument struct (``CullArgs`` in the source), field for
    field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_uint) for n in _UINTS] + [(n, ctypes.c_int) for n in _FLAGS]
                + [(n, ctypes.c_float) for n in _FLOATS])


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_cull``), built on first use."""
    fn = _build.load_library("cull_blocks").rmcl_cull
    fn.argtypes = [ctypes.POINTER(_CullArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) of each of K3's builds (``kBuilds`` in ``csrc/cull_blocks.cu``),
    by ``cudaFuncGetAttributes``: ``{"K3 CPL=1 T=128 short": (regs,
    local), ...}``, named by cones a lane, threads a CTA, "shared" where the
    lane's cones share one origin box and "short" where the build holds no
    streamed passes. Raises where a build holds more static shared memory
    than the launch plan reserves. Needs a card."""
    fn = _build.load_library("cull_blocks").rmcl_cull_attrs
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    out = {}
    flags = (ctypes.c_int * 4)()
    regs, local, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    i = 0
    while fn(i, flags, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(static)) == 0:
        threads, cpl, shared, stream = flags
        if static.value > _K3_STATIC_SMEM:
            raise RuntimeError(f"K3 holds {static.value} bytes of static shared memory, more "
                               f"than the launch plan's {_K3_STATIC_SMEM}")
        name = (f"K3 CPL={cpl} T={threads}" + (" shared" if shared else "")
                + ("" if stream else " short"))
        out[name] = (regs.value, local.value)
        i += 1
    if not out:
        raise RuntimeError("cudaFuncGetAttributes failed for K3's first build")
    return out


# shared memory one CTA may hold on an H100 (232,448 bytes)
_SMEM_CAP = 232448
# K3's static shared memory (the select's scratch, ~1.1 KB), with room to
# spare; kernel_registers checks it
_K3_STATIC_SMEM = 2048
# K3's CTA widths: the narrow one for grids of _K3_BIG_GRID blocks or more
K3_THREADS, K3_BIG_GRID_THREADS = 256, 128
_K3_BIG_GRID = 1024
# the most keys a level's stage holds; a level that passes more is streamed
_K3_STAGE_MAX = 16384
# bytes of the kernel's cone record (struct Cone: 16 floats) and of its
# bounds tree's channels a slot
_K3_CONE_BYTES = 64
_K3_CHANNELS = 13


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def cull_launch_plan(Cb: int, R: int, n_rays: int, n_super: int, S: int, cs: int, cb: int,
                     ch: int = 0, n_hyper: int = 0, H: int = 1, cm: int = 0,
                     M: int = 1) -> Tuple[int, int, int, bool]:
    """K3's launch shape for Cb blocks of R cones (``n_rays`` rays a block
    in its bounds tree; 0 for precomputed cones) on n_super supers of S
    bins (n_hyper hypers of H supers, mids of M bins) at budgets (ch, cs,
    cm, cb): ``(threads a CTA, key slots, dynamic shared bytes, stream)``,
    the bytes those of ``shared_bytes``'s layout in
    ``csrc/cull_blocks.cu`` (the kernel refuses others). The key slots
    hold a level's kept list and past it the level's stage, up to
    ``_K3_STAGE_MAX`` keys where the level is wider than its list, cut to
    what fits (the region also holds the bounds tree before the first
    level); a level that may pass more keys than its stage is streamed, so
    no level width is refused, and ``stream`` says whether any may (the
    launch then takes the build with the streamed passes, else the one
    without, which holds fewer registers). Raises ``ValueError`` naming a
    kept list that does not fit one CTA."""
    fixed = ((R + 1) * _K3_CONE_BYTES + 16 * R
             + 4 * ((ch if ch > 0 else 1) + cs + (cm if cm > 0 else 1)))
    most = (_SMEM_CAP - _K3_STATIC_SMEM - fixed) // 8
    if cm:
        levels = [("mid", cs * (S // M), cm), ("bin", cm * M, cb)]
    else:
        levels = [("bin", cs * S, cb)]
    levels = ([("hyper", n_hyper, ch), ("super", ch * H, cs)] if ch
              else [("super", n_super, cs)]) + levels
    for name, _, keep in levels:
        if keep > most:
            raise ValueError(f"the {name} level's kept list of {keep} keys does not fit a "
                             f"CTA's shared memory: it holds at most {most} keys")
    slots = min(most, max(keep + (min(n, _K3_STAGE_MAX) if n > keep else 0)
                          for _, n, keep in levels))
    tree = 0
    if n_rays:
        tree = max(R * _pow2(n_rays // R), _pow2(n_rays)) * _K3_CHANNELS
    region = (max(2 * slots, tree) + 1) & ~1
    if 4 * region + fixed > _SMEM_CAP - _K3_STATIC_SMEM:
        raise ValueError(f"the bounds of {n_rays} rays a block do not fit a CTA's shared memory")
    threads = K3_BIG_GRID_THREADS if Cb >= _K3_BIG_GRID else K3_THREADS
    stream = any(n > keep and n > slots - keep for _, n, keep in levels)
    return threads, slots, 4 * region + fixed, stream


def _idm(n: int) -> int:
    return (1 << max(1, (n - 1).bit_length())) - 1


def _launch(mode, Cb, R, boxes, tensors, **scalars):
    """One launch of the kernel on the boxes' card with front end ``mode``;
    ``tensors`` name its inputs, ``scalars`` its other fields. Returns
    (cand_bin, cand_count, cand_tnear, sat)."""
    bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb, M, cm = boxes
    dev = bin_aabb.device
    if dev.type != "cuda":
        raise ValueError(f"the cull runs on cuda or cpu tensors, not {dev}")
    if R > MAX_CONES:
        raise ValueError(f"the kernel takes at most {MAX_CONES} sub-blocks a block, not {R}")
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    n_hyper = hyper_aabb.shape[0] if ch else 0
    n_mid = mid_aabb.shape[0] if cm else 1
    n_rays = 0 if mode == "cones" else (scalars["G"] if mode == "factored" else scalars["Rb"])
    threads, key_slots, smem_bytes, stream = cull_launch_plan(Cb, R, n_rays, n_super, S, cs,
                                                              cb, ch, n_hyper, H, cm, M)
    outs = dict(cand_bin=torch.empty((Cb, cb), dtype=torch.int32, device=dev),
                cand_count=torch.empty((Cb,), dtype=torch.int32, device=dev),
                cand_tnear=torch.empty((Cb, cb), dtype=torch.float32, device=dev),
                sat=torch.empty((Cb,), dtype=torch.bool, device=dev))
    args = _CullArgs(mode=_MODES[mode], Cb=Cb, R=R, n_bins=n_bins, n_super=n_super,
                     n_hyper=n_hyper, S=S, H=H, ch=ch, cs=cs, cb=cb,
                     M=M, Sm=S // M if cm else 0, cm=cm, n_mid_ids=-(-n_bins // M) if cm else 0,
                     idm_hyp=_idm(max(n_hyper, 1)), idm_sup=_idm(n_super), idm_bin=_idm(n_bins),
                     idm_mid=_idm(n_mid), hyp_packed=int(_packs(max(n_hyper, 1))),
                     sup_packed=int(_packs(n_super)), bin_packed=int(_packs(n_bins)),
                     mid_packed=int(_packs(n_mid)), threads=threads, key_slots=key_slots,
                     smem_bytes=smem_bytes, stream=int(stream),
                     **scalars)
    ptrs = dict(tensors, bin_aabb=bin_aabb, super_aabb=super_aabb,
                hyper_aabb=hyper_aabb if ch else None, mid_aabb=mid_aabb if cm else None,
                **outs)
    for name, x in ptrs.items():
        setattr(args, name, None if x is None else x.data_ptr())
    with torch.cuda.device(dev):
        err = _kernel()(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cull kernel launch failed: cudaError {err}")
    return outs["cand_bin"], outs["cand_count"], outs["cand_tnear"], outs["sat"]


def cull_blocks(cones: Tensor, fat: Optional[Tensor], n_hi: Tensor, bin_aabb: Tensor,
                super_aabb: Tensor, hyper_aabb: Optional[Tensor], S: int, H: int, ch: int,
                cs: int, cb: int, mid_aabb: Optional[Tensor] = None, M: int = 1, cm: int = 0):
    """Nearest-first candidate bins per block from cones computed
    beforehand (the back end alone; the module's contract).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`cull_blocks_reference`. ``cull_blocks.launches`` counts the
    kernel launches."""
    boxes = (bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb, M, cm)
    _check_inputs(cones, fat, n_hi, *boxes)
    if cones.device.type == "cpu":
        return cull_blocks_reference(cones, fat, n_hi, *boxes)
    out = _launch("cones", cones.shape[0], cones.shape[1], boxes,
                  dict(cones=cones, fat=fat if ch else None, n_hi=n_hi))
    cull_blocks.launches += 1
    return out


cull_blocks.launches = 0


def cull_rays(bins, ob: Tensor, db: Tensor, t_min_b: Tensor, t_max_b: Tensor,
              sub_blocks: int, cs: int, cb: int, ch: int = 0, cm: int = 0):
    """Nearest-first candidate bins of ray blocks ``(Cb, Rb, 3)`` with gates
    ``(Cb, Rb)`` (rays with t_max <= t_min are inert), each split into
    ``sub_blocks`` contiguous sub-blocks, on ``bins`` (TriangleBins): the
    bounds and the cull in one launch. ``cm`` > 0 adds the mid level.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`cull_rays_reference`. ``cull_rays.launches`` counts the kernel
    launches."""
    Cb, Rb, _ = ob.shape
    if sub_blocks < 1 or Rb % sub_blocks:
        raise ValueError(f"{Rb} rays a block do not split into {sub_blocks} sub-blocks")
    dev = ob.device
    _check_tensors(dev, ob=(ob, (Cb, Rb, 3)), db=(db, (Cb, Rb, 3)), t_min_b=(t_min_b, (Cb, Rb)),
                   t_max_b=(t_max_b, (Cb, Rb)))
    _check_scene(dev, bins)
    boxes = _bins_boxes(bins, ch, cs, cb, cm)
    _check_boxes(dev, *boxes)
    if dev.type == "cpu":
        return cull_rays_reference(bins, ob, db, t_min_b, t_max_b, sub_blocks, cs, cb, ch, cm)
    out = _launch("rays", Cb, sub_blocks, boxes,
                  dict(o=ob, d=db, t_min=t_min_b, t_max=t_max_b, scene_min=bins.aabb_min,
                       scene_max=bins.aabb_max), Rb=Rb)
    cull_rays.launches += 1
    return out


cull_rays.launches = 0


def cull_rays_reference(bins, ob, db, t_min_b, t_max_b, sub_blocks, cs, cb, ch=0, cm=0):
    """:func:`cull_rays` in plain PyTorch tensor ops: the sub-block bounds,
    the scene cap, then :func:`cull_blocks_reference`. Runs on any device."""
    def one(ob, db, t_min_b, t_max_b):
        raw = lambda r: _subblock_bounds(ob, db, t_min_b, t_max_b, r)
        return cull_blocks_reference(*_cull_args(bins, raw, sub_blocks, cs, cb, ch, cm))
    step = max(1, _REF_RAYS_PER_STEP // ob.shape[1])
    return _by_blocks(one, step, ob, db, t_min_b, t_max_b)


def cull_factored(bins, o_c: Tensor, d_c: Tensor, alive: Tensor, t_min: float, t_max: float,
                  sub_blocks: int, cs: int, cb: int, ch: int = 0, origin_margin: float = 0.0,
                  dir_margin: float = 0.0, cm: int = 0):
    """Nearest-first candidate bins of factored blocks: P pose origins
    ``o_c (Cb, P, 3)`` x G shared directions ``d_c (Cb, G, 3)`` (ray g*P +
    p), ``alive (Cb,)`` (0: a dead block), scalar gates, split into
    ``sub_blocks`` sub-blocks; ``origin_margin`` (per axis) and
    ``dir_margin`` (radians) widen every cone for candidate reuse; ``cm``
    > 0 adds the mid level.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`cull_factored_reference`. ``cull_factored.launches`` counts the
    kernel launches."""
    Cb, P, _ = o_c.shape
    G = d_c.shape[1]
    if sub_blocks < 1 or (G % sub_blocks and (P * G) % sub_blocks):
        raise ValueError(f"{P} x {G} rays a block do not split into {sub_blocks} sub-blocks")
    dev = o_c.device
    _check_tensors(dev, o_c=(o_c, (Cb, P, 3)), d_c=(d_c, (Cb, G, 3)), alive=(alive, (Cb,)))
    _check_scene(dev, bins)
    boxes = _bins_boxes(bins, ch, cs, cb, cm)
    _check_boxes(dev, *boxes)
    if dev.type == "cpu":
        return cull_factored_reference(bins, o_c, d_c, alive, t_min, t_max, sub_blocks, cs, cb,
                                       ch, origin_margin, dir_margin, cm)
    out = _launch("factored" if G % sub_blocks == 0 else "expanded", Cb, sub_blocks, boxes,
                  dict(o=o_c, d=d_c, alive=alive, scene_min=bins.aabb_min,
                       scene_max=bins.aabb_max),
                  Rb=P * G, P=P, G=G, t_min_s=t_min, t_max_s=t_max, origin_margin=origin_margin,
                  tan_dm=math.tan(dir_margin) if dir_margin else 0.0)
    cull_factored.launches += 1
    return out


cull_factored.launches = 0


def cull_factored_reference(bins, o_c, d_c, alive, t_min, t_max, sub_blocks, cs, cb, ch=0,
                            origin_margin=0.0, dir_margin=0.0, cm=0):
    """:func:`cull_factored` in plain PyTorch tensor ops: the factored
    bounds with their margins, the scene cap, then
    :func:`cull_blocks_reference`. Runs on any device."""
    def one(o_c, d_c, alive):
        raw = _factored_bounds(o_c, d_c, alive, t_min, t_max, sub_blocks, origin_margin,
                               dir_margin)
        return cull_blocks_reference(*_cull_args(bins, raw, sub_blocks, cs, cb, ch, cm))
    step = max(1, _REF_RAYS_PER_STEP // (o_c.shape[1] * d_c.shape[1]))
    return _by_blocks(one, step, o_c, d_c, alive)


# plain-version blocks per step: bounds the (blocks, cones, boxes) test tensors
_REF_TESTS_PER_STEP = 1 << 23


def cull_blocks_reference(cones: Tensor, fat: Optional[Tensor], n_hi: Tensor,
                          bin_aabb: Tensor, super_aabb: Tensor, hyper_aabb: Optional[Tensor],
                          S: int, H: int, ch: int, cs: int, cb: int,
                          mid_aabb: Optional[Tensor] = None, M: int = 1, cm: int = 0):
    """The same function in plain PyTorch tensor ops, in steps of blocks
    that bound its intermediates. Runs on any device."""
    Cb, R, _ = cones.shape
    width = max(cs * S, super_aabb.shape[0] if not ch else ch * H)
    step = max(1, _REF_TESTS_PER_STEP // (R * width))
    if Cb > step:
        parts = [cull_blocks_reference(
            cones[s:s + step], None if fat is None else fat[s:s + step], n_hi[s:s + step],
            bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb, M, cm)
            for s in range(0, Cb, step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = cones.device
    n_bins = bin_aabb.shape[0]
    groups, g, n_groups, sat0 = _level1_groups(cones, fat, bin_aabb, super_aabb, hyper_aabb, S,
                                               H, ch, cs, mid_aabb, M, cm)
    # level 1: the sub-block cones x the selected groups' bins
    k = groups.shape[1]
    safe = groups.clamp(min=0)
    boxes = _pad_rows(bin_aabb, n_groups * g).reshape(n_groups, g, 6)[safe]
    any_bin, tn_bin = _group_box_tests(cones, boxes.reshape(Cb, k * g, 6))
    gbin = safe[..., None] * g + torch.arange(g, dtype=torch.int32, device=dev)
    valid = (any_bin.reshape(Cb, k, g) & (groups >= 0)[..., None]
             & (gbin < n_bins)).reshape(Cb, k * g)
    cand_bin, tn = _select(valid, tn_bin, gbin.reshape(Cb, k * g), n_bins, cb, _packs(n_bins))
    cand_tnear = torch.where(cand_bin >= 0, tn / n_hi[:, None], _BIG)
    cand_count = torch.sum(cand_bin >= 0, dim=1).to(torch.int32)
    sat = sat0 | (torch.sum(valid, dim=1) > cb)
    return cand_bin.to(torch.int32).contiguous(), cand_count, cand_tnear.contiguous(), sat


def cull_disagreements(a, b, rtol: float = 1e-6) -> Tuple[int, int]:
    """Compare two cull results ``(cand_bin, cand_count, cand_tnear, sat)``
    block by block. A block agrees when both lists are equal (tnear within
    ``rtol``); it is a tie when the lists differ only in bins whose tnear
    ties (within ``rtol``) with its list's last kept entry — a budget cut
    between equal keys. Returns (blocks that disagree otherwise, tie
    blocks)."""
    ca, na, ta, sa = (x.cpu() for x in a)
    cb_, nb, tb, sb = (x.cpu() for x in b)
    close = lambda x, y: abs(x - y) <= rtol * max(abs(x), abs(y))
    same = ((ca == cb_).all(1) & (na == nb) & (sa == sb)
            & ((ta - tb).abs() <= rtol * torch.maximum(ta.abs(), tb.abs())).all(1))
    bad = ties = 0
    for i in torch.nonzero(~same).flatten().tolist():
        ka, kb = int(na[i]), int(nb[i])
        da = dict(zip(ca[i, :ka].tolist(), ta[i, :ka].tolist()))
        db = dict(zip(cb_[i, :kb].tolist(), tb[i, :kb].tolist()))
        common_ok = all(close(da[k], db[k]) for k in set(da) & set(db))
        last_a = ta[i, ka - 1].item() if ka else 0.0
        last_b = tb[i, kb - 1].item() if kb else 0.0
        cut_ok = (all(close(da[k], last_a) for k in set(da) - set(db))
                  and all(close(db[k], last_b) for k in set(db) - set(da)))
        if common_ok and cut_ok and set(da) != set(db) and ka == kb:
            ties += 1
        elif common_ok and set(da) == set(db) and ka == kb and bool(sa[i] == sb[i]):
            ties += 1  # the same set; the order differs between equal keys
        else:
            bad += 1
    return bad, ties
