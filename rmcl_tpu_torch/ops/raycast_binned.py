"""Dense binned ray casters.

Counterpart of ``rmcl_tpu.ops.raycast_binned``: rays are processed in
coherent blocks; each block is culled against hyper-bins, super-bins and
bins with a conservative cone test (never false-culls), nearest first, down
to at most ``c_bin`` candidate bins; the candidates are then intersected.

Two engines share the cull:

* :func:`cast_rays_binned`, rays in any coherent order: Möller-Trumbore in
  the hand-written kernel :func:`rmcl_tpu_torch.ops.raycast_cuda.intersect_bins`
  (K1), or with ``dir_groups=G`` (blocks of G groups of rays sharing one
  direction, :func:`tiled_sweep_order` with ``dir_major=True``) its hoisted
  form in :func:`~rmcl_tpu_torch.ops.raycast_cuda.intersect_groups` (K2g);
  the winner's triangle row is gathered once per ray and t, point and
  normal are re-derived from its plane;
* :func:`cast_rays_binned_factored`, blocks of P pose origins x G shared
  directions (the pose sweep of :class:`TiledSweep`, the tracking loop):
  Baldwin-Weber in :func:`rmcl_tpu_torch.ops.raycast_cuda.intersect_factored`
  (K4); candidate lists from :func:`factored_candidates` can be reused
  across casts whose poses moved less than the cull's margins.

The cull — each block's sub-block cone bounds, then its box tests and
nearest-first selections — is one launch of the hand-written kernel K3:
:func:`rmcl_tpu_torch.ops.cull_cuda.cull_rays` for ray blocks,
:func:`~rmcl_tpu_torch.ops.cull_cuda.cull_factored` for factored blocks.

Budgets truncate candidate lists nearest-first: a block needing more than
``c_hyper`` hypers, ``c_super`` supers, ``c_mid`` mids or ``c_bin`` bins
may miss geometry (the cull's ``sat`` flags say where; ``with_lossless``
and :func:`block_cull_stats` hand them out).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.builder import morton_codes_3d
from rmcl_tpu_torch.ops.cull_cuda import _BIG, cull_factored, cull_rays
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits, _map_hits
from rmcl_tpu_torch.ops.raycast_cuda import (intersect_bins, intersect_factored, intersect_groups,
                                             plane_of)
from rmcl_tpu_torch.utils import timing

Tensor = torch.Tensor


def _build_candidates(bins, ob, db, t_min_b, t_max_b, cs, cb):
    """Two-level cull with one fat cone per block: nearest-first candidate
    bins per ray block (the Pallas kernel's input in the JAX package) —
    the chunk cull with one sub-block.

    Returns (cand_bin (n_blk, cb) int32 with -1 padding, cand_count
    (n_blk,) int32, cand_tnear (n_blk, cb) conservative parametric entry)."""
    return _chunk_candidates(bins, ob, db, t_min_b, t_max_b, cs, cb, 1)[:3]


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


def _resolve_budgets(bins, c_super, c_bin, c_mid=0):
    """The cull budgets clamped to the structure's level sizes: (cs, cb,
    cm), shared by the casts and the standalone cull so that reused
    candidate lists match the cast's shapes.

    The mid level switches itself off (cm = 0) when the bins have none or a
    super holds a single mid (S // M <= 1: the two-level cull is then
    strictly better). Otherwise cm never under-covers the bin budget (cm >=
    ceil(cb / M)), and cb never exceeds what cm mids hold."""
    S = bins.bins_per_super
    cs = min(c_super, bins.n_super)
    cb = min(c_bin, bins.n_bins, cs * S)
    cm = 0
    if c_mid:
        M = bins.bins_per_mid
        Sm = S // max(M, 1)
        if bins.mid_aabb is not None and Sm > 1:
            cm = min(max(c_mid, -(-cb // M)), bins.n_mid, cs * Sm)
            cb = min(cb, cm * M)
    return cs, cb, cm


def candidate_stats(bins: TriangleBins, orig: Tensor, dirs: Tensor,
                    t_min=0.0, t_max=NO_HIT_T, block_size: int = 256,
                    c_super: int = 48, c_bin: int = 192) -> Tensor:
    """Candidate-bin count per ray block from the fat-block cull (counts
    saturating at c_bin mean budget overflow, i.e. potential false
    misses)."""
    o, d, t_min_r, t_max_r, _ = _flat_rays(orig, dirs, t_min, t_max)
    cs, cb, _ = _resolve_budgets(bins, c_super, c_bin)
    _, cand_count, _ = _build_candidates(
        bins, *_pad_rays(o, d, t_min_r, t_max_r, block_size), cs, cb)
    return cand_count


def _hyper_budget(bins, c_hyper):
    """The hyper budget in force: 0 unless asked for and the bins have the
    level."""
    return min(c_hyper, bins.n_hyper) if c_hyper and bins.hyper_aabb is not None else 0


def _chunk_candidates(bins, ob, db, t_min_b, t_max_b, cs, cb, sub_blocks, c_mid=0,
                      c_hyper=0):
    """Per-sub-block chunk cull: a union of R = ``sub_blocks`` narrow cones
    per block.

    ``c_mid`` is the resolved mid budget (cm of :func:`_resolve_budgets`; 0:
    two levels).

    Returns (cand_bin (Cb, cb), cand_count (Cb,), cand_tnear (Cb, cb), sat
    (Cb,) bool — True when a budget level truncated this block's candidate
    set)."""
    rays = (x.contiguous() for x in (ob, db, t_min_b, t_max_b))
    return cull_rays(bins, *rays, sub_blocks, cs, cb, _hyper_budget(bins, c_hyper), c_mid)


def _kernel_inputs(bins, o, d, t_min_r, t_max_r, block_size, c_super, c_bin, sub_blocks,
                   c_hyper=0, c_mid=0):
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
    with timing.span("rmcl.cast.cull"):
        cs, cb, cm = _resolve_budgets(bins, c_super, c_bin, c_mid)
        ob, db, t_min_b, t_max_b = _pad_rays(o, d, t_min_r, t_max_r, Rb)
        cand_bin, cand_count, cand_tnear, sat = _chunk_candidates(
            bins, ob, db, t_min_b, t_max_b, cs, cb, sub_blocks, cm, c_hyper)
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
    shared_dir: bool = False,
) -> RayHits:
    """Dense closest-hit query; rays (..., 3) on the bins' device.

    ``payload``: True/"select" and "index" give the same outputs (the
    winner's triangle row is gathered once per ray after the kernel);
    False/"none" is the occlusion query (t only, the packed-key t).
    ``block_chunk`` (the JAX package's cull chunk) changes nothing here:
    the port culls every block in one launch.
    ``c_hyper`` > 0 (with bins built with a hyper level) routes the super
    selection through the ``c_hyper`` nearest hyper boxes; ``c_mid`` > 0
    (with bins built with a mid level) routes the bin tests through the
    ``c_mid`` nearest mid boxes of the kept supers (see
    :func:`_resolve_budgets` for when it switches itself off).
    ``sort_blocks`` launches the intersection's blocks in ascending
    candidate count (a stable argsort); it changes no result.
    ``with_lossless=True`` returns ``(hits, lossless)``: per ray, True
    where no budget level truncated its block's candidate set, i.e. its
    result is certified exact.
    ``dir_groups=G`` promises that each block's rays form G contiguous
    groups sharing ONE exact direction per group (pose sweeps ordered by
    :func:`tiled_sweep_order` with ``dir_major=True``, or
    :meth:`TiledSweep.rays`): the intersection then runs K2g, which forms
    the direction terms once a (triangle, group). Results are undefined
    where the promise is broken. ``shared_dir=True`` is the alias for
    ``dir_groups=1``.
    Rays should come in a spatially coherent order (scan grids are)."""
    if shared_dir and not dir_groups:
        dir_groups = 1
    if dir_groups and block_size % dir_groups:
        raise ValueError(f"block_size ({block_size}) must be a multiple of dir_groups "
                         f"({dir_groups})")
    pmode = {True: "select", False: "none"}.get(payload, payload)
    if pmode not in ("select", "index", "none"):
        raise ValueError(f"unknown payload mode {payload!r}")
    with timing.span("rmcl.cast.rays"):
        o, d, t_min_r, t_max_r, batch_shape = _flat_rays(orig, dirs, t_min, t_max)
    # the cull and the kernels choose winners only: no gradient enters them
    # (t, point and normal are re-derived from the winner's plane below)
    inputs, sat = _kernel_inputs(bins, o.detach(), d.detach(), t_min_r.detach(),
                                 t_max_r.detach(), block_size, c_super, c_bin, sub_blocks,
                                 c_hyper, c_mid)
    # the ray-bin pairs the cull hands the intersection (padding rays too)
    timing.count_device("rmcl.cast.pairs", inputs[5], block_size)
    with timing.span("rmcl.cast.intersect"):
        order = None
        if sort_blocks:
            order = torch.argsort(inputs[5], stable=True).to(torch.int32)
        if dir_groups:
            t_best_b, ref_b = intersect_groups(bins.tri, *inputs, dir_groups, order=order)
        else:
            t_best_b, ref_b = intersect_bins(bins.tri, *inputs, order=order)
    with timing.span("rmcl.cast.payload"):
        hits = _hits_from_winners(bins, o, d, t_max_r, t_best_b, ref_b, pmode, flip_normals)
        hits = _map_hits(lambda x: x.reshape(batch_shape + tuple(x.shape[1:])), hits)
    if with_lossless:
        lossless = (~sat)[:, None].expand(sat.shape[0], block_size).reshape(-1)[:o.shape[0]]
        return hits, lossless.reshape(batch_shape)
    return hits


def _hits_from_winners(bins, o, d, t_max_r, t_best_b, ref_b, pmode="index",
                       flip_normals=True) -> RayHits:
    """Flat hit records of n rays ``o, d (n, 3)`` from K1's or K2g's
    blocked winners: one row gather a ray resolves the winner's triangle,
    and t, point and normal are re-derived from its plane (``pmode``
    "none": the packed-key t only)."""
    n = o.shape[0]
    t_best = t_best_b.reshape(-1)[:n]
    hit = (t_best < t_max_r) & (t_best < _BIG)
    if pmode == "none":
        neg1 = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        zero3 = o.new_zeros((n, 3))
        return RayHits(t=torch.where(hit, t_best, NO_HIT_T), hit=hit, prim_id=neg1,
                       inst_id=neg1, point=zero3, normal=zero3)

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
    return RayHits(t=t_out, hit=hit, prim_id=ids(12), inst_id=ids(13), point=point,
                   normal=normal)


def block_cull_stats(bins: TriangleBins, orig: Tensor, dirs: Tensor, t_min=0.0,
                     t_max=NO_HIT_T, block_size: int = 128, c_super: int = 48,
                     c_bin: int = 192, sub_blocks: int = 4, c_mid: int = 0, c_hyper: int = 0,
                     block_chunk: int = 256) -> Tuple[Tensor, Tensor]:
    """Per-block ``(candidate_count, saturated)`` through the engine's own
    cull (one K3 launch) — the audit that matches what
    :func:`cast_rays_binned` runs at the same configuration.

    ``saturated[i]`` True means some budget level (hyper, super, mid or
    bin) truncated block i's candidate set, so the block's results are not
    certified exact. Budget audits must check ``saturated.any()``, not just
    the counts. ``block_chunk`` changes nothing here (the port culls every
    block in one launch)."""
    o, d, t_min_r, t_max_r, _ = _flat_rays(orig, dirs, t_min, t_max)
    inputs, sat = _kernel_inputs(bins, o, d, t_min_r, t_max_r, block_size, c_super, c_bin,
                                 sub_blocks, c_hyper, c_mid)
    return inputs[5], sat


# --- the factored engine: (P pose origins x G shared directions) blocks ---

def _pad_factored_blocks(o_blk, d_blk, alive, block_chunk):
    """Pad the blocks to whole chunks; padding blocks are dead (alive = 0:
    t_max = 0, no hits). Returns (o_blk, d_blk, alive_f, n_blk, chunk,
    n_chunks)."""
    o_blk = o_blk.to(torch.float32).contiguous()
    d_blk = d_blk.to(torch.float32).contiguous()
    n_blk = o_blk.shape[0]
    if alive is None:
        alive_f = o_blk.new_ones((n_blk,))
    else:
        alive_f = torch.as_tensor(alive, device=o_blk.device).to(torch.float32)
    chunk = min(block_chunk, n_blk)
    blk_pad = (-n_blk) % chunk
    if blk_pad:
        padz = lambda x, fill: torch.cat([x, x.new_full((blk_pad,) + tuple(x.shape[1:]), fill)])
        o_blk, d_blk, alive_f = padz(o_blk, 0.0), padz(d_blk, 1.0), padz(alive_f, 0.0)
    return o_blk, d_blk, alive_f.contiguous(), n_blk, chunk, (n_blk + blk_pad) // chunk


def _factored_block_candidates(bins, o_blk, d_blk, alive_f, t_min_s, t_max_s, cs, cb,
                               c_hyper, sub_blocks, origin_margin, dir_margin=0.0, cm=0):
    """Cull phase of the factored cast: nearest-first candidate bins of
    (P pose origins x G shared directions) blocks, one launch of
    :func:`cull_factored`.

    ``origin_margin`` > 0 inflates every block's origin box by +/- margin
    per axis, so the lists (and their tnear lower bounds) hold for ANY
    block origins within L-inf distance ``margin`` of these — the basis of
    candidate reuse across corrections. ``dir_margin`` (radians) widens
    every cone's half-angle so the lists also survive direction tilts up to
    the margin (pose rotations).

    Returns (cand (n_blk, cb), count (n_blk,), tnear (n_blk, cb), sat
    (n_blk,)) for the padded blocks."""
    return cull_factored(bins, o_blk, d_blk, alive_f, t_min_s, t_max_s, sub_blocks, cs, cb,
                         _hyper_budget(bins, c_hyper), origin_margin, dir_margin, cm)


def factored_candidates(
    bins: TriangleBins,
    o_blk: Tensor,  # (n_blk, P, 3) per-block pose origins
    d_blk: Tensor,  # (n_blk, G, 3) per-block shared directions
    t_min: float = 0.0,
    t_max: float = NO_HIT_T,
    alive: "Tensor | None" = None,
    c_super: int = 24,
    c_bin: int = 64,
    block_chunk: int = 512,
    c_mid: int = 0,
    c_hyper: int = 0,
    sub_blocks: int = 4,
    origin_margin: float = 0.0,
    dir_margin: float = 0.0,
    with_sat: bool = False,
) -> Tuple[Tensor, ...]:
    """Standalone cull for :func:`cast_rays_binned_factored`: build the
    candidate lists once and reuse them across corrections.

    With ``origin_margin`` = m (meters) and ``dir_margin`` = r (radians),
    the lists are conservative for any cast whose block origins each moved
    by < m per axis AND whose directions each tilted by < r, at unchanged
    budgets: pass them as ``candidates=`` to the cast. Budgets and chunking
    must match the cast's (the cast checks the shapes).

    Returns (cand (n_blk_padded, cb) int32 with -1 padding, count
    (n_blk_padded,) int32, tnear (n_blk_padded, cb) f32), and with
    ``with_sat=True`` also sat (n_blk_padded,) bool: True where a budget
    truncated the block's list, so casts through it are not certified
    exact."""
    with timing.span("rmcl.cast.cull"):
        cs, cb, cm = _resolve_budgets(bins, c_super, c_bin, c_mid)
        o_p, d_p, alive_f, *_ = _pad_factored_blocks(o_blk, d_blk, alive, block_chunk)
        out = _factored_block_candidates(
            bins, o_p, d_p, alive_f, float(t_min), float(t_max), cs, cb, c_hyper, sub_blocks,
            float(origin_margin), float(dir_margin), cm)
    return out if with_sat else out[:3]


@dataclasses.dataclass(frozen=True)
class FactoredWinners:
    """K4's raw closest hits, one per ray of the real blocks (the payload
    "winner" of :func:`cast_rays_binned_factored`): the packed, rounded-up
    ``t`` (n_blk, Rb) float32 and the winner's triangle row ``ref`` (n_blk,
    Rb) int32 = bin * B + lane, and each block's alive-gated ``t_max``
    (n_blk,). Neither the plane nor the rays are derived."""

    t: Tensor
    ref: Tensor
    t_max: Tensor

    @property
    def hit(self) -> Tensor:
        """(n_blk, Rb) bool: the ray hit (its packed t lies below its block's
        t_max), as every other payload's ``hit``."""
        return (self.t < self.t_max[:, None]) & (self.t < _BIG)


def cast_rays_binned_factored(
    bins: TriangleBins,
    o_blk: Tensor,  # (n_blk, P, 3) per-block pose origins
    d_blk: Tensor,  # (n_blk, G, 3) per-block shared directions
    t_min: float = 0.0,
    t_max: float = NO_HIT_T,
    alive: "Tensor | None" = None,  # (n_blk,) bool; None = all alive
    c_super: int = 24,
    c_bin: int = 64,
    block_chunk: int = 512,
    sort_blocks: bool = True,
    c_mid: int = 0,
    c_hyper: int = 0,
    sub_blocks: int = 4,
    payload: str = "plane",
    flip_normals: bool = True,
    origin_margin: float = 0.0,
    dir_margin: float = 0.0,
    candidates: "Tuple[Tensor, Tensor, Tensor] | None" = None,
    paired: bool = False,
) -> "RayHits | FactoredWinners":
    """Closest hit for *factored* ray blocks: each block is the cross
    product of P pose origins x G shared directions (ray = g*P + p within
    the block), the pose-sweep structure. Rays are never materialized for
    the pair loop: the Baldwin-Weber kernel (K4) forms per-triangle,
    per-(triangle, direction) and per-(triangle, pose) terms, and a pair
    costs ``t = No*invNd; u = Au + t*Bu; v = Av + t*Bv`` and the hit test.

    ``payload`` (resolved after the kernel from the winner's triangle row):
    "plane" gives t, point and normal re-derived from the winner's plane
    (prim_id/inst_id are -1); "full" and "index" add the ids; "none" is
    the occlusion query (t only, the packed-key t); "winner" returns K4's
    raw winners as :class:`FactoredWinners`, for a caller that resolves
    them itself (the batch corrector's epilogue kernel).

    ``candidates``: a (cand, count, tnear) triple from
    :func:`factored_candidates` skips the cull (candidate reuse);
    ``origin_margin``/``dir_margin`` inflate the cull when it runs here.
    ``sort_blocks`` launches the blocks in descending candidate count (it
    changes no result). ``paired=True``: per-ray origins, ``o_blk (n_blk,
    G, 3)`` with origin i paired with direction i (the OnDn layout); the
    cull bounds the origin set as before.

    Constraints: ``t_min >= 0`` (degenerate and padding triangles rely on
    t = 0 failing the gate); scalar t_min/t_max. Outputs have shape (n_blk,
    Rb) (and (n_blk, Rb, 3))."""
    if payload not in ("index", "plane", "full", "none", "winner"):
        raise ValueError(f"unknown payload mode {payload!r}")
    n_blk, P, _ = o_blk.shape
    G = d_blk.shape[1]
    if paired and tuple(o_blk.shape) != tuple(d_blk.shape):
        raise ValueError("paired=True needs one origin per direction: o_blk (n_blk, G, 3)")
    P_eff = 1 if paired else P
    Rb = P_eff * G
    t_min_s, t_max_s = float(t_min), float(t_max)
    if t_min_s < 0.0:
        raise ValueError("t_min must be >= 0")
    B = bins.bin_size
    if B & (B - 1):
        raise ValueError("bin_size must be a power of two (packed-key min)")
    with timing.span("rmcl.cast.rays"):
        cs, cb, cm = _resolve_budgets(bins, c_super, c_bin, c_mid)
        o_p, d_p, alive_f, n_blk, chunk, n_chunks = _pad_factored_blocks(
            o_blk, d_blk, alive, block_chunk)
    n_blk_p = n_chunks * chunk
    if candidates is not None:
        cand, count, tnear = candidates
        if tuple(cand.shape) != (n_blk_p, cb):
            raise ValueError(f"candidates shape {tuple(cand.shape)} != {(n_blk_p, cb)}: build "
                             "them with factored_candidates at the same blocks and budgets")
    else:
        with timing.span("rmcl.cast.cull"):
            cand, count, tnear, _ = _factored_block_candidates(
                bins, o_p, d_p, alive_f, t_min_s, t_max_s, cs, cb, c_hyper, sub_blocks,
                float(origin_margin), float(dir_margin), cm)
    # the ray-bin pairs the lists hand the intersection (dead blocks' too)
    timing.count_device("rmcl.cast.pairs", count, Rb)
    with timing.span("rmcl.cast.intersect"):
        order = None
        if sort_blocks:
            order = torch.argsort(count, descending=True, stable=True).to(torch.int32)
        t_best, ref = intersect_factored(bins.tri, o_p, d_p, alive_f, t_min_s, t_max_s,
                                         cand.contiguous(), count.contiguous(),
                                         tnear.contiguous(), paired=paired, order=order)
    with timing.span("rmcl.cast.payload"):
        t_best = t_best.reshape(n_blk_p, Rb)[:n_blk]
        ref = ref.reshape(n_blk_p, Rb)[:n_blk]
        # dead blocks start at t_best = 0 and must not read as hits: compare
        # against their own (alive-gated) t_max
        winners = FactoredWinners(t_best, ref, alive_f[:n_blk] * t_max_s)
        if payload == "winner":
            return winners
        hit = winners.hit
        if payload == "none":
            neg1 = torch.full((n_blk, Rb), -1, dtype=torch.int32, device=o_p.device)
            zero3 = o_p.new_zeros((n_blk, Rb, 3))
            return RayHits(t=torch.where(hit, t_best, NO_HIT_T), hit=hit, prim_id=neg1,
                           inst_id=neg1, point=zero3, normal=zero3)

        # per-ray origins and directions for the plane re-derivation
        if paired:
            o_r = o_p[:n_blk]
        else:
            o_r = o_p[:n_blk, None].expand(n_blk, G, P, 3).reshape(n_blk, Rb, 3)
        d_r = d_p[:n_blk, :, None].expand(n_blk, G, P_eff, 3).reshape(n_blk, Rb, 3)
        # the winner's row, one gather per ray (misses read row 0 and are masked)
        r = torch.where(hit, ref, 0).to(torch.int64)
        base = (r // B) * (14 * B) + r % B
        flat = bins.tri.reshape(-1)
        comp = lambda k: flat[base + k * B]
        # the plane with the pair loop's formulas: ng = e1 x e2, c0 = ng.v0
        ngx, ngy, ngz, c0 = plane_of(*(comp(k) for k in range(9)))
        denom = ngx * d_r[..., 0] + ngy * d_r[..., 1] + ngz * d_r[..., 2]
        safe_denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        num = c0 - (ngx * o_r[..., 0] + ngy * o_r[..., 1] + ngz * o_r[..., 2])
        t_plane = num / safe_denom
        t_out = torch.where(hit, t_plane, NO_HIT_T)
        point = torch.where(hit[..., None], o_r + t_plane[..., None] * d_r, 0.0)
        inv_len = torch.rsqrt(torch.clamp(ngx * ngx + ngy * ngy + ngz * ngz, min=1e-30))
        normal = torch.stack([ngx, ngy, ngz], dim=-1) * inv_len[..., None]
        if flip_normals:
            normal = normal * torch.where(denom > 0, -1.0, 1.0)[..., None]
        normal = torch.where(hit[..., None], normal, 0.0)
        if payload == "plane":
            prim = inst = torch.full((n_blk, Rb), -1, dtype=torch.int32, device=o_p.device)
        else:
            prim = torch.where(hit, comp(12), -1.0).to(torch.int32)
            inst = torch.where(hit, comp(13), -1.0).to(torch.int32)
        return RayHits(t=t_out, hit=hit, prim_id=prim, inst_id=inst, point=point, normal=normal)


# --- pose-sweep orders ---


def _pose_order(origins: np.ndarray) -> np.ndarray:
    """Poses sorted along the Morton curve of their bounding box."""
    lo = origins.min(axis=0)
    extent = np.maximum(origins.max(axis=0) - lo, 1e-12)
    return np.argsort(morton_codes_3d((origins - lo) / extent), kind="stable")


def tiled_sweep_order(origins, width: int, height: int, poses_per_tile: int = 32,
                      az_tile: int = 8, el_tile: int = 1, dir_major: bool = False,
                      device="cuda") -> Tuple[Tensor, Tensor]:
    """Permutation for pose-sweep workloads producing *compact* ray blocks:
    tiles of ``poses_per_tile`` Morton-clustered origins x ``az_tile *
    el_tile`` angularly adjacent scan directions.

    Rays are assumed pose-major: ray index = pose * (width*height) + dir,
    with the scan grid flattened row-major (dir = el * width + az).
    ``dir_major=True`` orders each tile direction-outer / pose-inner.

    Returns (perm, inv) int64 on ``device``: apply ``rays[perm]``;
    un-apply ``hits[inv]``."""
    dev = resolve_device(device)
    origins = np.asarray(origins, np.float32).reshape(-1, 3)
    n_poses = origins.shape[0]
    n_dirs = width * height
    pose_order = _pose_order(origins).astype(np.int64)
    pt = max(1, min(poses_per_tile, n_poses))
    at = max(1, min(az_tile, width))
    et = max(1, min(el_tile, height))
    n_pt = (n_poses + pt - 1) // pt
    pose_pad = np.concatenate(
        [pose_order, np.repeat(pose_order[-1:], n_pt * pt - n_poses)]).reshape(n_pt, pt)
    n_at = (width + at - 1) // at
    n_et = (height + et - 1) // et
    az_ids, el_ids = np.arange(width), np.arange(height)
    az_tiles = np.concatenate([az_ids, np.repeat(az_ids[-1:], n_at * at - width)]).reshape(n_at, at)
    el_tiles = np.concatenate([el_ids, np.repeat(el_ids[-1:], n_et * et - height)]).reshape(n_et, et)
    if dir_major:
        p = pose_pad[:, None, None, None, None, :]
        a = az_tiles[None, :, None, :, None, None]
        e = el_tiles[None, None, :, None, :, None]
    else:
        p = pose_pad[:, None, None, :, None, None]
        a = az_tiles[None, :, None, None, :, None]
        e = el_tiles[None, None, :, None, None, :]
    perm = (p * n_dirs + e * width + a).reshape(-1)
    # inverse ignoring duplicate (padded) entries: the last write wins, and
    # duplicates compute identical rays
    inv = np.zeros(n_poses * n_dirs, np.int64)
    inv[perm] = np.arange(perm.shape[0])
    return torch.from_numpy(perm).to(dev), torch.from_numpy(inv).to(dev)


class TiledSweep:
    """Factored tiled pose-sweep ordering — reshapes, transposes and small
    per-axis gathers only.

    The permutation of :func:`tiled_sweep_order` is a product of three
    small per-axis orders (Morton pose order x azimuth tiles x elevation
    tiles), so both directions factor into reshapes and tiny gathers. Use
    for translation sweeps of one shared scan grid::

        sweep = TiledSweep(trans, width, height, 16, 8, 1)
        o_blk, d_blk = sweep.factored_rays(trans_t, dirs_t)
        hits = cast_rays_binned_factored(bins, o_blk, d_blk)
        t = sweep.unpermute(hits.t.reshape(sweep.n_rays, 1))  # (n_poses, n_dirs, 1)

    Ray layout: axes (pose_tile, az_tile, el_tile, az_in, el_in, pose_in)
    flattened C-order; each tile cell is one block of ``az_tile*el_tile``
    directions x ``poses_per_tile`` poses. The index arrays are numpy; the
    methods take tensors and gather on their device.
    """

    def __init__(self, origins, width: int, height: int, poses_per_tile: int = 16,
                 az_tile: int = 8, el_tile: int = 1):
        origins = np.asarray(origins, np.float32).reshape(-1, 3)
        n_poses = origins.shape[0]
        pose_order = _pose_order(origins).astype(np.int32)
        pt = max(1, min(poses_per_tile, n_poses))
        at = max(1, min(az_tile, width))
        et = max(1, min(el_tile, height))
        n_pt = (n_poses + pt - 1) // pt
        n_at = (width + at - 1) // at
        n_et = (height + et - 1) // et
        # pad every axis by repeating its last entry; padding sits at the
        # END of each flattened axis, so the inverse is a plain slice there
        pose_pad = np.concatenate([pose_order, np.repeat(pose_order[-1:], n_pt * pt - n_poses)])
        self.pose_tiles = pose_pad.reshape(n_pt, pt)
        # position of pose p in the padded pose axis (inverse of pose_order)
        self.pose_rank = np.argsort(pose_order, kind="stable").astype(np.int32)
        self.width, self.height = width, height
        self.n_poses, self.n_dirs = n_poses, width * height
        self.pt, self.at, self.et = pt, at, et
        self.n_pt, self.n_at, self.n_et = n_pt, n_at, n_et
        self.block_size = at * et * pt
        self.dir_groups = at * et
        self.n_rays = n_pt * n_at * n_et * self.block_size
        # scan-grid direction ids per (az_tile, el_tile, az_in, el_in)
        az_pad = np.minimum(np.arange(n_at * at), width - 1)
        el_pad = np.minimum(np.arange(n_et * et), height - 1)
        self.dir_ids = (el_pad.reshape(1, n_et, 1, et) * width
                        + az_pad.reshape(n_at, 1, at, 1)).astype(np.int32)
        # first-occurrence mask (padded duplicate dirs excluded)
        first = ((np.arange(n_at * at) < width).reshape(n_at, 1, at, 1)
                 & (np.arange(n_et * et) < height).reshape(1, n_et, 1, et))
        self.dir_valid = np.broadcast_to(first, self.dir_ids.shape)

    @staticmethod
    def _idx(a: np.ndarray, like: Tensor) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(like.device)

    def rays(self, trans: Tensor, dirs: Tensor) -> Tuple[Tensor, Tensor]:
        """Permuted-flat (origins, directions) from per-pose translations
        (n_poses, 3) and shared scan directions (n_dirs, 3)."""
        full = (self.n_pt, self.n_at, self.n_et, self.at, self.et, self.pt, 3)
        tp = trans.to(torch.float32)[self._idx(self.pose_tiles, trans)]  # (n_pt, pt, 3)
        o = tp[:, None, None, None, None].expand(full)
        dg = dirs.to(torch.float32)[self._idx(self.dir_ids, dirs)]  # (n_at, n_et, at, et, 3)
        d = dg[None, :, :, :, :, None].expand(full)
        return o.reshape(-1, 3), d.reshape(-1, 3)

    def factored_rays(self, trans: Tensor, dirs: Tensor) -> Tuple[Tensor, Tensor]:
        """Compact per-block rays for :func:`cast_rays_binned_factored`:
        (origins (n_blk, P, 3), directions (n_blk, G, 3)), block index
        (pose_tile, az_tile, el_tile) C-order and in-block ray order g*P + p
        — the flat order of :meth:`rays`, so :meth:`unpermute` applies to
        hits reshaped to (n_blk * block_size, ...)."""
        n_pt, n_at, n_et = self.n_pt, self.n_at, self.n_et
        G = self.at * self.et
        tp = trans.to(torch.float32)[self._idx(self.pose_tiles, trans)]  # (n_pt, pt, 3)
        o_blk = tp[:, None, None].expand(n_pt, n_at, n_et, self.pt, 3).reshape(-1, self.pt, 3)
        dg = dirs.to(torch.float32)[self._idx(self.dir_ids, dirs)]
        d_blk = dg.reshape(n_at, n_et, G, 3)[None].expand(n_pt, n_at, n_et, G, 3).reshape(-1, G, 3)
        return o_blk.contiguous(), d_blk.contiguous()

    def permute(self, data: Tensor) -> Tensor:
        """Canonical (n_poses, n_dirs, *k) -> sweep-flat (n_rays, *k); padded
        slots replicate their axis's last entry."""
        k = tuple(data.shape[2:])
        tp = data[self._idx(self.pose_tiles.reshape(-1), data)].reshape(
            (self.n_pt, self.pt, self.n_dirs) + k)
        dg = tp[:, :, self._idx(self.dir_ids.reshape(-1), data)].reshape(
            (self.n_pt, self.pt, self.n_at, self.n_et, self.at, self.et) + k)
        out = dg.permute((0, 2, 3, 4, 5, 1) + tuple(6 + i for i in range(len(k))))
        return out.reshape((self.n_rays,) + k)

    def pose_sums(self, vals: Tensor) -> Tensor:
        """Per-pose sums of per-ray values in sweep-flat order: (n_rays, *k)
        -> (n_poses, *k), excluding padded duplicate dirs and pose slots."""
        k = tuple(vals.shape[1:])
        v = vals.reshape((self.n_pt, self.n_at, self.n_et, self.at, self.et, self.pt) + k)
        dmask = torch.from_numpy(np.array(self.dir_valid)).to(
            device=vals.device, dtype=vals.dtype).reshape(
            (1, self.n_at, self.n_et, self.at, self.et, 1) + (1,) * len(k))
        s = torch.sum(v * dmask, dim=(1, 2, 3, 4)).reshape((self.n_pt * self.pt,) + k)
        return s[self._idx(self.pose_rank, vals)]

    def unpermute(self, y: Tensor) -> Tensor:
        """Permuted-flat (n_rays, *k) -> (n_poses, n_dirs, *k) via a
        transpose, slices and one small pose gather."""
        k = tuple(y.shape[1:])
        y6 = y.reshape((self.n_pt, self.n_at, self.n_et, self.at, self.et, self.pt) + k)
        y6 = y6.permute((0, 5, 2, 4, 1, 3) + tuple(6 + i for i in range(len(k))))
        y3 = y6.reshape((self.n_pt * self.pt, self.n_et * self.et, self.n_at * self.at) + k)
        out = y3[:, : self.height, : self.width][self._idx(self.pose_rank, y)]
        return out.reshape((self.n_poses, self.n_dirs) + k)


def direction_major_order(n_poses: int, n_dirs: int, device="cuda") -> Tuple[Tensor, Tensor]:
    """Permutation turning pose-major rays into direction-major order (all
    poses' ray #0, all poses' ray #1, ...). Returns (perm, inv) int64 on
    ``device``: apply ``rays[perm]``, un-apply with ``hits[inv]``."""
    dev = resolve_device(device)
    perm = torch.arange(n_poses * n_dirs, device=dev).reshape(n_poses, n_dirs).T.reshape(-1)
    return perm, torch.argsort(perm)
