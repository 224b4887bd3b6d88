"""Budget auto-tuning for the dense binned engine.

Counterpart of ``rmcl_tpu.utils.tune``. The engine's only approximation is
candidate-budget truncation: each ray block keeps the nearest ``c_super``
supers, ``c_mid`` mids (with the mid level) and ``c_bin`` bins. Budgets too
small for the map and the rays silently drop geometry (false misses). This
module measures the candidate distribution of a representative ray sample
and recommends budgets that cover it::

    rec = suggest_budgets(map_.bins, orig, dirs)
    cfg = SensorUpdateConfig.create(engine="binned", **rec.as_config_kwargs())

The binned closest-point query has a cull of its own (K7: per block of
queries, the supers and then the bins within the block's bound of its box):
:func:`cp_budget_need` counts what each of its blocks needs and
:func:`suggest_cp_budgets` covers the widest.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.ops.raycast import NO_HIT_T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BudgetRecommendation:
    c_super: int
    c_bin: int
    c_mid: int  # 0 when the mid level would not help or does not exist
    # diagnostics
    max_bins: int  # the worst block's candidate-bin count (unbudgeted)
    p99_bins: float
    mean_bins: float
    saturated: bool  # True if even the probe budget clipped (re-run bigger)

    def as_config_kwargs(self) -> dict:
        return {"c_super": self.c_super, "c_bin": self.c_bin, "c_mid": self.c_mid}


def _round_up(x: int, k: int = 8) -> int:
    return int(-(-x // k) * k)


def suggest_budgets(bins: TriangleBins, orig: Tensor, dirs: Tensor, t_min=0.0, t_max=NO_HIT_T,
                    block_size: int = 128, margin: float = 1.25, max_sample_blocks: int = 4096,
                    use_mid: bool = True) -> BudgetRecommendation:
    """Measure candidate-bin counts on (a block-stride sample of) the given
    rays and recommend budgets with ``margin`` headroom over the worst
    block, then verify them through the engine's own cull
    (:func:`~rmcl_tpu_torch.ops.raycast_binned.block_cull_stats`), doubling
    c_super while any block still saturates.

    The rays should be representative of production blocks — the same
    ordering and clustering as the real casts."""
    from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats, candidate_stats

    dev = bins.device
    orig = torch.as_tensor(orig, dtype=torch.float32, device=dev).reshape(-1, 3)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev).reshape(-1, 3)
    n = orig.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n).reshape(-1)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).reshape(-1)
    n_blocks = max(1, n // block_size)
    if n_blocks > max_sample_blocks:
        # a deterministic stride at block granularity keeps the production
        # block composition intact
        stride = n_blocks // max_sample_blocks
        keep = ((np.arange(n_blocks, step=stride) * block_size)[:, None]
                + np.arange(block_size)).reshape(-1)
        keep = torch.from_numpy(keep).to(dev)
        orig, dirs, t_min, t_max = orig[keep], dirs[keep], t_min[keep], t_max[keep]

    # generous probe budgets: every super, up to the full bin count (capped
    # to keep the probe's selection tractable on huge maps)
    cs_probe = min(bins.n_super, 256)
    cb_probe = min(bins.n_bins, cs_probe * bins.bins_per_super, 4096)
    counts = candidate_stats(bins, orig, dirs, t_min=t_min, t_max=t_max,
                             block_size=block_size, c_super=cs_probe,
                             c_bin=cb_probe).cpu().numpy()
    cmax = int(counts.max())
    # "saturated" only means the probe's own caps clipped the count: a block
    # that holds every bin of a small map is exact, not clipped
    probe_capped = cb_probe < min(bins.n_bins, cs_probe * bins.bins_per_super)
    saturated = bool(cmax >= cb_probe and (probe_capped or cs_probe < bins.n_super))

    c_bin = min(_round_up(int(np.ceil(cmax * margin))), bins.n_bins)
    S = bins.bins_per_super
    c_super = min(max(_round_up(int(np.ceil(c_bin / S * margin)) + 2, 4), 8), bins.n_super)
    c_mid = 0
    M = bins.bins_per_mid
    if use_mid and bins.mid_aabb is not None and S // max(M, 1) > 1:
        # cover c_bin bins with mid boxes at the same margin; the level pays
        # only when it shrinks the level-1 key count
        c_mid = min(_round_up(int(np.ceil(c_bin / M * margin))), bins.n_mid)
        if c_mid * M >= c_super * S:
            c_mid = 0

    # verify through the engine's own cull: the super budget truncates
    # PASSING supers, which can outnumber the supers holding candidates
    for _ in range(6):
        _, sat = block_cull_stats(bins, orig, dirs, t_min=t_min, t_max=t_max,
                                  block_size=block_size, c_super=c_super, c_bin=c_bin,
                                  c_mid=c_mid)
        if not bool(sat.any()):
            break
        if c_super >= bins.n_super and c_bin >= min(bins.n_bins, c_super * S):
            saturated = True
            break
        c_super = min(c_super * 2, bins.n_super)
        c_bin = min(max(c_bin, -(-c_super * S // 8)), bins.n_bins, c_super * S)
    return BudgetRecommendation(
        c_super=c_super, c_bin=c_bin, c_mid=c_mid, max_bins=cmax,
        p99_bins=float(np.percentile(counts, 99)), mean_bins=float(counts.mean()),
        saturated=saturated)


def cp_block_need(bins: TriangleBins, qb: Tensor, d2b: Tensor, chunk: int = 2048):
    """Of each query block ``qb (n_blk, Rq, 3)`` with bounds ``d2b (n_blk,
    Rq)`` (as K7 takes them): the supers and the bins within the block's
    greatest bound of its query box, ``(need_super (n_blk,), need_bin
    (n_blk,))`` int64 on the blocks' device. A block's list is complete,
    and K7's ``sat`` clear, at c_super >= need_super and c_bin >= need_bin:
    every bin within the bound lies in a super within it."""
    from rmcl_tpu_torch.ops.closest_point import _box_box_d2

    cap = torch.amax(d2b, dim=1)
    need = ([], [])
    for s in range(0, qb.shape[0], chunk):
        blk = qb[s:s + chunk]
        lo, hi, c = blk.amin(dim=1)[:, None], blk.amax(dim=1)[:, None], cap[s:s + chunk, None]
        for k, boxes in enumerate((bins.super_aabb, bins.bin_aabb)):
            d2 = _box_box_d2(lo, hi, boxes[None, :, :3], boxes[None, :, 3:])
            need[k].append(torch.sum(d2 <= c, dim=1))
    empty = torch.zeros((0,), dtype=torch.int64, device=qb.device)
    return tuple(torch.cat(n) if n else empty for n in need)


def cp_budget_need(bins: TriangleBins, q: Tensor, max_dist, block_size: int = 128,
                   chunk: int = 2048):
    """:func:`cp_block_need` of the blocks that
    :func:`~rmcl_tpu_torch.ops.closest_point.closest_points_binned` forms
    of the map-frame queries ``q (n, 3)`` at ``max_dist``: Morton order
    (past one block), blocks of ``block_size``, the last padded as the
    engine pads it."""
    from rmcl_tpu_torch.ops.closest_point import _max_d2, query_blocks
    from rmcl_tpu_torch.ops.order import cluster_order

    q = torch.as_tensor(q, dtype=torch.float32, device=bins.device).reshape(-1, 3)
    max_d2 = _max_d2(max_dist, q.shape[:1], q.device, cap=1.7e19)
    if q.shape[0] > block_size:
        order = cluster_order(q, None)[0].long()
        q, max_d2 = q[order], max_d2[order]
    return cp_block_need(bins, *query_blocks(q, max_d2, block_size), chunk)


def suggest_cp_budgets(bins: TriangleBins, q: Tensor, max_dist, margin: float = 1.5,
                       block_size: int = 128) -> tuple[int, int, int, int]:
    """Budgets for the binned closest-point query of the queries ``q`` that
    cover its widest block with ``margin`` headroom: ``(c_super, c_bin,
    need_super, need_bin)``, the last two the widest block's counts (one
    readback). The headroom covers the pose's motion while a caller keeps
    the blocks of ``q`` (``closest_points_binned(..., cluster_by=q)``): on
    a 4 x 3-room building of 486,544 faces, a VLP-16 scan's blocks, ordered
    at one pose and moved by up to 0.25 m and 0.02 rad, needed up to 1.09x
    the bins of the unmoved scan's widest block; reordered at each pose, up
    to 1.41x (the blocks are runs of a Morton order, which the motion
    recomposes). c_bin is cut to what K7's kept list can hold
    (:func:`~rmcl_tpu_torch.ops.closest_cuda.cp_max_keys`); a need past
    that stays truncated, and K7 flags it."""
    from rmcl_tpu_torch.ops.closest_cuda import cp_max_keys

    need_s, need_b = cp_budget_need(bins, q, max_dist, block_size)
    if need_s.numel() == 0:
        return 1, 1, 0, 0
    ns, nb = (int(x) for x in torch.stack([need_s.max(), need_b.max()]).tolist())
    c_super = min(max(_round_up(int(np.ceil(ns * margin))), 1), bins.n_super)
    c_bin = min(max(_round_up(int(np.ceil(nb * margin))), 1), bins.n_bins,
                c_super * bins.bins_per_super, cp_max_keys(c_super))
    return c_super, c_bin, ns, nb
