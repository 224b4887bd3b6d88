"""Budget auto-tuning for the dense binned engine.

Counterpart of ``rmcl_tpu.utils.tune``. The engine's only approximation is
candidate-budget truncation: each ray block keeps the nearest ``c_super``
supers, ``c_mid`` mids (with the mid level) and ``c_bin`` bins. Budgets too
small for the map and the rays silently drop geometry (false misses). This
module measures the candidate distribution of a representative ray sample
and recommends budgets that cover it::

    rec = suggest_budgets(map_.bins, orig, dirs)
    cfg = SensorUpdateConfig.create(engine="binned", **rec.as_config_kwargs())
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
