"""The port's budget tuner (``rmcl_tpu_torch.utils.tune.suggest_budgets``)
against the JAX package's on the same rays and the same bins: the
recommended budgets and the candidate statistics are those of JAX's rule
on the port's cull, with and without the mid level, with the block-stride
subsample, and where the escalation through the engine's own cull has to
raise c_super."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_building_scene
from rmcl_tpu.utils.tune import suggest_budgets as j_suggest
from rmcl_tpu_torch.convert import bins_from_arrays
from rmcl_tpu_torch.utils.tune import BudgetRecommendation
from rmcl_tpu_torch.utils.tune import suggest_budgets as t_suggest
from torch_cull_expect import port_cull_under_jax

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _bins(S, M):
    """The small building (4,136 faces) in bins of 8, S a super, M a mid
    (M = S: no mid level)."""
    jb = build_bins(make_building_scene(subdiv=4), bin_size=8, bins_per_super=S,
                    bins_per_mid=M)
    tb = bins_from_arrays({f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
                           for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                                     "mid_aabb", "hyper_aabb")},
                          bins_per_super=jb.bins_per_super, bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    return jb, tb


def _rays(n_origins=16, spread=0.2, seed=0):
    """Origin-major rays: n_origins poses near one point x 360 beams, with
    per-ray reach caps."""
    rng = np.random.default_rng(seed)
    az = np.linspace(-np.pi, np.pi, 360, endpoint=False)
    el = rng.uniform(-0.3, 0.2, 360)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    o = np.float32([3.1, 2.9, 1.5]) + spread * rng.normal(size=(n_origins, 1, 3))
    o = np.broadcast_to(o, (n_origins, 360, 3)).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(d, (n_origins, 360, 3)).reshape(-1, 3).astype(np.float32)
    t_max = rng.uniform(2.0, 12.0, o.shape[0]).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("case,S,M,margin,spread", [
    ("mid", 16, 4, 1.25, 0.2),
    ("no_mid", 16, 16, 1.25, 0.2),
    ("stride", 16, 4, 1.25, 0.2),  # 7 sampled blocks of 45
    ("wide", 16, 4, 1.25, 2.0),
    ("escalate", 4, 4, 1.0, 0.2),  # the engine's cull saturates: c_super 68 -> 130
    ("saturated", 8, 4, 1.0, 0.2),  # c_super reaches every super, the mids still truncate
])
def test_suggest_budgets_matches_jax(case, S, M, margin, spread, monkeypatch):
    """The port's tuner is JAX's rule on the port's cull: JAX's
    suggest_budgets, its cull statistics answered by the port's
    (tests/torch_cull_expect.py), recommends what the port's does. The
    port's cull keeps the flat bins JAX's cone-box test drops, so its worst
    block never holds fewer bins than JAX's own."""
    jb, tb = _bins(S, M)
    kw = dict(block_size=128, margin=margin)
    if case == "stride":
        kw["max_sample_blocks"] = 7
    o, d, t_max = _rays(spread=spread)
    j_own = j_suggest(jb, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max), **kw)
    t = t_suggest(tb, torch.from_numpy(o), torch.from_numpy(d), t_max=torch.from_numpy(t_max),
                  **kw)
    assert t.max_bins >= j_own.max_bins
    port_cull_under_jax(monkeypatch, [(jb, tb)])
    j = j_suggest(jb, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max), **kw)
    assert isinstance(t, BudgetRecommendation)
    assert (t.c_super, t.c_bin, t.c_mid, t.max_bins, t.saturated) == (
        j.c_super, j.c_bin, j.c_mid, j.max_bins, j.saturated)
    np.testing.assert_allclose([t.p99_bins, t.mean_bins], [j.p99_bins, j.mean_bins], rtol=1e-6)
    assert t.as_config_kwargs() == j.as_config_kwargs()
    if case == "mid":
        assert t.c_mid > 0  # the mid level pays on these bins
