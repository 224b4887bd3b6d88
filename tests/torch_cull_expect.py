"""What the port's block cull answers beside the JAX package's, for the
parity tests that compare the two.

The port's cone-box test (``rmcl_tpu_torch.ops.cull_cuda._cone_box_test``)
holds the slab's axial interval against ``d_near * cos(theta_max)`` and the
entry distance against a ray-length reach, where JAX's ``_cone_box_test``
holds both against Euclidean and axial bounds mixed, and so drops flat
boxes that a block's rays cross off-axis. Every box JAX's test passes, the
port's passes with the same entry distance. So where no budget truncates,
a block's list in the port is JAX's list, in JAX's order, plus bins that
JAX's test rejects (at the bin or at its super) on the same cones. Where a
budget does truncate, or where a rule reads the lists' lengths (the budget
tuner, the node's audit), the port's answer is JAX's rule applied to the
port's cull: ``port_cull_under_jax`` runs the JAX functions that way.

``fixed_test`` restates the fixed clause in numpy, from the quantities of
JAX's test (the slab with the refined radius, d_near, cos(theta_max) =
1 / sqrt(1 + tan^2) and the reach along a ray), and ``restated_cull`` runs
the two-level selection on it, so the port's lists are held to a cull
written apart from the port's code: the same bins, in the same key order.
"""

import jax.numpy as jnp
import numpy as np
import torch

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu_torch.ops import cull_cuda as cc
from rmcl_tpu_torch.ops import raycast_binned as trb


def old_test_any(cones, boxes):
    """(Cb, K): whether JAX's ``_cone_box_test`` passes boxes ``(Cb, K, 6)``
    for any of a block's cones ``(Cb, R, 12)`` (the port's cones; JAX's test
    reads their first 11 fields, the axial reach among them)."""
    c = np.asarray(cones)[:, :, None]
    b = np.asarray(boxes)[:, None]
    ok, _, _ = jrb._cone_box_test(*(jnp.asarray(x) for x in (
        c[..., 0:3], c[..., 3:6], c[..., 6:9], c[..., 9], c[..., 10], b[..., 0:3], b[..., 3:6])))
    return np.asarray(ok).any(1)


NO_PASS = np.uint32(0xFFFFFFFF)


def fixed_test(cones, bmin, bmax):
    """The fixed cone-box test of cones ``(..., R, 12)`` (oc, oh, axis,
    tan_th, the axial reach t_hi, the reach along a ray t_len) against boxes
    ``(..., K, 3)`` x 2, in float32 and in JAX's order of operations (each
    norm summed x, y, then z): the slab interval with the radius refined
    from the first pass, held against ``d_near * cos(theta_max)``, and the
    entry ``max(slab tn, d_near)`` held against t_len. Returns (pass, entry
    >= +0.0), each ``(..., R, K)``."""
    f = np.float32
    c = np.asarray(cones, f)[..., :, None, :]
    bmin, bmax = (np.asarray(x, f)[..., None, :, :] for x in (bmin, bmax))
    oc, oh, a = c[..., 0:3], c[..., 3:6], c[..., 6:9]
    tan_th, t_hi, t_len = c[..., 9], c[..., 10], c[..., 11]
    inv = f(1.0) / np.where(np.abs(a) < f(1e-30), f(1e-30), a)
    b0, b1 = (bmin - oh) - oc, (bmax + oh) - oc
    norm = lambda x: np.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2])
    d_near = norm(np.maximum(np.maximum(b0, -b1), f(0.0)))
    d_far = norm(np.maximum(b1, -b0))
    s_perp = np.sqrt(np.maximum(f(1.0) - a * a, f(0.0)))

    def slab(r):
        rk = r[..., None] * s_perp
        t0, t1 = (b0 - rk) * inv, (b1 + rk) * inv
        return np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)

    _, tf0 = slab(t_hi * tan_th)
    tn, tf = slab(np.minimum(np.maximum(tf0, f(0.0)), t_hi) * tan_th)
    cos_th = f(1.0) / np.sqrt(f(1.0) + tan_th * tan_th)
    tf = np.minimum(tf, d_far)
    entry = np.maximum(tn, d_near)
    ok = (np.maximum(tn, d_near * cos_th) <= tf) & (tf >= f(0.0)) & (entry <= t_len)
    return ok, np.where(entry > f(0.0), entry, f(0.0))


def _least_bits(cones, boxes):
    """(K,): the least entry bits over the cones that pass each box, or
    NO_PASS (a non-negative float's bits order as the float)."""
    ok, entry = fixed_test(cones, boxes[:, 0:3], boxes[:, 3:6])
    return np.where(ok, entry.view(np.uint32), NO_PASS).min(0)


def restated_cull(tb, cones, cs):
    """The two-level cull of ``tb`` (no hyper or mid level) on the blocks'
    cones ``(Cb, R, 12)`` by ``fixed_test``, the bin level unbudgeted: per
    block (the bins passing, in the kernel's key order, and how many supers
    pass). A super passes if a cone passes it, keyed by (its least entry
    bits, its id); the cs least are kept, and their bins are keyed by the
    packed (bits & ~idm) | id where bin ids fit 20 bits, else by (bits,
    position among the kept supers' bins)."""
    S, n_bins = tb.bins_per_super, tb.bin_aabb.shape[0]
    bin_aabb, super_aabb = tb.bin_aabb.numpy(), tb.super_aabb.numpy()
    idm = np.uint32((1 << max(1, (n_bins - 1).bit_length())) - 1)
    packed = max(1, (n_bins - 1).bit_length()) <= 20
    out = []
    for cb in np.asarray(cones):
        sup_bits = _least_bits(cb, super_aabb)
        sup = np.nonzero(sup_bits != NO_PASS)[0]
        kept = sup[np.lexsort((sup, sup_bits[sup]))][:cs]
        cand = (kept[:, None] * S + np.arange(S)).ravel()
        pos = np.nonzero(cand < n_bins)[0]
        bits = _least_bits(cb, bin_aabb[cand[pos]])
        live = bits != NO_PASS
        pos, bits = pos[live], bits[live]
        ids = cand[pos]
        order = np.argsort((bits & ~idm) | ids.astype(np.uint32)) if packed \
            else np.lexsort((pos, bits))
        out.append((ids[order], sup.size))
    return out


def block_cones(tb, ob, db, t_min_b, t_max_b, sub_blocks):
    """The port's capped sub-block cones of ray blocks ``(Cb, Rb, 3)``."""
    raw = cc._subblock_bounds(*(torch.as_tensor(np.asarray(x)) for x in (ob, db, t_min_b,
                                                                         t_max_b)), sub_blocks)
    return cc._capped_bounds(tb, raw)[0].numpy()


def assert_lists_extend_jax(j_out, t_out, tb, cones, tnear_rtol, cs=None):
    """The port's lists ``t_out`` (cand_bin, cand_count, cand_tnear, sat)
    against JAX's ``j_out`` and against ``restated_cull`` at super budget
    ``cs`` (default: every super) on the blocks' cones ``(Cb, R, 12)``:

    - every block's list is the restated cull's, in its key order, cut at
      the bin budget, with its count and (where ``t_out`` has it) its
      saturation flag;
    - where the port truncates no level, the list holds JAX's bins with
      their tnear (to ``tnear_rtol``; the bounds round apart by a few ulp),
      in JAX's order but between entries whose tnear agree to it, and every
      other bin is one that JAX's test rejects, at the bin or at its super,
      for every cone of the block: the extra bins are exactly those the
      fixed test passes and JAX's rejects.

    Returns how many bins the port adds."""
    jc, jn, jt = (np.asarray(x) for x in j_out[:3])
    tc, tn, tt = (np.asarray(x) for x in t_out[:3])
    cb = tc.shape[1]
    S = tb.bins_per_super
    bin_aabb, super_aabb = tb.bin_aabb.numpy(), tb.super_aabb.numpy()
    cs = tb.super_aabb.shape[0] if cs is None else cs
    restated = restated_cull(tb, cones, cs)
    added = 0
    for i, ((want, n_sup), kj, kt) in enumerate(zip(restated, jn, tn)):
        assert kt == min(want.size, cb), i
        np.testing.assert_array_equal(tc[i, :kt], want[:cb], err_msg=str(i))
        assert (tc[i, kt:] == -1).all()
        sat = want.size > cb or n_sup > cs
        if len(t_out) > 3:
            assert bool(np.asarray(t_out[3])[i]) == sat, i
        if sat:
            continue
        j_near = dict(zip(jc[i, :kj].tolist(), jt[i, :kj].tolist()))
        t_near = dict(zip(tc[i, :kt].tolist(), tt[i, :kt].tolist()))
        assert set(j_near) <= set(t_near), i
        for b, v in j_near.items():
            np.testing.assert_allclose(t_near[b], v, rtol=tnear_rtol, atol=1e-7)
        common = [b for b in tc[i, :kt].tolist() if b in j_near]
        for a, b in zip(jc[i, :kj].tolist(), common):
            if a != b:
                np.testing.assert_allclose(j_near[a], j_near[b], rtol=tnear_rtol, atol=1e-7)
        extra = np.asarray([b for b in t_near if b not in j_near], np.int64)
        if extra.size:
            old_bin = old_test_any(cones[i:i + 1], bin_aabb[extra][None])[0]
            old_sup = old_test_any(cones[i:i + 1], super_aabb[extra // S][None])[0]
            assert not (old_bin & old_sup).any(), (i, extra[old_bin & old_sup])
        added += extra.size
    return added


def _t(x):
    return x if isinstance(x, (int, float)) else torch.from_numpy(np.array(x))


def port_cull_under_jax(monkeypatch, pairs):
    """The JAX package's ``candidate_stats`` and ``block_cull_stats`` made to
    answer with the port's on the same rays, for ``pairs`` of (JAX bins,
    port bins): JAX's budget tuner and node audit, which import them when
    they run, then apply their rules to the port's cull."""
    port_of = {id(jb): tb for jb, tb in pairs}

    def candidate_stats(bins, orig, dirs, t_min=0.0, t_max=3.0e38, **kw):
        out = trb.candidate_stats(port_of[id(bins)], _t(orig), _t(dirs), _t(t_min), _t(t_max),
                                  **kw)
        return jnp.asarray(out.numpy())

    def block_cull_stats(bins, orig, dirs, t_min=0.0, t_max=3.0e38, **kw):
        counts, sat = trb.block_cull_stats(port_of[id(bins)], _t(orig), _t(dirs), _t(t_min),
                                           _t(t_max), **kw)
        return jnp.asarray(counts.numpy()), jnp.asarray(sat.numpy())

    monkeypatch.setattr(jrb, "candidate_stats", candidate_stats)
    monkeypatch.setattr(jrb, "block_cull_stats", block_cull_stats)
