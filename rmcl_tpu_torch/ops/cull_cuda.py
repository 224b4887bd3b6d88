"""Block cull: the hand-written CUDA kernel and its plain PyTorch version.

``cull_blocks`` is the port of the block cull that the JAX package runs as
XLA device code inside its casts: the box tests and nearest-first
selections of ``rmcl_tpu/ops/raycast_binned.py`` — ``_chunk_level0``
(level 0 over all supers, or its ``c_hyper`` branch: hypers, then the
selected hypers' supers), ``_group_box_tests``, ``_chunk_cull_tests``,
``_chunk_select`` and ``_chunk_candidates``. The kernel source is
``rmcl_tpu_torch/csrc/cull_blocks.cu``; its header says what bounds it on
the card and what the design does about that.

The per-sub-block bounds (O(rays) work) stay shared PyTorch code in
``ops/raycast_binned.py``; both versions here take them packed.

Contract: ``cones (Cb, R, 11)`` per block R sub-block cones ``[oc(3),
oh(3), axis(3), tan_th, t_hi]``; ``fat (Cb, 11)`` one block cone for the
coarse levels (used only when ``ch > 0``); ``n_hi (Cb,)`` the blocks'
direction-length scale; boxes ``bin_aabb (n_bins, 6)``, ``super_aabb
(n_super, 6)``, ``hyper_aabb (n_hyper, 6)`` with ``S`` bins per super and
``H`` supers per hyper; budgets ``ch`` (0: no hyper level), ``cs``, ``cb``.
Returns ``cand_bin (Cb, cb)`` int32 (-1 padding, nearest first),
``cand_count (Cb,)`` int32, ``cand_tnear (Cb, cb)`` f32 (3e38 padding) and
``sat (Cb,)`` bool, True where a budget truncated the block's set.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rmcl_tpu_torch import _build

Tensor = torch.Tensor

_BIG = 3.0e38
_SENTINEL_KEY = 0x7FFFFFF0
CONE_WIDTH = 11  # oc(3), oh(3), axis(3), tan_th, t_hi


def _norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis of 3, summed in a fixed order (the
    kernel's), so that CPU and card round alike."""
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2])


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
    Returns (pass (..., K), t_near (..., K) >= +0.0, t_far (..., K))."""
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
    # +0.0 for every non-positive entry: the packed keys take tn's bits, and
    # torch.clamp keeps the sign of -0.0
    return ok, torch.where(tn > 0.0, tn, 0.0), tf


def pack_cones(oc, oh, axis, tan_th, t_hi) -> Tensor:
    """Cone bounds (L..., 3) x 3 and (L...,) x 2 as one (L..., 11) tensor."""
    return torch.cat([oc, oh, axis, tan_th[..., None], t_hi[..., None]], dim=-1).contiguous()


def _group_box_tests(cones: Tensor, boxes: Tensor) -> Tuple[Tensor, Tensor]:
    """Every cone of a block against boxes (Cb or 1, K, 6), OR over the
    cones. Returns (any (Cb, K), tn (Cb, K): the least t_near over the
    passing cones, 3e38 where none passes)."""
    c = cones[:, :, None]
    pass_b, tn_b, _ = _cone_box_test(c[..., 0:3], c[..., 3:6], c[..., 6:9], c[..., 9],
                                     c[..., 10], boxes[:, None, :, 0:3], boxes[:, None, :, 3:6])
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


def cull_tests(cones: Tensor, fat: Optional[Tensor], bin_aabb: Tensor, super_aabb: Tensor,
               hyper_aabb: Optional[Tensor], S: int, H: int, ch: int, cs: int) -> Tensor:
    """Cone-box tests per block that the kernel runs on these inputs (the
    work its bound counts): every hyper or super of level 0, the selected
    hypers' supers, and R tests for each bin of a selected super."""
    Cb, R, _ = cones.shape
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    sup_ids, _ = _level0(cones, fat, super_aabb, hyper_aabb, H, ch, cs)
    bins_of = torch.clamp(n_bins - sup_ids.clamp(min=0).long() * S, 0, S)
    tests = R * torch.sum(torch.where(sup_ids >= 0, bins_of, 0), dim=1)
    if not ch:
        return tests + R * n_super
    n_hyper = hyper_aabb.shape[0]
    anyh, tnh = _group_box_tests(fat[:, None], hyper_aabb[None])
    hids = torch.arange(n_hyper, dtype=torch.int32, device=cones.device).expand(Cb, n_hyper)
    hyp_sel, _ = _select(anyh, tnh, hids, n_hyper, ch, _packs(n_hyper))
    sups_of = torch.clamp(n_super - hyp_sel.clamp(min=0).long() * H, 0, H)
    return tests + n_hyper + torch.sum(torch.where(hyp_sel >= 0, sups_of, 0), dim=1)


def _check_inputs(cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb):
    if cones.dim() != 3 or cones.shape[2] != CONE_WIDTH:
        raise ValueError(f"cones must be (Cb, R, {CONE_WIDTH}), got {tuple(cones.shape)}")
    Cb = cones.shape[0]
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    expect = {"cones": (cones, None), "n_hi": (n_hi, (Cb,)),
              "bin_aabb": (bin_aabb, (n_bins, 6)), "super_aabb": (super_aabb, (n_super, 6))}
    if ch:
        if hyper_aabb is None or fat is None:
            raise ValueError("the hyper level (ch > 0) needs hyper_aabb and fat")
        expect["fat"] = (fat, (Cb, CONE_WIDTH))
        expect["hyper_aabb"] = (hyper_aabb, (hyper_aabb.shape[0], 6))
        if not 1 <= ch <= hyper_aabb.shape[0]:
            raise ValueError(f"ch={ch} must be in [1, n_hyper={hyper_aabb.shape[0]}]")
        if cs > ch * H:
            raise ValueError(f"cs={cs} exceeds the ch*H={ch * H} supers of the hypers kept")
    for name, (x, shape) in expect.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != cones.device:
            raise ValueError(f"{name} is on {x.device}, cones on {cones.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= cs <= n_super and 1 <= cb <= min(n_bins, cs * S)):
        raise ValueError(f"budgets cs={cs}, cb={cb} out of range")
    if n_super * S < n_bins:
        raise ValueError("S bins per super do not cover the bins")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_cull_blocks``), built on first use."""
    fn = _build.load_library("cull_blocks").rmcl_cull_blocks
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cull_blocks(cones: Tensor, fat: Optional[Tensor], n_hi: Tensor, bin_aabb: Tensor,
                super_aabb: Tensor, hyper_aabb: Optional[Tensor], S: int, H: int, ch: int,
                cs: int, cb: int):
    """Nearest-first candidate bins per block (the module's contract).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`cull_blocks_reference`. ``cull_blocks.launches`` counts the
    kernel launches."""
    _check_inputs(cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb)
    dev = cones.device
    if dev.type == "cpu":
        return cull_blocks_reference(cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb,
                                     S, H, ch, cs, cb)
    if dev.type != "cuda":
        raise ValueError(f"cull_blocks runs on cuda or cpu tensors, not {dev}")
    Cb, R, _ = cones.shape
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    n_hyper = hyper_aabb.shape[0] if ch else 0
    idm = lambda n: (1 << max(1, (n - 1).bit_length())) - 1
    cand_bin = torch.empty((Cb, cb), dtype=torch.int32, device=dev)
    cand_count = torch.empty((Cb,), dtype=torch.int32, device=dev)
    cand_tnear = torch.empty((Cb, cb), dtype=torch.float32, device=dev)
    sat = torch.empty((Cb,), dtype=torch.bool, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = _kernel()(
            cones.data_ptr(), ptr(fat if ch else None), n_hi.data_ptr(),
            bin_aabb.data_ptr(), super_aabb.data_ptr(), ptr(hyper_aabb if ch else None),
            cand_bin.data_ptr(), cand_count.data_ptr(), cand_tnear.data_ptr(), sat.data_ptr(),
            Cb, R, n_bins, n_super, n_hyper, S, H, ch, cs, cb,
            idm(max(n_hyper, 1)), idm(n_super), idm(n_bins),
            int(_packs(max(n_hyper, 1))), int(_packs(n_super)) | (int(_packs(n_bins)) << 1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cull_blocks kernel launch failed: cudaError {err}")
    cull_blocks.launches += 1
    return cand_bin, cand_count, cand_tnear, sat


cull_blocks.launches = 0

# plain-version blocks per step: bounds the (blocks, cones, boxes) test tensors
_REF_TESTS_PER_STEP = 1 << 23


def cull_blocks_reference(cones: Tensor, fat: Optional[Tensor], n_hi: Tensor,
                          bin_aabb: Tensor, super_aabb: Tensor, hyper_aabb: Optional[Tensor],
                          S: int, H: int, ch: int, cs: int, cb: int):
    """The same function in plain PyTorch tensor ops, in steps of blocks
    that bound its intermediates. Runs on any device."""
    Cb, R, _ = cones.shape
    width = max(cs * S, super_aabb.shape[0] if not ch else ch * H)
    step = max(1, _REF_TESTS_PER_STEP // (R * width))
    if Cb > step:
        parts = [cull_blocks_reference(
            cones[s:s + step], None if fat is None else fat[s:s + step], n_hi[s:s + step],
            bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb) for s in range(0, Cb, step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = cones.device
    n_bins, n_super = bin_aabb.shape[0], super_aabb.shape[0]
    sup_ids, sat0 = _level0(cones, fat, super_aabb, hyper_aabb, H, ch, cs)
    # level 1: the sub-block cones x the selected supers' bins
    safe = sup_ids.clamp(min=0)
    boxes = _pad_rows(bin_aabb, n_super * S).reshape(n_super, S, 6)[safe]
    any_bin, tn_bin = _group_box_tests(cones, boxes.reshape(Cb, cs * S, 6))
    gbin = safe[..., None] * S + torch.arange(S, dtype=torch.int32, device=dev)
    valid = (any_bin.reshape(Cb, cs, S) & (sup_ids >= 0)[..., None]
             & (gbin < n_bins)).reshape(Cb, cs * S)
    cand_bin, tn = _select(valid, tn_bin, gbin.reshape(Cb, cs * S), n_bins, cb, _packs(n_bins))
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
