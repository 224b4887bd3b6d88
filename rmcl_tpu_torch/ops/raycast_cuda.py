"""Candidate-bin intersection: the hand-written CUDA kernels and their
plain PyTorch versions.

``intersect_bins`` is the port of the JAX package's only Pallas kernel,
``rmcl_tpu/ops/raycast_pallas.py::_intersect_kernel`` (wrapper
``intersect_bins_pallas``), and of the XLA chunk loop that the JAX library
runs in its place (``rmcl_tpu/ops/raycast_binned.py:951-1114``). The kernel
source is ``rmcl_tpu_torch/csrc/intersect_bins.cu``; its header says what
bounds it on the card and what the design does about that.

``intersect_groups`` (K2g) ports the same chunk loop's ``dir_groups``
variant (``rmcl_tpu/ops/raycast_binned.py:967-1015``): blocks whose rays
form G groups sharing one direction, the direction terms hoisted out of
the pairs. Its kernel is in the same source and shares K1's candidate walk.

``intersect_factored`` (K4) ports the Baldwin-Weber pair loop of
``rmcl_tpu/ops/raycast_binned.py::cast_rays_binned_factored`` (:1650-1771),
source ``rmcl_tpu_torch/csrc/intersect_factored.cu``; its contract is in
its docstring.

Contract of ``intersect_bins`` (the Pallas kernel's): ray blocks ``ob, db (n_blk, Rb, 3)``,
``t_min_b, t_max_b (n_blk, Rb)``; per block a nearest-first candidate list
``cand_bin (n_blk, cb)`` int32 (-1 padding), ``cand_count (n_blk,)`` and
``cand_tnear (n_blk, cb)``; triangle payload ``tri (n_rows, 14, B)`` with B
a power of two. Returns ``t_best (n_blk, Rb)`` f32 (packed, rounded up) and
``ref (n_blk, Rb)`` int32 = bin * B + j, or -1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rmcl_tpu_torch import _build

Tensor = torch.Tensor

_BIG = 3.0e38
_EPS = 1e-7


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point (``rmcl_intersect_bins``), built on first use."""
    fn = _build.load_library("intersect_bins").rmcl_intersect_bins
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_registers() -> dict:
    """Registers and local-memory bytes a thread (spills show as local
    memory) of K1 and K2g as built, by ``cudaFuncGetAttributes``: ``{"K1":
    (regs, local), "K2g": (regs, local)}``. Needs a card."""
    fn = _build.load_library("intersect_bins").rmcl_intersect_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = {}
    for which, name in enumerate(("K1", "K2g")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        if fn(which, ctypes.byref(regs), ctypes.byref(local)):
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name}")
        out[name] = (regs.value, local.value)
    return out


def lane_split(n_rays: int, B: int) -> int:
    """Lane groups S that share one ray's triangles in a kernel launch
    (lane s tests j = s, s + S, ...): the largest power of two that leaves
    each group a triangle (S <= B), adds at most one warp per 32 rays
    (S <= n_rays / 32) and fits the CTA, ceil(n_rays / (32 / S)) warps, in
    1024 threads; so S <= 4. Blocks of few rays come in large grids that
    fill the card already, where a split only adds shuffles and barrier
    waits: on an H100, K1 at 450,000 blocks of 32 rays runs fastest at
    S = 1, and at 113 blocks of 128 rays as fast at S = 4 as at 8 and
    2.2x slower at S = 1 (the lane-split measurements in CHANGES.md)."""
    S = 1
    while 2 * S <= B and 64 * S <= n_rays and -(-n_rays * 2 * S // 32) * 32 <= 1024:
        S *= 2
    return S


def _check_aligned(tri):
    if tri.data_ptr() % 16:
        raise ValueError("tri must start on a 16-byte boundary (K4 stages bins with 16-byte "
                         "cp.async copies): pass a fresh tensor, not an offset view")


def _check_inputs(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear,
                  order=None):
    n_blk, Rb = ob.shape[0], ob.shape[1]
    cb = cand_bin.shape[1] if cand_bin.dim() == 2 else -1
    expect = {
        "tri": (tri, torch.float32, None),
        "ob": (ob, torch.float32, (n_blk, Rb, 3)),
        "db": (db, torch.float32, (n_blk, Rb, 3)),
        "t_min_b": (t_min_b, torch.float32, (n_blk, Rb)),
        "t_max_b": (t_max_b, torch.float32, (n_blk, Rb)),
        "cand_bin": (cand_bin, torch.int32, (n_blk, cb)),
        "cand_count": (cand_count, torch.int32, (n_blk,)),
        "cand_tnear": (cand_tnear, torch.float32, (n_blk, cb)),
    }
    if order is not None:
        expect["order"] = (order, torch.int32, (n_blk,))
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != tri.device:
            raise ValueError(f"{name} is on {x.device}, tri on {tri.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tri.dim() != 3 or tri.shape[1] != 14:
        raise ValueError(f"tri must be (n_rows, 14, B), got {tuple(tri.shape)}")
    B = tri.shape[2]
    if B < 1 or B & (B - 1):
        raise ValueError(f"bin size {B} must be a power of two (packed-key min)")
    if not 1 <= Rb <= 1024:
        raise ValueError(f"block size {Rb} must be in [1, 1024] (one CTA, a lane or more a ray)")
    if cb < 1:
        raise ValueError("cand_bin must be (n_blk, cb) with cb >= 1")


def intersect_bins(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor,
                   t_max_b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                   cand_tnear: Tensor, order: "Tensor | None" = None):
    """Closest hit per ray over each block's candidate bins.

    ``order`` (int32 (n_blk,), a permutation, optional) is the blocks'
    launch order: CTA i works on block ``order[i]``. Outputs stay in block
    order, and the order changes no result.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`intersect_bins_reference`. ``intersect_bins.launches`` counts the
    kernel launches."""
    _check_inputs(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, order)
    dev = tri.device
    if dev.type == "cpu":
        return intersect_bins_reference(
            tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, order)
    if dev.type != "cuda":
        raise ValueError(f"intersect_bins runs on cuda or cpu tensors, not {dev}")
    n_blk, Rb = ob.shape[0], ob.shape[1]
    t_best = torch.empty((n_blk, Rb), dtype=torch.float32, device=dev)
    ref = torch.empty((n_blk, Rb), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(
            tri.data_ptr(), ob.data_ptr(), db.data_ptr(),
            t_min_b.data_ptr(), t_max_b.data_ptr(),
            cand_bin.data_ptr(), cand_count.data_ptr(), cand_tnear.data_ptr(),
            0 if order is None else order.data_ptr(), t_best.data_ptr(), ref.data_ptr(),
            n_blk, Rb, cand_bin.shape[1], tri.shape[2], lane_split(Rb, tri.shape[2]),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"intersect_bins kernel launch failed: cudaError {err}")
    intersect_bins.launches += 1
    return t_best, ref


intersect_bins.launches = 0


def _moller_trumbore(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                     e2x, e2y, e2z, t_min):
    """Hit distance of rays against triangles (broadcast), 3e38 where the
    ray misses; the kernel's arithmetic, term for term."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = (torch.minimum(torch.minimum(u, v), (1.0 + _EPS) - (u + v)) >= -_EPS) & (t > t_min)
    return torch.where(ok, t, _BIG)


def winner_t(tri: Tensor, o: Tensor, d: Tensor, t_min: Tensor, ref: Tensor) -> Tensor:
    """The t that :func:`intersect_bins` would record for the triangle
    ``ref = bin * B + j`` names, per ray: its hit distance with the low
    log2(B) mantissa bits set, as the packed key leaves them; 3e38 where
    ``ref`` is -1 or the ray misses that triangle. Rays ``o, d (..., 3)``,
    ``t_min`` and ``ref (...)``.

    A winner that differs from another run's is a true near-tie only when
    this t agrees with the other run's ``t_best``."""
    B = tri.shape[2]
    jmask = B - 1
    r = ref.clamp(min=0).long()
    tw = tri[r // B, :9, r % B]  # (..., 9)
    t = _moller_trumbore(*o.unbind(-1), *d.unbind(-1), *tw.unbind(-1), t_min)
    t = torch.where(ref >= 0, t, _BIG)
    return ((t.view(torch.int32) & ~jmask) | jmask).view(torch.float32)


def intersect_bins_reference(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor,
                             t_max_b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                             cand_tnear: Tensor, order: "Tensor | None" = None):
    """The same function in plain PyTorch: one step per candidate slot over
    (n_blk, B, Rb) pair tensors, the same packed-key fold and the same
    per-block nearest-first exit. Runs on any device. ``order`` is taken
    and ignored: every block runs on its own, so a launch order changes
    nothing here."""
    n_blk, Rb, _ = ob.shape
    B = tri.shape[2]
    cb = cand_bin.shape[1]
    jmask = B - 1
    # zero sentinel row for finished blocks: all-zero triangles give
    # inv_det = 0 -> t = 0, which fails the strict t > t_min gate
    tri9 = torch.cat([tri[:, :9], tri.new_zeros((1, 9, B))], 0)
    sentinel = tri.shape[0]
    ox, oy, oz = (ob[:, None, :, k] for k in range(3))  # (n_blk, 1, Rb)
    dx, dy, dz = (db[:, None, :, k] for k in range(3))
    t_min = t_min_b[:, None, :]
    j_iota = torch.arange(B, dtype=torch.int32, device=tri.device)[None, :, None]
    t_best = t_max_b.clone()
    ref = torch.full((n_blk, Rb), -1, dtype=torch.int32, device=tri.device)
    running = torch.ones(n_blk, dtype=torch.bool, device=tri.device)
    for c in range(cb):
        running = running & (c < cand_count) & (
            cand_tnear[:, c] <= torch.max(t_best, dim=1).values)
        if not bool(running.any()):
            break
        bid = torch.where(running, cand_bin[:, c], sentinel)
        tw = tri9[bid]  # (n_blk, 9, B)
        t_cand = _moller_trumbore(
            ox, oy, oz, dx, dy, dz, *(tw[:, k, :, None] for k in range(9)),  # (n_blk, B, 1)
            t_min)
        key = (t_cand.view(torch.int32) & ~jmask) | j_iota
        key_min = torch.min(key, dim=1).values  # (n_blk, Rb)
        t_bin = (key_min | jmask).view(torch.float32)
        better = running[:, None] & (t_bin < t_best)
        t_best = torch.where(better, t_bin, t_best)
        ref = torch.where(better, bid[:, None] * B + (key_min & jmask), ref)
    return t_best, ref


# --- K2g: blocks of G groups of rays sharing one direction ---


@functools.lru_cache(maxsize=None)
def _groups_kernel():
    """K2g's C entry point (``rmcl_intersect_groups``), built on first use."""
    fn = _build.load_library("intersect_bins").rmcl_intersect_groups
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def intersect_groups(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor, t_max_b: Tensor,
                     cand_bin: Tensor, cand_count: Tensor, cand_tnear: Tensor, groups: int,
                     order: "Tensor | None" = None):
    """Closest hit per ray over each block's candidate bins, for blocks whose
    Rb rays form ``groups`` = G contiguous groups of P = Rb / G rays that
    share one direction: the group's first ray's (``db[:, ::P]``). The
    result is undefined where a group's rays do not share it. Inputs,
    ``order`` and outputs as :func:`intersect_bins`.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`intersect_groups_reference`. ``intersect_groups.launches`` counts
    the kernel launches."""
    _check_inputs(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, order)
    G = int(groups)
    n_blk, Rb = ob.shape[0], ob.shape[1]
    if not 1 <= G <= Rb or Rb % G:
        raise ValueError(f"groups ({G}) must divide the block size ({Rb})")
    dev = tri.device
    if dev.type == "cpu":
        return intersect_groups_reference(tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count,
                                          cand_tnear, G, order)
    if dev.type != "cuda":
        raise ValueError(f"intersect_groups runs on cuda or cpu tensors, not {dev}")
    t_best = torch.empty((n_blk, Rb), dtype=torch.float32, device=dev)
    ref = torch.empty((n_blk, Rb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _groups_kernel()(
            tri.data_ptr(), ob.data_ptr(), db.data_ptr(),
            t_min_b.data_ptr(), t_max_b.data_ptr(),
            cand_bin.data_ptr(), cand_count.data_ptr(), cand_tnear.data_ptr(),
            0 if order is None else order.data_ptr(), t_best.data_ptr(), ref.data_ptr(),
            n_blk, Rb, cand_bin.shape[1], tri.shape[2], G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"intersect_groups kernel launch failed: cudaError {err}")
    intersect_groups.launches += 1
    return t_best, ref


intersect_groups.launches = 0


def group_terms(tw: Tensor, dg: Tensor):
    """The hoisted terms of every (triangle, group): ``tw (n, 9, B)``
    triangles' v0/e1/e2 and ``dg (n, G, 3)`` group directions give (pux,
    puy, puz, cu, qvx, qvy, qvz, cv, ntx, nty, ntz, ct), each (n, B, G, 1),
    with which a ray o of the group gets u = o.pu - cu, v = cv - o.qv, t =
    o.nt - ct. The JAX package's arithmetic, operation by operation."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tw[:, k, :, None, None] for k in range(9))
    sdx, sdy, sdz = (dg[:, None, :, k, None] for k in range(3))
    pvx = sdy * e2z - sdz * e2y  # d x e2
    pvy = sdz * e2x - sdx * e2z
    pvz = sdx * e2y - sdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    qdx = sdy * e1z - sdz * e1y  # d x e1
    qdy = sdz * e1x - sdx * e1z
    qdz = sdx * e1y - sdy * e1x
    ngx = e1y * e2z - e1z * e2y  # e1 x e2
    ngy = e1z * e2x - e1x * e2z
    ngz = e1x * e2y - e1y * e2x
    pux, puy, puz = pvx * inv, pvy * inv, pvz * inv
    qvx, qvy, qvz = qdx * inv, qdy * inv, qdz * inv
    ntx, nty, ntz = ngx * inv, ngy * inv, ngz * inv
    cu = v0x * pux + v0y * puy + v0z * puz
    cv = v0x * qvx + v0y * qvy + v0z * qvz
    ct = v0x * ntx + v0y * nty + v0z * ntz
    return pux, puy, puz, cu, qvx, qvy, qvz, cv, ntx, nty, ntz, ct


def _group_t(terms, ox, oy, oz, t_min):
    """Hit distance (3e38 where the ray misses) of rays o against the
    hoisted terms (broadcast); the kernel's arithmetic, term for term."""
    pux, puy, puz, cu, qvx, qvy, qvz, cv, ntx, nty, ntz, ct = terms
    u = (ox * pux + oy * puy + oz * puz) - cu
    v = cv - (ox * qvx + oy * qvy + oz * qvz)
    t = (ox * ntx + oy * nty + oz * ntz) - ct
    ok = (torch.minimum(torch.minimum(u, v), (1.0 + _EPS) - (u + v)) >= -_EPS) & (t > t_min)
    return torch.where(ok, t, _BIG)


# plain-version pair elements per step of K2g's plain version (blocks x B x Rb)
_GROUP_PAIRS_PER_STEP = 1 << 24


def intersect_groups_reference(tri: Tensor, ob: Tensor, db: Tensor, t_min_b: Tensor,
                               t_max_b: Tensor, cand_bin: Tensor, cand_count: Tensor,
                               cand_tnear: Tensor, groups: int, order: "Tensor | None" = None):
    """The same function in plain PyTorch: one step per candidate slot over
    (blocks, B, G, P) pair tensors with the (triangle, group) terms of
    :func:`group_terms`, the same packed-key fold and the same per-block
    nearest-first exit, in steps of blocks that bound memory. Runs on any
    device; ``order`` is taken and ignored."""
    n_blk, Rb, _ = ob.shape
    B = tri.shape[2]
    step = max(1, _GROUP_PAIRS_PER_STEP // (B * Rb))
    # zero sentinel row for finished blocks: all-zero triangles give inv = 0
    # -> t = 0, which fails the strict t > t_min gate
    tri9 = torch.cat([tri[:, :9], tri.new_zeros((1, 9, B))], 0)
    outs = [_groups_slice(tri9, ob[s:s + step], db[s:s + step], t_min_b[s:s + step],
                          t_max_b[s:s + step], cand_bin[s:s + step], cand_count[s:s + step],
                          cand_tnear[s:s + step], int(groups))
            for s in range(0, n_blk, step)]
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _groups_slice(tri9, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, G):
    n, Rb, _ = ob.shape
    B = tri9.shape[2]
    P = Rb // G
    jmask = B - 1
    sentinel = tri9.shape[0] - 1
    dg = db[:, ::P]  # (n, G, 3): one direction a group, its first ray's
    ox, oy, oz = (ob.reshape(n, 1, G, P, 3)[..., k] for k in range(3))  # (n, 1, G, P)
    t_min = t_min_b.reshape(n, 1, G, P)
    j_iota = torch.arange(B, dtype=torch.int32, device=tri9.device)[None, :, None, None]
    t_best = t_max_b.clone()
    ref = torch.full((n, Rb), -1, dtype=torch.int32, device=tri9.device)
    running = torch.ones(n, dtype=torch.bool, device=tri9.device)
    for c in range(cand_bin.shape[1]):
        running = running & (c < cand_count) & (
            cand_tnear[:, c] <= torch.max(t_best, dim=1).values)
        if not bool(running.any()):
            break
        bid = torch.where(running, cand_bin[:, c], sentinel)
        t_cand = _group_t(group_terms(tri9[bid], dg), ox, oy, oz, t_min)  # (n, B, G, P)
        key = (t_cand.view(torch.int32) & ~jmask) | j_iota
        key_min = torch.amin(key, dim=1).reshape(n, Rb)
        t_bin = (key_min | jmask).view(torch.float32)
        better = running[:, None] & (t_bin < t_best)
        t_best = torch.where(better, t_bin, t_best)
        ref = torch.where(better, bid[:, None] * B + (key_min & jmask), ref)
    return t_best, ref


# --- the factored pair loop (Baldwin-Weber over pose x direction blocks) ---

_ONE_PLUS_EPS = 1.0 + _EPS


@functools.lru_cache(maxsize=None)
def _factored_kernel():
    """The kernel's C entry point (``rmcl_intersect_factored``), built on first use."""
    fn = _build.load_library("intersect_factored").rmcl_intersect_factored
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# K4's tile layout: 2 poses x 2 directions a thread, 4 lane groups a tile,
# at most 256 threads a CTA, and its shared memory (the float4 terms of
# every (triangle, direction) and (triangle, pose), two staged bins) small
# enough for two CTAs an SM
_TILE_SPLIT = 4
_TILE_MAX_THREADS = 256
_TILE_MAX_SMEM = 100 * 1024


def factored_layout(G: int, P: int, paired: bool, B: int):
    """K4's launch layout for blocks of G directions x P poses: ``(True,
    4)`` for the tile layout (a thread owns 2 poses x 2 directions and
    reads the shared per-direction and per-pose terms as float4s), which
    needs P >= 2 and G >= 2 and no pairing; else ``(False, S)``, one ray a
    thread with S = :func:`lane_split` lane groups a ray."""
    if not paired and P >= 2 and G >= 2:
        n_tiles = -(-P // 2) * -(-G // 2)
        threads = -(-n_tiles // 8) * 32
        smem = 16 * (B * (G + P + 2) + G + P) + 72 * B
        if threads <= _TILE_MAX_THREADS and smem <= _TILE_MAX_SMEM:
            return True, _TILE_SPLIT
    return False, lane_split(G * (1 if paired else P), B)


def _check_factored(tri, o_blk, d_blk, alive, t_min, cand_bin, cand_count, cand_tnear,
                    paired, order):
    n_blk, G = d_blk.shape[0], d_blk.shape[1] if d_blk.dim() == 3 else -1
    P = o_blk.shape[1] if o_blk.dim() == 3 else -1
    cb = cand_bin.shape[1] if cand_bin.dim() == 2 else -1
    expect = {
        "tri": (tri, torch.float32, None),
        "o_blk": (o_blk, torch.float32, (n_blk, G if paired else P, 3)),
        "d_blk": (d_blk, torch.float32, (n_blk, G, 3)),
        "alive": (alive, torch.float32, (n_blk,)),
        "cand_bin": (cand_bin, torch.int32, (n_blk, cb)),
        "cand_count": (cand_count, torch.int32, (n_blk,)),
        "cand_tnear": (cand_tnear, torch.float32, (n_blk, cb)),
    }
    if order is not None:
        expect["order"] = (order, torch.int32, (n_blk,))
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != tri.device:
            raise ValueError(f"{name} is on {x.device}, tri on {tri.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tri.dim() != 3 or tri.shape[1] != 14:
        raise ValueError(f"tri must be (n_rows, 14, B), got {tuple(tri.shape)}")
    B = tri.shape[2]
    if B < 1 or B & (B - 1):
        raise ValueError(f"bin size {B} must be a power of two (packed-key min)")
    rays = G * (1 if paired else P)
    if not 1 <= rays <= 1024:
        raise ValueError(f"{rays} rays per block: must be in [1, 1024] "
                         "(one CTA, a lane or more a ray)")
    if cb < 1:
        raise ValueError("cand_bin must be (n_blk, cb) with cb >= 1")
    if not t_min >= 0.0:
        raise ValueError("t_min must be >= 0: degenerate triangles give t = 0, which only "
                         "the strict t > t_min gate rejects")


def intersect_factored(tri: Tensor, o_blk: Tensor, d_blk: Tensor, alive: Tensor,
                       t_min: float, t_max: float, cand_bin: Tensor, cand_count: Tensor,
                       cand_tnear: Tensor, paired: bool = False, order: Tensor | None = None):
    """Closest hit per ray of factored blocks over each block's candidates.

    Block b's rays are its P origins ``o_blk[b]`` x its G directions
    ``d_blk[b]`` (ray g*P + p), or with ``paired`` origin g with direction
    g (``o_blk (n_blk, G, 3)``). ``alive (n_blk,)`` f32 gates the blocks:
    t_best starts at ``alive * t_max``. Candidates as K1's. ``order``
    (int32, optional) is the launch order of the blocks and changes no
    result. Returns ``t_best (n_blk, G, P_eff)`` f32 (the packed, rounded-up
    t) and ``ref (n_blk, G, P_eff)`` int32 = bin * B + j, or -1.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`intersect_factored_reference`. ``intersect_factored.launches``
    counts the kernel launches."""
    t_min, t_max = float(t_min), float(t_max)
    _check_factored(tri, o_blk, d_blk, alive, t_min, cand_bin, cand_count, cand_tnear,
                    paired, order)
    dev = tri.device
    if dev.type == "cpu":
        return intersect_factored_reference(tri, o_blk, d_blk, alive, t_min, t_max, cand_bin,
                                            cand_count, cand_tnear, paired)
    if dev.type != "cuda":
        raise ValueError(f"intersect_factored runs on cuda or cpu tensors, not {dev}")
    _check_aligned(tri)
    n_blk, G = d_blk.shape[0], d_blk.shape[1]
    P = o_blk.shape[1]
    P_eff = 1 if paired else P
    t_best = torch.empty((n_blk, G, P_eff), dtype=torch.float32, device=dev)
    ref = torch.empty((n_blk, G, P_eff), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _factored_kernel()(
            tri.data_ptr(), o_blk.data_ptr(), d_blk.data_ptr(), alive.data_ptr(),
            cand_bin.data_ptr(), cand_count.data_ptr(), cand_tnear.data_ptr(),
            0 if order is None else order.data_ptr(), t_best.data_ptr(), ref.data_ptr(),
            n_blk, G, P, int(paired), cand_bin.shape[1], tri.shape[2],
            *factored_layout(G, P, paired, tri.shape[2]), t_min, t_max,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"intersect_factored kernel launch failed: cudaError {err}")
    intersect_factored.launches += 1
    return t_best, ref


intersect_factored.launches = 0


def plane_of(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Unnormalized plane (ng = e1 x e2, c0 = ng.v0) of triangles, with the
    pair loop's operation order."""
    ngx = e1y * e2z - e1z * e2y
    ngy = e1z * e2x - e1x * e2z
    ngz = e1x * e2y - e1y * e2x
    return ngx, ngy, ngz, ngx * v0x + ngy * v0y + ngz * v0z


def bw_rows(tw: Tensor):
    """Per-triangle Baldwin-Weber rows from packed v0/e1/e2 ``tw (..., 9,
    B)``: (ngx, ngy, ngz, c0, m1x, m1y, m1z, m2x, m2y, m2z, cu, cv), each
    (..., B) — the unnormalized plane normal e1 x e2, its offset ng.v0, and
    the barycentric rows m1 = e2 x ng / |ng|^2, m2 = ng x e1 / |ng|^2."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tw[..., :9, :].unbind(-2)
    ngx, ngy, ngz, c0 = plane_of(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z)
    nn = ngx * ngx + ngy * ngy + ngz * ngz
    inv_nn = 1.0 / torch.clamp(nn, min=1e-30)
    m1x = (e2y * ngz - e2z * ngy) * inv_nn
    m1y = (e2z * ngx - e2x * ngz) * inv_nn
    m1z = (e2x * ngy - e2y * ngx) * inv_nn
    m2x = (ngy * e1z - ngz * e1y) * inv_nn
    m2y = (ngz * e1x - ngx * e1z) * inv_nn
    m2z = (ngx * e1y - ngy * e1x) * inv_nn
    cu = v0x * m1x + v0y * m1y + v0z * m1z
    cv = v0x * m2x + v0y * m2y + v0z * m2z
    return ngx, ngy, ngz, c0, m1x, m1y, m1z, m2x, m2y, m2z, cu, cv


def _bw_t(rows, o, d, t_min):
    """Hit distance (3e38 where the ray misses) from the rows (broadcast
    against the rays' components o, d); the kernel's arithmetic, term for
    term. Direction terms are formed before the origin terms meet them, so
    broadcasting over poses repeats identical values."""
    ngx, ngy, ngz, c0, m1x, m1y, m1z, m2x, m2y, m2z, cu, cv = rows
    ox, oy, oz = o
    dx, dy, dz = d
    Nd = ngx * dx + ngy * dy + ngz * dz
    invNd = torch.where(torch.abs(Nd) > 1e-30, 1.0 / Nd, 0.0)
    Bu = m1x * dx + m1y * dy + m1z * dz
    Bv = m2x * dx + m2y * dy + m2z * dz
    No = c0 - (ngx * ox + ngy * oy + ngz * oz)
    Au = (m1x * ox + m1y * oy + m1z * oz) - cu
    Av = (m2x * ox + m2y * oy + m2z * oz) - cv
    t = No * invNd
    u = Au + t * Bu
    v = Av + t * Bv
    ok = (torch.minimum(torch.minimum(u, v), _ONE_PLUS_EPS - (u + v)) >= -_EPS) & (t > t_min)
    return torch.where(ok, t, _BIG)


def factored_winner_t(tri: Tensor, o: Tensor, d: Tensor, t_min: float, ref: Tensor) -> Tensor:
    """The t that :func:`intersect_factored` would record for the triangle
    ``ref = bin * B + j`` names, per ray ``o, d (..., 3)``: its
    Baldwin-Weber hit distance with the low log2(B) mantissa bits set;
    3e38 where ``ref`` is -1 or the ray misses that triangle."""
    B = tri.shape[2]
    jmask = B - 1
    r = ref.clamp(min=0).long()
    rows = bw_rows(tri[r // B, :9, r % B][..., None])  # each (..., 1)
    t = _bw_t([x[..., 0] for x in rows], o.unbind(-1), d.unbind(-1), t_min)
    t = torch.where(ref >= 0, t, _BIG)
    return ((t.view(torch.int32) & ~jmask) | jmask).view(torch.float32)


# plain-version pair elements per step (blocks x B x G x P): bounds memory
_REF_PAIRS_PER_STEP = 1 << 24


def intersect_factored_reference(tri: Tensor, o_blk: Tensor, d_blk: Tensor, alive: Tensor,
                                 t_min: float, t_max: float, cand_bin: Tensor,
                                 cand_count: Tensor, cand_tnear: Tensor, paired: bool = False):
    """The same function in plain PyTorch: one step per candidate slot over
    (blocks, B, G, P) pair tensors, the same packed-key fold and the same
    per-block nearest-first exit, in steps of blocks that bound memory.
    Runs on any device."""
    t_min, t_max = float(t_min), float(t_max)
    n_blk, G = d_blk.shape[0], d_blk.shape[1]
    B = tri.shape[2]
    P_eff = 1 if paired else o_blk.shape[1]
    step = max(1, _REF_PAIRS_PER_STEP // (B * G * P_eff))
    # zero sentinel row for finished blocks: zero rows give Nd = 0 ->
    # invNd = 0 -> t = 0, which fails the strict t > t_min gate
    tri9 = torch.cat([tri[:, :9], tri.new_zeros((1, 9, B))], 0)
    outs = [_factored_slice(tri9, o_blk[s:s + step], d_blk[s:s + step], alive[s:s + step],
                            t_min, t_max, cand_bin[s:s + step], cand_count[s:s + step],
                            cand_tnear[s:s + step], paired)
            for s in range(0, n_blk, step)]
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _factored_slice(tri9, o_blk, d_blk, alive, t_min, t_max, cand_bin, cand_count, cand_tnear,
                    paired):
    n, G = d_blk.shape[0], d_blk.shape[1]
    B = tri9.shape[2]
    jmask = B - 1
    sentinel = tri9.shape[0] - 1
    P_eff = 1 if paired else o_blk.shape[1]
    # rays: directions (n, 1, G, 1); origins (n, 1, 1, P), or (n, 1, G, 1) paired
    d = [d_blk[:, None, :, None, k] for k in range(3)]
    o = [o_blk[:, None, :, None, k] if paired else o_blk[:, None, None, :, k] for k in range(3)]
    j_iota = torch.arange(B, dtype=torch.int32, device=tri9.device)[None, :, None, None]
    t_best = (alive * t_max)[:, None, None].expand(n, G, P_eff).clone()
    ref = torch.full((n, G, P_eff), -1, dtype=torch.int32, device=tri9.device)
    running = torch.ones(n, dtype=torch.bool, device=tri9.device)
    for c in range(cand_bin.shape[1]):
        running = running & (c < cand_count) & (
            cand_tnear[:, c] <= torch.amax(t_best, dim=(1, 2)))
        if not bool(running.any()):
            break
        bid = torch.where(running, cand_bin[:, c], sentinel)
        rows = [x[:, :, None, None] for x in bw_rows(tri9[bid])]  # (n, B, 1, 1)
        t_cand = _bw_t(rows, o, d, t_min)  # (n, B, G, P)
        key = (t_cand.view(torch.int32) & ~jmask) | j_iota
        key_min = torch.amin(key, dim=1)  # (n, G, P)
        t_bin = (key_min | jmask).view(torch.float32)
        better = running[:, None, None] & (t_bin < t_best)
        t_best = torch.where(better, t_bin, t_best)
        ref = torch.where(better, bid[:, None, None] * B + (key_min & jmask), ref)
    return t_best, ref
