"""Host-side BVH construction: a vectorised numpy LBVH in the threaded layout.

Counterpart of ``rmcl_tpu.bvh.builder``: a linear BVH over Morton-sorted
primitives with Karras-style highest-differing-bit splits, expanded
breadth-first with vectorised binary searches and converted to the
preorder-threaded slot layout (:mod:`rmcl_tpu_torch.bvh.types`) with
vectorised per-level passes. It emits the same slots as the JAX package's
``build_bvh``, bit for bit; the slot table is then copied to ``device``.

``build_bvh_sah`` builds the same slot layout with the native C++
binned-SAH builder (:mod:`rmcl_tpu_torch.bvh.native`, the JAX package's
source built by g++ at first use): fewer node visits a ray than the Morton
LBVH. ``build_bvh_auto`` takes it where the library builds, the LBVH
otherwise.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.bvh import native
from rmcl_tpu_torch.bvh.types import BVH, SENTINEL_LINK
from rmcl_tpu_torch.geom.mesh import TriangleMesh


def _expand_bits_21(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 so consecutive bits are 3 apart."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes_3d(points01: np.ndarray) -> np.ndarray:
    """63-bit Morton codes for points normalized to [0, 1]^3."""
    scaled = np.clip(points01 * (2**21 - 1), 0, 2**21 - 1).astype(np.uint64)
    return (
        (_expand_bits_21(scaled[:, 0]) << np.uint64(2))
        | (_expand_bits_21(scaled[:, 1]) << np.uint64(1))
        | _expand_bits_21(scaled[:, 2])
    )


def _highest_bit(x: np.ndarray) -> np.ndarray:
    """Position of the highest set bit of each uint64 (x must be nonzero)."""
    p = np.zeros(x.shape, np.int64)
    t = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (t >> np.uint64(shift)) != 0
        p += np.where(mask, shift, 0)
        t = np.where(mask, t >> np.uint64(shift), t)
    return p


def _vector_searchsorted(codes, lo, hi, target):
    """For each i: first index in [lo_i, hi_i) with codes[idx] >= target_i,
    all rows advancing in lockstep."""
    lo = lo.copy()
    hi = hi.copy()
    iters = int(np.ceil(np.log2(max(len(codes), 2)))) + 1
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        pred = codes[np.minimum(mid, len(codes) - 1)] >= target
        hi = np.where(active & pred, mid, hi)
        lo = np.where(active & ~pred, mid + 1, lo)
    return lo


def _split_ranges(codes, lo, hi):
    """Karras split: for each range [lo, hi) (size >= 2) over sorted codes,
    the split s with lo < s < hi at the highest differing Morton bit (the
    midpoint for runs of equal codes)."""
    c_lo = codes[lo]
    c_hi = codes[hi - 1]
    diff = c_lo ^ c_hi
    dup = diff == 0
    p = _highest_bit(np.where(dup, np.uint64(1), diff))
    # smallest code with bit p set and the shared prefix above p
    target = (c_hi >> p.astype(np.uint64)) << p.astype(np.uint64)
    s = _vector_searchsorted(codes, lo + 1, hi, target)
    mid = (lo + hi) // 2
    s = np.where(dup, mid, s)
    # keep both children non-empty whatever the code distribution
    return np.clip(s, lo + 1, hi - 1)


def build_bvh_arrays(mesh: TriangleMesh, prim_ids: Optional[np.ndarray] = None,
                     inst_ids: Optional[np.ndarray] = None):
    """The threaded slot table on the host: ``(nodes (2T-1, 16) float32,
    root_link int32, scene_min (3,), scene_max (3,), n_tris)``.

    prim_ids/inst_ids override the ids written into the leaf slots."""
    tri = mesh.triangles().astype(np.float32)  # (T, 3, 3)
    T = tri.shape[0]
    if T == 0:
        raise ValueError("cannot build BVH over empty mesh")
    if prim_ids is None:
        prim_ids = np.arange(T, dtype=np.int32)
    if inst_ids is None:
        inst_ids = np.zeros(T, dtype=np.int32)

    prim_min = tri.min(axis=1)
    prim_max = tri.max(axis=1)
    centroid = 0.5 * (prim_min + prim_max)
    scene_min = prim_min.min(axis=0)
    scene_max = prim_max.max(axis=0)
    extent = np.maximum(scene_max - scene_min, 1e-12)

    codes = morton_codes_3d((centroid - scene_min) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int64)
    codes = codes[order]

    # sorted-order triangle data destined for leaf slots
    tri_s = tri[order]
    v0 = tri_s[:, 0]
    e1 = tri_s[:, 1] - tri_s[:, 0]
    e2 = tri_s[:, 2] - tri_s[:, 0]
    normal = np.cross(e1, e2)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-20)
    leaf_prim = prim_ids[order]
    leaf_inst = inst_ids[order]

    n_internal = T - 1
    n_slots = 2 * T - 1
    nodes = np.zeros((n_slots, 16), np.float32)

    if T == 1:
        _write_leaf_rows(nodes, np.array([0]), v0, e1, e2, normal, leaf_prim, leaf_inst,
                         np.array([0]))
        nodes[0, 13] = np.int32(SENTINEL_LINK).view(np.float32)
        return nodes, np.int32(~0), scene_min, scene_max, T

    # ---- breadth-first internal construction -----------------------------
    # slot ids during construction: internal 0..T-2 (BFS order), leaf j
    # (sorted position) = (T-1) + j; converted to preorder below
    leaf_base = n_internal
    child_slot = np.zeros((n_internal, 2), np.int64)
    child_is_leaf = np.zeros((n_internal, 2), bool)
    levels: List[np.ndarray] = []

    ids = np.array([0], np.int64)
    lo = np.array([0], np.int64)
    hi = np.array([T], np.int64)
    next_free = 1
    while len(ids):
        levels.append(ids)
        split = _split_ranges(codes, lo, hi)
        new_ids, new_lo, new_hi = [], [], []
        for side, (clo, chi) in enumerate(((lo, split), (split, hi))):
            is_leaf = (chi - clo) == 1
            child_is_leaf[ids, side] = is_leaf
            child_slot[ids[is_leaf], side] = leaf_base + clo[is_leaf]
            n_new = int((~is_leaf).sum())
            fresh = np.arange(next_free, next_free + n_new, dtype=np.int64)
            next_free += n_new
            child_slot[ids[~is_leaf], side] = fresh
            new_ids.append(fresh)
            new_lo.append(clo[~is_leaf])
            new_hi.append(chi[~is_leaf])
        ids = np.concatenate(new_ids)
        lo = np.concatenate(new_lo)
        hi = np.concatenate(new_hi)
    assert next_free == n_internal, (next_free, n_internal)

    # ---- bottom-up: subtree AABBs and sizes ------------------------------
    sub_min = np.empty((n_slots, 3), np.float32)
    sub_max = np.empty((n_slots, 3), np.float32)
    size = np.ones(n_slots, np.int64)  # leaves have size 1
    sub_min[leaf_base:] = prim_min[order]
    sub_max[leaf_base:] = prim_max[order]
    for ids in reversed(levels):
        s0 = child_slot[ids, 0]
        s1 = child_slot[ids, 1]
        sub_min[ids] = np.minimum(sub_min[s0], sub_min[s1])
        sub_max[ids] = np.maximum(sub_max[s0], sub_max[s1])
        size[ids] = 1 + size[s0] + size[s1]

    # ---- top-down: preorder positions, hit/miss links --------------------
    pre = np.zeros(n_slots, np.int64)
    miss = np.full(n_slots, int(SENTINEL_LINK), np.int64)  # in link encoding
    for ids in levels:
        s0 = child_slot[ids, 0]
        s1 = child_slot[ids, 1]
        pre[s0] = pre[ids] + 1
        pre[s1] = pre[ids] + 1 + size[s0]

    def link_of(slot_ids: np.ndarray, is_leaf: np.ndarray) -> np.ndarray:
        p = pre[slot_ids]
        return np.where(is_leaf, ~p, p)

    for ids in levels:
        s0 = child_slot[ids, 0]
        s1 = child_slot[ids, 1]
        miss[s0] = link_of(s1, child_is_leaf[ids, 1])
        miss[s1] = miss[ids]

    # ---- emit slots ------------------------------------------------------
    internal_ids = np.concatenate(levels)
    rows = pre[internal_ids]
    nodes[rows, 0:3] = sub_min[internal_ids]
    nodes[rows, 3:6] = sub_max[internal_ids]
    hit_link = link_of(child_slot[internal_ids, 0], child_is_leaf[internal_ids, 0])
    nodes[rows, 12] = hit_link.astype(np.int32).view(np.float32)
    nodes[rows, 13] = miss[internal_ids].astype(np.int32).view(np.float32)

    _write_leaf_rows(nodes, pre[leaf_base:], v0, e1, e2, normal, leaf_prim, leaf_inst,
                     miss[leaf_base:])
    return nodes, np.int32(0), scene_min, scene_max, T


def _write_leaf_rows(nodes, rows, v0, e1, e2, normal, prim, inst, miss):
    nodes[rows, 0:3] = v0
    nodes[rows, 3:6] = e1
    nodes[rows, 6:9] = e2
    nodes[rows, 9:12] = normal
    nodes[rows, 12] = prim.astype(np.int32).view(np.float32)
    nodes[rows, 13] = miss.astype(np.int32).view(np.float32)
    nodes[rows, 14] = inst.astype(np.int32).view(np.float32)


def bvh_on_device(nodes, root_link, scene_min, scene_max, n_tris, device="cuda") -> BVH:
    """``BVH`` from its host arrays; the slot table is copied bit for bit."""
    dev = resolve_device(device)
    nodes_i = np.ascontiguousarray(np.asarray(nodes, np.float32)).view(np.int32)
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return BVH(
        # carried as int32 so no float path ever touches the link words
        nodes=torch.from_numpy(nodes_i.copy()).to(dev).view(torch.float32),
        root_link=torch.tensor(int(root_link), dtype=torch.int32, device=dev),
        aabb_min=f32(scene_min),
        aabb_max=f32(scene_max),
        n_tris=torch.tensor(int(n_tris), dtype=torch.int32, device=dev),
    )


def build_bvh(mesh: TriangleMesh, prim_ids: Optional[np.ndarray] = None,
              inst_ids: Optional[np.ndarray] = None, device="cuda") -> BVH:
    """Build the threaded flattened BVH for a triangle mesh on ``device``.

    prim_ids/inst_ids override the ids written into the leaf slots."""
    resolve_device(device)  # refuse a missing card before the host build
    return bvh_on_device(*build_bvh_arrays(mesh, prim_ids, inst_ids), device=device)


def build_bvh_sah(mesh: TriangleMesh, device="cuda") -> BVH:
    """Build the threaded BVH with the native binned-SAH builder on
    ``device``: the JAX package's ``build_bvh_sah`` slots, bit for bit.
    Raises RuntimeError where the native library is unavailable; see
    :func:`build_bvh_auto`."""
    resolve_device(device)  # refuse a missing card before the host build
    nodes, root, _leaf_order, aabb = native.build_bvh_sah_arrays(mesh.vertices, mesh.faces)
    return bvh_on_device(nodes, root, aabb[:3], aabb[3:], mesh.n_faces, device=device)


def build_bvh_auto(mesh: TriangleMesh, device="cuda") -> BVH:
    """The native SAH BVH where the library is available, the numpy LBVH
    otherwise."""
    if native.available():
        return build_bvh_sah(mesh, device=device)
    return build_bvh(mesh, device=device)


# ---------------------------------------------------------------------------
# Host-side validation / diagnostics
# ---------------------------------------------------------------------------


def validate_bvh(bvh: BVH) -> dict:
    """Walk the threaded links on the host; check structural invariants.

    Returns {max_depth, mean_leaf_depth, n_leaves}; raises on broken trees.
    """
    nodes = bvh.nodes.detach().cpu().numpy()
    n_tris = int(bvh.n_tris)
    root = int(bvh.root_link)
    sent = int(SENTINEL_LINK)
    word = lambda row, k: int(row[k:k + 1].view(np.int32)[0])
    # 1) preorder walk using hit/miss links (the device traversal with all
    # boxes "hit"): must visit every slot exactly once
    seen = np.zeros(nodes.shape[0], bool)
    link = root
    steps = 0
    prim_seen = []
    while link != sent:
        steps += 1
        if steps > nodes.shape[0] + 2:
            raise AssertionError("preorder walk longer than slot count")
        idx = ~link if link < 0 else link
        if seen[idx]:
            raise AssertionError(f"slot {idx} visited twice")
        seen[idx] = True
        row = nodes[idx]
        if link < 0:
            prim_seen.append(word(row, 12))
            link = word(row, 13)
        else:
            link = word(row, 12)  # hit link = preorder next
    if not seen.all():
        raise AssertionError(f"{(~seen).sum()} slots unreachable")
    if len(prim_seen) != n_tris:
        raise AssertionError("leaf count != triangle count")
    # 2) depth stats + box containment via an explicit host stack; the second
    # child of an internal node is the miss target of its first child
    stack = [(root, 0)]
    leaf_depths = []
    while stack:
        link, depth = stack.pop()
        if link == sent:
            continue
        idx = ~link if link < 0 else link
        row = nodes[idx]
        if link < 0:
            leaf_depths.append(depth)
            continue
        bmin, bmax = row[0:3], row[3:6]
        if not (bmin <= bmax + 1e-6).all():
            raise AssertionError(f"node {link} has inverted box")
        hit = word(row, 12)
        hidx = ~hit if hit < 0 else hit
        if hit >= 0:
            crow = nodes[hidx]
            if not ((crow[0:3] >= bmin - 1e-4).all() and (crow[3:6] <= bmax + 1e-4).all()):
                raise AssertionError(f"child box of {link} escapes parent")
        sib = word(nodes[hidx], 13)
        stack.append((hit, depth + 1))
        stack.append((sib, depth + 1))
    return {
        "max_depth": max(leaf_depths),
        "mean_leaf_depth": float(np.mean(leaf_depths)),
        "n_leaves": len(leaf_depths),
    }
