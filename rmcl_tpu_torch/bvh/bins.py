"""Two-level triangle binning for the dense binned ray caster.

Counterpart of ``rmcl_tpu.bvh.bins``. The bins are built on the host in
numpy — the same arrays, bit for bit, as the JAX package's numpy path — and
then copied to ``device``:

  hyper / super / mid  grouped AABBs            (n_*, 6) [min(3), max(3)]
  bins                 B kd-contiguous tris     (n_bins, 6) AABBs
  payload              packed triangle data     (n_bins, 14, B) component-
                       major: [v0(3), e1(3), e2(3), unit normal(3),
                       prim_id.f32, inst_id.f32]

Only the numpy kd median order is ported. The JAX package prefers its
native C++ order when that library is built; the two split ties
differently, so the bins agree bitwise only with JAX's numpy path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.geom.mesh import TriangleMesh

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TriangleBins:
    tri: Tensor  # (n_bins, 14, B) packed component-major triangle data
    bin_aabb: Tensor  # (n_bins, 6) [min(3), max(3)]
    super_aabb: Tensor  # (n_super, 6)
    bins_per_super: int
    aabb_min: Tensor  # (3,) scene bounds
    aabb_max: Tensor
    mid_aabb: Optional[Tensor] = None  # (n_mid, 6): groups of bins_per_mid bins
    bins_per_mid: int = 8
    hyper_aabb: Optional[Tensor] = None  # (n_hyper, 6): groups of supers
    supers_per_hyper: int = 8

    @property
    def n_bins(self) -> int:
        return self.tri.shape[0]

    @property
    def bin_size(self) -> int:
        return self.tri.shape[2]

    @property
    def n_super(self) -> int:
        return self.super_aabb.shape[0]

    @property
    def n_mid(self) -> int:
        return 0 if self.mid_aabb is None else self.mid_aabb.shape[0]

    @property
    def n_hyper(self) -> int:
        return 0 if self.hyper_aabb is None else self.hyper_aabb.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def nbytes(self) -> int:
        return int(self.tri.numel() + self.bin_aabb.numel() + self.super_aabb.numel()) * 4


def _median_split_order(centroid: np.ndarray, B: int) -> np.ndarray:
    """kd-style recursive median partition into compact leaves of B tris.

    Splits the widest centroid axis at each node, rounding the left child
    to a multiple of B so every leaf (except possibly the last) is exactly
    full. Leaves come out in DFS order, so groups of S consecutive leaves
    (the supers) are subtree-compact."""
    T = centroid.shape[0]
    order = np.arange(T)
    out = np.empty(T, np.int64)
    pos = 0
    stack = [(0, T)]
    while stack:
        lo, hi = stack.pop()
        n = hi - lo
        if n <= B:
            out[pos : pos + n] = order[lo:hi]
            pos += n
            continue
        seg = order[lo:hi]
        c = centroid[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # left gets the largest multiple of B that is <= n/2 (at least B)
        n_left = max(B, ((n // 2) // B) * B)
        part = np.argpartition(c[:, axis], n_left - 1)
        order[lo:hi] = seg[part]
        # DFS: push right first so left is emitted first
        stack.append((lo + n_left, hi))
        stack.append((lo, lo + n_left))
    return out


def _group_aabb(lo: np.ndarray, hi: np.ndarray, G: int):
    """Min/max over consecutive groups of G boxes; padding boxes collapse
    onto the last box's min corner."""
    n = lo.shape[0]
    n_g = (n + G - 1) // G
    pad = n_g * G - n
    if pad:
        corner = np.repeat(lo[-1:], pad, 0)
        lo = np.concatenate([lo, corner], 0)
        hi = np.concatenate([hi, corner], 0)
    return lo.reshape(n_g, G, 3).min(axis=1), hi.reshape(n_g, G, 3).max(axis=1), lo, hi


def build_bins(
    mesh: TriangleMesh,
    bin_size: int = 64,
    bins_per_super: int = 64,
    prim_ids: np.ndarray | None = None,
    inst_ids: np.ndarray | None = None,
    method: str = "median",
    bins_per_mid: int = 8,
    supers_per_hyper: int = 8,
    device="cuda",
) -> TriangleBins:
    """Build compact triangle bins on the host, then copy them to ``device``.

    Only ``method="median"`` (the numpy kd median split) is ported."""
    if method != "median":
        raise NotImplementedError(f"bin order '{method}' is not ported yet")
    dev = resolve_device(device)
    tri = np.asarray(mesh.triangles(), dtype=np.float32)
    T = tri.shape[0]
    if prim_ids is None:
        prim_ids = np.arange(T, dtype=np.int32)
    if inst_ids is None:
        inst_ids = np.zeros(T, dtype=np.int32)

    prim_min = tri.min(axis=1)
    prim_max = tri.max(axis=1)
    centroid = 0.5 * (prim_min + prim_max)
    scene_min = prim_min.min(axis=0)
    scene_max = prim_max.max(axis=0)

    order = _median_split_order(centroid, bin_size)
    tri = tri[order]
    prim_min = prim_min[order]
    prim_max = prim_max[order]
    prim_ids = prim_ids[order]
    inst_ids = inst_ids[order]

    B = bin_size
    n_bins = (T + B - 1) // B
    pad = n_bins * B - T
    if pad:
        # degenerate padding triangles: zero edges -> det == 0, never hit;
        # their AABB collapses onto the last real triangle's corner
        tri = np.concatenate([tri, np.repeat(tri[-1:, :1], pad, 0).repeat(3, 1)], 0)
        prim_min = np.concatenate([prim_min, np.repeat(prim_min[-1:], pad, 0)], 0)
        prim_max = np.concatenate([prim_max, np.repeat(prim_min[-1:], pad, 0)], 0)
        prim_ids = np.concatenate([prim_ids, np.full(pad, -1, np.int32)])
        inst_ids = np.concatenate([inst_ids, np.zeros(pad, np.int32)])

    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    normal = np.cross(e1, e2)
    norm_len = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / np.maximum(norm_len, 1e-20)
    packed = np.empty((n_bins, 14, B), np.float32)
    for i, comp in enumerate((v0, e1, e2, normal)):
        for k in range(3):
            packed[:, 3 * i + k, :] = comp[:, k].reshape(n_bins, B)
    packed[:, 12, :] = prim_ids.reshape(n_bins, B)
    packed[:, 13, :] = inst_ids.reshape(n_bins, B)

    bin_min = prim_min.reshape(n_bins, B, 3).min(axis=1)
    bin_max = prim_max.reshape(n_bins, B, 3).max(axis=1)
    bin_aabb = np.concatenate([bin_min, bin_max], axis=1)

    S = bins_per_super
    super_min, super_max, bm, bM = _group_aabb(bin_min, bin_max, S)
    n_super = super_min.shape[0]
    super_aabb = np.concatenate([super_min, super_max], axis=1)

    # middle level: groups of M bins on the padded grid aligned to the
    # supers, so super s owns mids [s*S/M, (s+1)*S/M)
    M = max(1, min(bins_per_mid, S))
    while S % M:  # clamp to a divisor of S
        M -= 1
    mid_aabb = None
    if M > 1:
        n_mid = n_super * (S // M)
        mid_aabb = np.concatenate([bm.reshape(n_mid, M, 3).min(axis=1),
                                   bM.reshape(n_mid, M, 3).max(axis=1)], axis=1)

    # hyper level: groups of H consecutive supers
    H = max(1, supers_per_hyper)
    hyper_aabb = None
    if H > 1 and n_super > H:
        hyper_min, hyper_max, _, _ = _group_aabb(super_min, super_max, H)
        hyper_aabb = np.concatenate([hyper_min, hyper_max], axis=1)

    put = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return TriangleBins(
        tri=put(packed),
        bin_aabb=put(bin_aabb),
        super_aabb=put(super_aabb),
        bins_per_super=S,
        aabb_min=put(scene_min),
        aabb_max=put(scene_max),
        mid_aabb=put(mid_aabb),
        bins_per_mid=M,
        hyper_aabb=put(hyper_aabb),
        supers_per_hyper=H,
    )
