"""Flattened BVH device representation.

Counterpart of ``rmcl_tpu.bvh.types``, with the same layout at the public
surface: one ``(N, 16)`` float32 slot table, **preorder-threaded**, so that
traversal needs no per-ray stack (the state is the current link, the best
distance and the best slot). Every slot is 64 bytes:

  internal node:
    [0:3]  AABB min             [3:6]  AABB max
    [12]   hit link  (int32 bit pattern) — preorder next = first child
    [13]   miss link (int32 bit pattern) — skip link = next subtree
    rest unused

  leaf (one triangle inline):
    [0:3]  v0                   [3:6]  e1 = v1 - v0
    [6:9]  e2 = v2 - v0         [9:12] unit geometric normal
    [12]   primitive id (int32 bit pattern, original mesh face index)
    [13]   miss link    (int32 bit pattern)
    [14]   instance id  (int32 bit pattern; 0 for single meshes)
    [15]   unused

Link encoding: ``link >= 0`` is an internal slot index, ``link < 0`` the
leaf slot ``~link``, ``SENTINEL_LINK`` ends the traversal.

Words 12-14 hold int32 bit patterns inside a float32 table: leaf links are
NaN patterns and small links denormal patterns. Read them through
``nodes.view(torch.int32)``, never through float arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

SENTINEL_LINK = np.int32(-2147483648)

# word indices within a slot
W_BMIN = 0
W_BMAX = 3
W_V0 = 0
W_E1 = 3
W_E2 = 6
W_NORMAL = 9
W_HIT = 12
W_PRIM = 12
W_MISS = 13
W_INST = 14


@dataclasses.dataclass(frozen=True)
class BVH:
    """BVH over one triangle mesh.

    nodes:     (N, 16) float32 threaded slots (see module docstring)
    root_link: () int32 link to the root (may itself be a leaf link)
    aabb_min/aabb_max: (3,) float32 scene bounds
    n_tris:    () int32 number of triangles
    """

    nodes: Tensor
    root_link: Tensor
    aabb_min: Tensor
    aabb_max: Tensor
    n_tris: Tensor

    @property
    def n_slots(self) -> int:
        return self.nodes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def nbytes(self) -> int:
        return int(self.nodes.numel()) * 4


def decode_link(link: Tensor) -> Tuple[Tensor, Tensor]:
    """(is_leaf, slot_index) from an int32 link tensor."""
    is_leaf = link < 0
    return is_leaf, torch.where(is_leaf, ~link, link)
