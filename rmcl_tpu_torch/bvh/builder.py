"""Host-side helpers of the BVH builder.

Counterpart of ``rmcl_tpu.bvh.builder``: only the Morton codes, which the
pose sweep's order (:class:`rmcl_tpu_torch.ops.raycast_binned.TiledSweep`)
needs. The LBVH build itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
