"""Device-side coherence orderings for ray and query workloads.

Counterpart of ``rmcl_tpu.ops.order``: a Morton (+ heading) sort key that
clusters scattered points into spatially tight blocks — particles for the
dense ray engine, query points for :func:`rmcl_tpu_torch.ops.closest_point.closest_points_binned`.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _spread3(x: Tensor) -> Tensor:
    """Spread the low 8 bits of ``x`` so consecutive bits land 3 apart
    (part1by2 on int32, up to 8 bits an axis = 24-bit codes)."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys_3d(points: Tensor, lo: Tensor, hi: Tensor, bits: int = 8) -> Tensor:
    """int32 Morton codes of ``points`` (N, 3) within the box [lo, hi].

    ``bits`` <= 8 bits an axis (3*bits-bit codes). Degenerate box axes
    quantize to 0."""
    assert bits <= 8
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((points - lo) / extent * (1 << bits)).to(torch.int32), 0, (1 << bits) - 1)
    shift = 8 - bits  # align to the top of the 8-bit spread window
    return ((_spread3(q[:, 0] << shift) << 2) | (_spread3(q[:, 1] << shift) << 1)
            | _spread3(q[:, 2] << shift))


def cluster_order(positions: Tensor, headings: Tensor | None = None, pos_bits: int = 7,
                  heading_bits: int = 5) -> tuple[Tensor, Tensor]:
    """(order, inverse) sorting rays, particles or queries into coherent
    blocks.

    Primary key: the Morton code of ``positions``. Secondary key: the
    quantized heading angle of ``headings`` (N, >= 2) in the XY plane.
    Returns int32 (order, inv): apply ``x[order]``; undo with ``y[inv]``.
    The sort is stable, as the JAX package's."""
    n = positions.shape[0]
    lo = torch.amin(positions, dim=0)
    hi = torch.amax(positions, dim=0)
    key = morton_keys_3d(positions, lo, hi, bits=pos_bits)
    if headings is not None and heading_bits > 0:
        hb = 1 << heading_bits
        ang = torch.atan2(headings[:, 1], headings[:, 0])  # [-pi, pi]
        bucket = torch.clamp(((ang + math.pi) * (hb / (2.0 * math.pi))).to(torch.int32), 0, hb - 1)
        key = (key << heading_bits) | bucket
    order = torch.argsort(key, stable=True).to(torch.int32)
    inv = torch.empty(n, dtype=torch.int32, device=positions.device)
    inv[order.long()] = torch.arange(n, dtype=torch.int32, device=positions.device)
    return order, inv
