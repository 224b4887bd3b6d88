"""Per-ray time motion compensation (scan de-skew).

Counterpart of ``rmcl_tpu.sensors.deskew``. A spinning LiDAR captures its
rays over the scan period; when the base moves meanwhile, the raw
sensor-frame points are expressed in different sensor poses. The base
pose in the odom frame is sampled at two times (``tbo_a`` at ``stamp_a``,
``tbo_b`` at ``stamp_b``, consecutive odometry messages); each point
captured at absolute time ``t_i`` rides ``Tbo(t_i)``, the slerp/lerp
between the samples, and the de-skewed cloud re-expresses every point in
the sensor frame at the reference stamp:

    p'_i = (Tbo(ref) * Tsb)^-1 * Tbo(t_i) * Tsb * p_i

Alphas outside [0, 1] extrapolate along the same velocity.
"""

from __future__ import annotations

import torch

from rmcl_tpu_torch.math.se3 import Transform

Tensor = torch.Tensor


def deskew_points(
    points_s: Tensor,  # (N, 3) sensor-frame points (captured at stamps)
    rel_stamps: Tensor,  # (N,) per-point time offsets from ``stamp_ref``
    stamp_ref,  # scalar: message/header stamp (absolute)
    tsb: Transform,  # sensor -> base (static over the scan)
    tbo_a: Transform,  # base -> odom @ stamp_a
    stamp_a,
    tbo_b: Transform,  # base -> odom @ stamp_b
    stamp_b,
) -> Tensor:
    """De-skewed points, sensor frame at ``stamp_ref``, on the points'
    device; the stamps are float32, as in the JAX package. Differentiable.

    Degenerate odom pairs (|stamp_b - stamp_a| below 1 ms: duplicate or
    re-published samples) carry no velocity: the alphas collapse to 1, so
    the compensation is the identity instead of extrapolating noise."""
    dev = points_s.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    stamp_ref, stamp_a, stamp_b = f32(stamp_ref), f32(stamp_a), f32(stamp_b)
    dt_raw = stamp_b - stamp_a
    degenerate = torch.abs(dt_raw) < 1e-3
    dt = torch.where(degenerate, 1.0, dt_raw)
    t_abs = stamp_ref + f32(rel_stamps)  # (N,)
    alpha_i = torch.where(degenerate, 1.0, (t_abs - stamp_a) / dt)
    alpha_r = torch.where(degenerate, 1.0, (stamp_ref - stamp_a) / dt)

    tbo_i = Transform.interp(tbo_a, tbo_b, alpha_i)  # (N,) batch
    tbo_r = Transform.interp(tbo_a, tbo_b, alpha_r)

    p_odom = tbo_i.apply(tsb.apply(points_s))
    sens_ref_inv = (tbo_r @ tsb).inverse()
    return sens_ref_inv.apply(p_odom)
