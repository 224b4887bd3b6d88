"""Sensor simulation: pose x sensor model x map → simulated hits.

Counterpart of ``rmcl_tpu.sensors.simulate``. The acceleration structure
picks the engine: a ``BVH`` takes the exact traversal
(:func:`rmcl_tpu_torch.ops.raycast.cast_rays`), ``TriangleBins`` the dense
binned engine. Results are returned in the **sensor frame**, like
rmagine's simulators.
"""

from __future__ import annotations

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits, cast_rays
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from rmcl_tpu_torch.sensors.models import SensorModel
from rmcl_tpu_torch.utils import timing


def simulate(bvh: "BVH | TriangleBins", model: SensorModel, tsm: Transform,
             chunk_size: int = 262144, **binned_kw) -> RayHits:
    """Simulate the sensor at pose(s) ``tsm`` (sensor→map).

    ``model`` is any :data:`SensorModel`: each one, a
    :class:`~rmcl_tpu_torch.sensors.models.RaySliceModel` window (a rank's
    pixels in the sharded correction) included, yields its rays through
    ``model.rays(device)``.
    ``tsm`` may be batched: batch shape P gives hits of shape (P..., n_rays).
    Points and normals come back in the sensor frame. ``binned_kw`` goes to
    :func:`cast_rays_binned` (``c_super``, ``c_bin``, ``block_chunk``, ...)
    when ``bvh`` is bins; ``chunk_size`` to :func:`cast_rays` when it is a
    BVH."""
    if not isinstance(bvh, (BVH, TriangleBins)):
        raise TypeError(f"simulate needs a BVH or TriangleBins, got {type(bvh).__name__}")
    dev = bvh.device
    with timing.span("rmcl.cast.rays"):
        o_s, d_s = model.rays(dev)  # (N, 3) sensor frame
        tsm_b = tsm.expand_dims(-1) if tsm.batch_shape else tsm
        o_m = tsm_b.apply(o_s)
        d_m = tsm_b.rotate(d_s)
    t_max = min(model.range.max, NO_HIT_T)
    if isinstance(bvh, TriangleBins):
        hits = cast_rays_binned(bvh, o_m, d_m, t_min=model.range.min, t_max=t_max, **binned_kw)
    else:
        hits = cast_rays(bvh, o_m, d_m, t_min=model.range.min, t_max=t_max,
                         chunk_size=chunk_size)
    # fold back into the sensor frame
    with timing.span("rmcl.cast.payload"):
        inv = tsm_b.inverse()
        hit3 = hits.hit[..., None]
        return RayHits(
            t=hits.t,
            hit=hits.hit,
            prim_id=hits.prim_id,
            inst_id=hits.inst_id,
            point=inv.apply(hits.point).where(hit3, 0.0),
            normal=inv.rotate(hits.normal).where(hit3, 0.0),
        )


def simulate_ranges(bvh: BVH, model: SensorModel, tsm: Transform, miss_value: float = 0.0,
                    chunk_size: int = 262144):
    """Range image only; misses mapped to ``miss_value`` (differentiable)."""
    hits = simulate(bvh, model, tsm, chunk_size=chunk_size)
    return hits.t.where(hits.hit, miss_value)
