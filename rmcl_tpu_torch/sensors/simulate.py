"""Sensor simulation: pose x sensor model x triangle bins → simulated hits.

Counterpart of ``rmcl_tpu.sensors.simulate.simulate`` on the dense binned
engine. Results are returned in the **sensor frame**, like rmagine's
simulators. The exact BVH engine is not ported yet.
"""

from __future__ import annotations

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops.raycast import NO_HIT_T, RayHits
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from rmcl_tpu_torch.sensors.models import SensorModel


def simulate(bins: TriangleBins, model: SensorModel, tsm: Transform,
             **binned_kw) -> RayHits:
    """Simulate the sensor at pose(s) ``tsm`` (sensor→map).

    ``tsm`` may be batched: batch shape P gives hits of shape (P..., n_rays).
    Points and normals come back in the sensor frame. ``binned_kw`` goes to
    :func:`cast_rays_binned` (``c_super``, ``c_bin``, ``block_chunk``, ...)."""
    if not isinstance(bins, TriangleBins):
        raise NotImplementedError("only the binned engine (TriangleBins) is ported yet")
    o_s, d_s = model.rays(bins.device)  # (N, 3) sensor frame
    tsm_b = tsm.expand_dims(-1) if tsm.batch_shape else tsm
    o_m = tsm_b.apply(o_s)
    d_m = tsm_b.rotate(d_s)
    hits = cast_rays_binned(bins, o_m, d_m, t_min=model.range.min,
                            t_max=min(model.range.max, NO_HIT_T), **binned_kw)
    # fold back into the sensor frame
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
