"""Many pose hypotheses corrected together against one map, for one sensor:
the batch corrector of the reference's corrector benchmark
(``lidar_corrector_{optix,embree}_benchmark.cpp``), and of relocalisation
over many candidate poses.

N sensor positions share one orientation, the map's axes, so every pose
casts the same scan directions. A correction casts every direction from
every position through the factored engine (blocks of ``poses_per_tile``
positions x ``az_tile * el_tile`` directions of a
:class:`~rmcl_tpu_torch.ops.raycast_binned.TiledSweep`: K3's factored cull,
then K4's pair loop), pairs each measured point with the hit of its own ray
(point-to-plane, gated at ``max_dist``), reduces the pairs of each pose into
:class:`~rmcl_tpu_torch.math.gaussian.CrossStatistics` and solves Umeyama a
pose. The increment is applied to the position (the JAX bench's
``iterate``); the orientation stays shared. Everything after K4 is
:func:`~rmcl_tpu_torch.ops.epilogue_cuda.batch_epilogue`, from K4's raw
winners to the increments: on CUDA tensors one hand kernel (no host sync),
on CPU tensors its plain version,
:func:`~rmcl_tpu_torch.ops.epilogue_cuda.batch_epilogue_reference`.

The cull runs with its origin box inflated by ``origin_margin`` and is kept
until some position has moved by the margin along an axis since it ran
(:func:`~rmcl_tpu_torch.micp.tracking.needs_recull`, decided on the host
as :class:`~rmcl_tpu_torch.micp.tracking.TrackedCorrector` decides it: one
readback a correction). A cast through kept lists equals a fresh cast
unless a budget truncated a block, so each step reports the blocks its cull
truncated.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.micp.tracking import needs_recull
from rmcl_tpu_torch.ops.epilogue_cuda import batch_epilogue, winner_planes
from rmcl_tpu_torch.ops.raycast import NO_HIT_T
from rmcl_tpu_torch.ops.raycast_binned import (TiledSweep, cast_rays_binned_factored,
                                               factored_candidates)
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.utils import timing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchStep:
    """One correction of every pose: the corrected positions ``trans`` (N,
    3), the increments ``delta`` (map frame) and the pairs ``n_meas`` (N,)
    each pose's solve used; the culls the correction ran (0 or 1) and the
    blocks a budget truncated in them (a () int64 tensor, on the device)."""

    trans: Tensor
    delta: Transform
    n_meas: Tensor
    culls: int
    truncated: Tensor


class BatchCorrector:
    """N positions, one map (``bins``), one spherical sensor.

    Usage::

        bc = BatchCorrector(bins, SphericalModel.vlp16(), trans0)
        for _ in range(16):
            step = bc.step(data_points, data_mask, trans)
            trans = step.trans

    ``origins`` (N, 3) fix the sweep's pose order (Morton order of the
    positions, in tiles of ``poses_per_tile``); later positions may move.
    ``data_points`` (N, D, 3) are each pose's measured points in its sensor
    frame and ``data_mask`` (N, D) their validity, D = ``model.n_rays`` in
    the model's ray order. The budgets (``c_super``, ``c_bin``, ``c_hyper``,
    ``c_mid``, ``sub_blocks``) and ``block_chunk`` are the cull's and the
    cast's; ``payload`` ("plane" or "index") is that of :meth:`cast`
    (:meth:`correct` reads K4's winners)."""

    def __init__(self, bins: TriangleBins, model: SphericalModel, origins,
                 max_dist: float = 2.0, origin_margin: float = 0.03, poses_per_tile: int = 16,
                 az_tile: int = 8, el_tile: int = 1, c_super: int = 24, c_bin: int = 64,
                 c_hyper: int = 20, c_mid: int = 0, sub_blocks: int = 128,
                 block_chunk: int = 512, payload: str = "plane"):
        self.bins = bins
        self.sweep = TiledSweep(origins, model.width, model.height, poses_per_tile=poses_per_tile,
                                az_tile=az_tile, el_tile=el_tile)
        self.dirs = model.rays(bins.device)[1]  # (D, 3), sensor frame = map axes
        self.max_dist = float(max_dist)
        self.origin_margin = float(origin_margin)
        self.payload = payload
        self.cull_kw = dict(t_min=float(model.range.min),
                            t_max=float(min(float(model.range.max), NO_HIT_T)), c_super=c_super,
                            c_bin=c_bin, c_hyper=c_hyper, c_mid=c_mid, sub_blocks=sub_blocks,
                            block_chunk=block_chunk)
        self._lists = None  # the kept cull's (cand, count, tnear)
        self._ref = None  # the positions it ran at
        self._epilogue = None  # the epilogue's map and sweep tables

    def candidates(self, trans: Tensor) -> Tuple[Tuple[Tensor, Tensor, Tensor], Tensor]:
        """One cull at positions ``trans``, inflated by the margin: the
        lists for :meth:`cast` and the blocks' ``sat`` flags (a budget
        truncated the block's list)."""
        o_blk, d_blk = self.sweep.factored_rays(trans, self.dirs)
        *lists, sat = factored_candidates(self.bins, o_blk, d_blk,
                                          origin_margin=self.origin_margin, with_sat=True,
                                          **self.cull_kw)
        return tuple(lists), sat

    def cast(self, trans: Tensor, candidates=None) -> Tuple[Tensor, Tensor, Tensor]:
        """Closest hit of every direction from every position: (points (N,
        D, 3) from t along the direction, normals (N, D, 3), hit (N, D)) in
        pose order. ``candidates`` from :meth:`candidates` skip the cull."""
        o_blk, d_blk = self.sweep.factored_rays(trans, self.dirs)
        hits = cast_rays_binned_factored(self.bins, o_blk, d_blk, candidates=candidates,
                                         sort_blocks=True, payload=self.payload, **self.cull_kw)
        n = self.sweep.n_rays
        packed = torch.cat([hits.normal.reshape(n, 3), hits.t.reshape(n, 1),
                            hits.hit.reshape(n, 1).to(torch.float32)], dim=1)
        up = self.sweep.unpermute(packed)  # (N, D, 5)
        points = trans[:, None, :] + up[..., 3:4] * self.dirs[None]
        return points, up[..., 0:3], up[..., 4] > 0.5

    def correct(self, data_points: Tensor, data_mask: Tensor, trans: Tensor,
                candidates=None) -> Tuple[Transform, Tensor]:
        """One correction's increments (map frame) and pairs (N,) at
        positions ``trans``. Casts through ``candidates`` where given, else
        culls afresh without the margin; the cast keeps K4's raw winners and
        :func:`~rmcl_tpu_torch.ops.epilogue_cuda.batch_epilogue` turns them
        into the increments and pairs (on the card one launch, and nothing
        between K4 and the increments syncs)."""
        with timing.span("rmcl.batch.correspond"):
            o_blk, d_blk = self.sweep.factored_rays(trans, self.dirs)
            won = cast_rays_binned_factored(self.bins, o_blk, d_blk, candidates=candidates,
                                            sort_blocks=True, payload="winner", **self.cull_kw)
        with timing.span("rmcl.batch.epilogue"):
            planes, slots = self._epilogue_tables()
            return batch_epilogue(won.t, won.ref, planes, trans, self.dirs, data_points,
                                  data_mask, slots, self.max_dist, self.cull_kw["t_max"])

    def _epilogue_tables(self) -> Tuple[Tensor, Tensor]:
        """The epilogue's plane table of the map (:func:`winner_planes`)
        and slot map, int32 (N, D): the sweep-flat slot of each (pose,
        direction), what :meth:`TiledSweep.unpermute` makes of the slot
        numbers. On the map's device; built once a map."""
        if self._epilogue is None or self._epilogue[0] is not self.bins:
            slots = torch.arange(self.sweep.n_rays, device=self.bins.tri.device)[:, None]
            self._epilogue = (self.bins, winner_planes(self.bins.tri),
                              self.sweep.unpermute(slots)[..., 0].to(torch.int32).contiguous())
        return self._epilogue[1:]

    def step(self, data_points: Tensor, data_mask: Tensor, trans: Tensor) -> BatchStep:
        """One correction of every pose from positions ``trans``, through
        the kept cull, or a new one where a position moved past the margin
        since it ran (one readback)."""
        with timing.span("rmcl.batch.step"):
            with timing.span("rmcl.batch.recull_check"):
                need = self._lists is None or bool(
                    needs_recull(trans, self._ref, self.origin_margin))
            truncated = torch.zeros((), dtype=torch.int64, device=trans.device)
            if need:
                self._lists, sat = self.candidates(trans)
                self._ref = trans.clone()
                truncated = torch.sum(sat, dtype=torch.int64)
                timing.count("rmcl.batch.culls", 1)
                timing.count_device("rmcl.batch.truncated_blocks", sat)
            delta, n_meas = self.correct(data_points, data_mask, trans, self._lists)
            return BatchStep(delta.apply(trans), delta, n_meas, int(need), truncated)
