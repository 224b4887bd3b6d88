"""Tracked MICP-L corrections with cross-correction candidate reuse.

Counterpart of ``rmcl_tpu.micp.tracking``. Consecutive pose estimates of a
tracking loop differ by millimeters and fractions of a degree, so the
conservative cull runs only when a sensor's pose has drifted past the
candidate margins since its last cull (``origin_margin`` meters,
``dir_margin`` radians); every other correction reuses the candidate lists
and pays only the intersection (K4) and the solve. Reused casts equal
fresh-cull casts bitwise (``tests/test_torch_factored.py``), PROVIDED the
candidate budget does not saturate: a saturated ``c_bin`` truncates
nearest-first, and margin inflation can then push real candidates out.

The JAX package decides a re-cull on the device (``lax.cond``). The port
decides it on the host: one small readback per sensor per step (the drift
predicate), then either the cull runs or the lists are reused.

Several sensors: each keeps its own candidate lists and cull-reference
pose; the statistics merge is the generic pipeline's
(:func:`rmcl_tpu_torch.micp.pipeline.correct_from_correspondences`).
Shared-origin models (spherical, pinhole, O1Dn) use pose x direction
factored blocks; OnDn (per-ray origins) uses the engine's ``paired``
layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from rmcl_tpu_torch.bvh.bins import TriangleBins
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.micp.correspondences import Correspondences
from rmcl_tpu_torch.micp.pipeline import (
    MICPConfig,
    MICPSensorData,
    MICPStats,
    correct_from_correspondences,
)
from rmcl_tpu_torch.ops.raycast import NO_HIT_T
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned_factored, factored_candidates
from rmcl_tpu_torch.sensors.models import OnDnModel, SensorModel

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrackedState:
    """Carried tracking state: pose + per-sensor reusable candidate lists
    and the sensor pose each was culled at."""

    tom: Transform  # odom -> map correction (the tracked output)
    candidates: Tuple  # per sensor: (cand, count, tnear)
    ref_trans: Tuple  # per sensor: (3,) sensor origin at the last cull
    ref_rot: Tuple  # per sensor: (4,) sensor quaternion at the last cull
    progress: Tensor  # convergence progress (annealing input)
    n_reculls: int  # diagnostics: culls actually executed


class _SensorLayout:
    """Per-sensor static block layout for the factored engine."""

    def __init__(self, model: SensorModel, group: int, device):
        self.paired = isinstance(model, OnDnModel)
        o_s, d_s = model.rays(device)
        n = int(d_s.shape[0])
        pad = (-n) % group
        if pad:
            d_s = torch.cat([d_s, d_s[-1:].expand(pad, 3)], 0)
        self.n_rays = n
        self.d_pad = d_s  # (n + pad, 3) sensor frame
        if self.paired:
            if pad:
                o_s = torch.cat([o_s, o_s[-1:].expand(pad, 3)], 0)
            self.o_pad = o_s  # (n + pad, 3) per-ray origins
        else:
            self.o_pad = o_s[0]  # shared origin (zeros for spherical / pinhole)
        self.group = group
        self.n_blk = d_s.shape[0] // group
        self.t_min = float(model.range.min)
        self.t_max = float(min(float(model.range.max), NO_HIT_T))

    def blocks(self, tsm: Transform) -> Tuple[Tensor, Tensor]:
        d_blk = tsm.rotate(self.d_pad).reshape(self.n_blk, self.group, 3)
        if self.paired:
            return tsm.apply(self.o_pad).reshape(self.n_blk, self.group, 3), d_blk
        return tsm.apply(self.o_pad).expand(self.n_blk, 1, 3).contiguous(), d_blk


class TrackedCorrector:
    """MICP-L tracking loop on the dense factored engine.

    Usage (single- or multi-sensor — scalars and sequences both accepted)::

        tc = TrackedCorrector(bins, [s.model for s in sensors], micp_config)
        state = tc.init(bins, tom0, tbo, [s.tsb for s in sensors])
        state, stats = tc.step(bins, sensors, state, tbo)

    ``step`` re-culls a sensor when its pose drifted past the margins since
    its last cull (decided on the host, one readback per sensor).
    ``block_chunk``: single-scan casts have ~100-200 blocks; the chunk only
    sets the padding of the candidate lists. ``payload``: "plane" (default)
    or "index"."""

    def __init__(self, bins: TriangleBins, models: "SensorModel | Sequence[SensorModel]",
                 config: MICPConfig = MICPConfig(), origin_margin: float = 0.05,
                 dir_margin: float = 0.01, group: int = 128, block_chunk: int = 512,
                 sub_blocks: int = 4, payload: str = "plane"):
        self.config = config
        self.origin_margin = float(origin_margin)
        self.dir_margin = float(dir_margin)
        self.payload = payload
        self._layouts = [_SensorLayout(m, group, bins.device) for m in self._as_seq(models)]
        self._cull_kw = dict(c_super=config.c_super, c_bin=config.c_bin,
                             block_chunk=block_chunk, sub_blocks=sub_blocks)

    @staticmethod
    def _as_seq(x):
        return list(x) if isinstance(x, (list, tuple)) else [x]

    def _cull(self, bins, lay: _SensorLayout, tsm: Transform):
        o_blk, d_blk = lay.blocks(tsm)
        return factored_candidates(bins, o_blk, d_blk, origin_margin=self.origin_margin,
                                   dir_margin=self.dir_margin, t_min=lay.t_min,
                                   t_max=lay.t_max, **self._cull_kw)

    def init(self, bins: TriangleBins, tom: Transform, tbo: Transform,
             tsb: "Transform | Sequence[Transform]") -> TrackedState:
        cands, rts, rqs = [], [], []
        for lay, tsb_i in zip(self._layouts, self._as_seq(tsb)):
            tsm = (tom @ tbo) @ tsb_i
            cands.append(self._cull(bins, lay, tsm))
            rts.append(tsm.trans)
            rqs.append(tsm.rot)
        return TrackedState(tom=tom, candidates=tuple(cands), ref_trans=tuple(rts),
                            ref_rot=tuple(rqs),
                            progress=torch.zeros((), device=tom.trans.device),
                            n_reculls=len(self._layouts))

    def step(self, bins: TriangleBins,
             sensors: "MICPSensorData | Sequence[MICPSensorData]", state: TrackedState,
             tbo: Transform) -> Tuple[TrackedState, MICPStats]:
        sensors = self._as_seq(sensors)
        tom = state.tom
        corrs, cands, rts, rqs = [], [], [], []
        reculls = state.n_reculls
        for i, (lay, sensor) in enumerate(zip(self._layouts, sensors)):
            tsm = (tom @ tbo) @ sensor.tsb
            # drift since this sensor's last cull, in the margins' terms: the
            # sensor origin's L-inf translation and the rotation angle (every
            # direction tilts by at most the quaternion angle)
            dtr = torch.amax(torch.abs(tsm.trans - state.ref_trans[i]))
            cos_half = torch.abs(torch.sum(tsm.rot * state.ref_rot[i]))
            need = (dtr >= self.origin_margin) | (cos_half <= math.cos(self.dir_margin / 2.0))
            if bool(need):  # the host-side decision: one readback
                cand, ref_t, ref_q = self._cull(bins, lay, tsm), tsm.trans, tsm.rot
                reculls += 1
            else:
                cand, ref_t, ref_q = state.candidates[i], state.ref_trans[i], state.ref_rot[i]

            o_blk, d_blk = lay.blocks(tsm)
            hits = cast_rays_binned_factored(
                bins, o_blk, d_blk, candidates=cand, payload=self.payload, sort_blocks=True,
                paired=lay.paired, t_min=lay.t_min, t_max=lay.t_max, **self._cull_kw)
            # hits back into the sensor frame (simulate() semantics), block
            # padding rays dropped
            n = lay.n_rays
            hit = hits.hit.reshape(-1)[:n]
            inv = tsm.inverse()
            corrs.append(Correspondences(
                model_points=torch.where(hit[:, None], inv.apply(hits.point.reshape(-1, 3)[:n]),
                                         0.0),
                model_normals=torch.where(hit[:, None],
                                          inv.rotate(hits.normal.reshape(-1, 3)[:n]), 0.0),
                found=hit,
            ))
            cands.append(cand)
            rts.append(ref_t)
            rqs.append(ref_q)

        tom_new, stats = correct_from_correspondences(sensors, corrs, tom, tbo, state.progress,
                                                      self.config)
        return TrackedState(tom=tom_new, candidates=tuple(cands), ref_trans=tuple(rts),
                            ref_rot=tuple(rqs), progress=stats.convergence_progress,
                            n_reculls=reculls), stats
