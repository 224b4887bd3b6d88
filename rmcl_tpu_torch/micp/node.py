"""MICP-L localization runtime: the MICPLocalizationNode equivalent.

Counterpart of ``rmcl_tpu.micp.node``: host-side orchestration around the
correction pipeline (reference rmcl_ros/src/nodes/micp_localization.cpp:
108-311): config-driven sensor slots, the odometry chain, the correction
loop, pose re-initialization and the pose and statistics outputs. The
caller (a replay loop, a simulator, a middleware bridge) drives
:meth:`MICPLocalization.step` at its own rate and reads ``tom`` whenever the
map -> odom transform is needed.

What differs from the JAX package: PyTorch runs eagerly, so there is no
compiled correction program and no compile cache; on a CUDA map the node
builds the kernels' libraries at construction instead, the port's only
first-use cost (as ``MCLNode.warm`` does). The node runs on its map's
device; a sensor's points and mask stay on the host (numpy) until a
correction uploads them, as the JAX node keeps them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from rmcl_tpu_torch.config.tree import ParamTree
from rmcl_tpu_torch.convert import to_numpy as _host
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.io import msgs
from rmcl_tpu_torch.io.conversions import (depth_info_to_model, o1dn_info_to_model,
                                           ondn_info_to_model, scan_info_to_model,
                                           scan_to_points)
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.micp.pipeline import (MICPConfig, MICPSensorConfig, MICPSensorData,
                                          MICPStats, correct_once)
from rmcl_tpu_torch.sensors.models import SensorModel
from rmcl_tpu_torch.utils import timing

# the kernels' libraries the MICP path can launch: the dense cast (K3, K1),
# the exact cast (K5), closest points on the BVH (K6) and over bins (K7, K6b)
_KERNELS = ("cull_blocks", "intersect_bins", "traverse_bvh", "closest_bvh", "cull_boxes",
            "closest_bins")


def _ingest(handler):
    """Run a message handler inside the ``rmcl.micp.ingest`` span."""

    @functools.wraps(handler)
    def traced(self, *args, **kwargs):
        with timing.span("rmcl.micp.ingest"):
            return handler(self, *args, **kwargs)

    return traced


@dataclasses.dataclass
class MICPSensorState:
    """Mutable per-sensor slot (the MICPSensorBase equivalent, reference
    rmcl_ros/include/rmcl_ros/micpl/MICPSensor.hpp:65-113). ``tsb`` None is
    the identity on the node's device (the node fills it in)."""

    name: str
    model: Optional[SensorModel] = None
    points: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    tsb: Optional[Transform] = None
    config: MICPSensorConfig = dataclasses.field(default_factory=MICPSensorConfig.create)
    stamp: float = 0.0
    outdated: bool = True  # the reference Correspondences' `outdated` flag
    # the device-side snapshot, rebuilt only when new data arrives
    device_data: Optional[MICPSensorData] = None

    def has_data(self) -> bool:
        return self.points is not None


class MICPLocalization:
    """Mesh-ICP pose tracking over a mesh map, on the map's device.

    Config schema as the reference YAML (micp_localization.cpp:116-185 and
    the sensors.* subtree of loadSensor :507-808), e.g.::

        optimization_iterations: 5
        disable_correction: false
        adaptive_max_dist: true
        initial_pose_guess: [0, 0, 0, 0, 0, 0]
        engine: auto                  # auto | binned | bvh
        sensors:
          lidar3d:
            weight: 2.0
            correspondences:
              type: RC                # RC | CP
              max_dist: 0.5
              adaptive_max_dist_min: 0.15
    """

    def __init__(self, map_: MeshMap, config: Optional[ParamTree] = None):
        self.map = map_
        self.device = map_.bvh.device
        if self.device.type == "cuda":
            from concurrent.futures import ThreadPoolExecutor

            from rmcl_tpu_torch import _build

            with ThreadPoolExecutor(len(_KERNELS)) as pool:  # one nvcc a source, together
                list(pool.map(_build.load_library, _KERNELS))
        self.config = config or ParamTree()
        # engine_options.c_hyper is not read, as the JAX node does not read it
        self.micp_config = MICPConfig(
            optimization_iterations=int(self.config.get("optimization_iterations", 5)),
            adaptive_max_dist=bool(self.config.get("adaptive_max_dist", True)),
            disable_correction=bool(self.config.get("disable_correction", False)),
            solver=str(self.config.get("solver", "p2l_gn")),
            c_super=int(self.config.get("engine_options.c_super", 24)),
            c_bin=int(self.config.get("engine_options.c_bin", 96)),
            c_mid=int(self.config.get("engine_options.c_mid", 0)),
        )
        # ray engine for RC casts and CP queries: 'bvh' (exact), 'binned'
        # (dense; needs the map's bins) or 'auto' (binned when the map has
        # bins: a tracking scan's blocks are coherent, which the dense
        # engine's budgets suit; the audit below checks them)
        self.engine = str(self.config.get("engine", "auto"))
        if self.engine == "auto":
            self.engine = "binned" if getattr(map_, "bins", None) is not None else "bvh"
        if self.engine == "binned" and getattr(map_, "bins", None) is None:
            raise ValueError("engine='binned' needs a MeshMap with triangle bins")
        self.sensors: Dict[str, MICPSensorState] = {}
        for name, sub in self.config.subtree("sensors").items():
            state = self.ensure_sensor(name)
            state.config = MICPSensorConfig.create(
                max_dist=float(sub.get("correspondences.max_dist", 0.5)),
                adaptive_max_dist_min=float(sub.get("correspondences.adaptive_max_dist_min", 0.15)),
                weight=float(sub.get("weight", 1.0)),
                corr_type=str(sub.get("correspondences.type", "RC")),
            )
            # static sensor -> base mount from config (6- or 7-tuple), the
            # reference's static TF lookup; a per-message tsb overrides it
            mount = sub.get("tsb")
            if mount is not None:
                state.tsb = Transform.from_pose_tuple(mount, device=self.device)

        guess = self.config.get("initial_pose_guess", [0, 0, 0, 0, 0, 0])
        self._initial_guess = Transform.from_pose_tuple(guess, device=self.device)
        # fixed offset right-composed onto every externally supplied pose
        # guess (reference pose_guess_offset, micp_localization.cpp:141-162, :489)
        offset = self.config.get("pose_guess_offset", [0, 0, 0, 0, 0, 0])
        self._pose_guess_offset = Transform.from_pose_tuple(offset, device=self.device)
        self.tom: Optional[Transform] = None  # set on the first odometry
        self.tbo: Transform = Transform.identity(device=self.device)
        self.convergence_progress = torch.zeros((), dtype=torch.float32, device=self.device)
        self.pose_noise = float(self.config.get("pose_noise", 0.01))
        # per-ray motion compensation of clouds whose RangeData carries
        # per-ray stamps, from the last two stamped odometry samples
        self.motion_compensation = bool(self.config.get("motion_compensation", False))
        self._odom_hist: List = []  # [(stamp, Tbo)]: the last two stamped samples
        self.corrections = 0
        self.last_stats: Optional[MICPStats] = None
        # audit of the dense engine's budgets before the first binned
        # correction (RC sensors' ray cull) and before each new scan of a
        # CP sensor (the closest-point cull): adopts corrected budgets
        # unless engine_options.auto_budget is false, in which case it warns
        self._budget_checked = False
        self._cp_budget_checked = False
        self._auto_budget = bool(self.config.get("engine_options.auto_budget", True))
        # ingest diagnostics thresholds (reference: a warning at 0.5 s of
        # delay, clock-type mismatches dropped, MICPSphericalSensorCPU.cpp:104-124)
        self.ingest_delay_warn = float(self.config.get("ingest_delay_warn", 0.5))
        self.ingest_clock_mismatch = float(self.config.get("ingest_clock_mismatch", 1e6))
        # (store, total, count) of the rmcl.micp.step span at the last print
        self._step_mark = (None, 0.0, 0)

    def _on_device(self, t: Transform) -> Transform:
        return Transform(rot=t.rot.to(self.device), trans=t.trans.to(self.device))

    # -- sensor ingest -----------------------------------------------------

    def ensure_sensor(self, name: str) -> MICPSensorState:
        if name not in self.sensors:
            self.sensors[name] = MICPSensorState(
                name=name, tsb=Transform.identity(device=self.device))
        return self.sensors[name]

    @_ingest
    def on_scan(self, name: str, msg: msgs.ScanStamped, tsb: Transform = None):
        """Spherical scan message (reference MICPSphericalSensor*::updateMsg)."""
        if not self._ingest_ok(name, msg.header.stamp):
            return
        s = self.ensure_sensor(name)
        s.model = scan_info_to_model(msg.info)
        s.points, s.mask = scan_to_points(msg, model=s.model)
        self._finish_update(s, msg.header.stamp, tsb, msg.data.stamps)

    @_ingest
    def on_depth(self, name: str, msg: msgs.DepthStamped, tsb: Transform = None):
        if not self._ingest_ok(name, msg.header.stamp):
            return
        s = self.ensure_sensor(name)
        s.model = depth_info_to_model(msg.info)
        z = np.asarray(msg.data.ranges, np.float32)
        s.points = s.model.depth_to_cartesian(torch.from_numpy(z)).numpy()
        s.mask = (z >= msg.info.range_min) & (z <= msg.info.range_max)
        if msg.data.mask is not None:
            s.mask = s.mask & np.asarray(msg.data.mask, bool)
        self._finish_update(s, msg.header.stamp, tsb, msg.data.stamps)

    @_ingest
    def on_o1dn(self, name: str, msg: msgs.O1DnStamped, tsb: Transform = None):
        if not self._ingest_ok(name, msg.header.stamp):
            return
        s = self.ensure_sensor(name)
        s.model = o1dn_info_to_model(msg.info, device=self.device)
        self._ranged_points(s, msg)
        self._finish_update(s, msg.header.stamp, tsb, msg.data.stamps)

    @_ingest
    def on_ondn(self, name: str, msg: msgs.OnDnStamped, tsb: Transform = None):
        if not self._ingest_ok(name, msg.header.stamp):
            return
        s = self.ensure_sensor(name)
        s.model = ondn_info_to_model(msg.info, device=self.device)
        self._ranged_points(s, msg)
        self._finish_update(s, msg.header.stamp, tsb, msg.data.stamps)

    def _ranged_points(self, s: MICPSensorState, msg) -> None:
        """Points and mask of an O1Dn or OnDn message through its model."""
        r = np.asarray(msg.data.ranges, np.float32)
        s.points = _host(s.model.polar_to_cartesian(torch.from_numpy(r).to(self.device)),
                         np.float32)
        s.mask = (r >= msg.info.range_min) & (r <= msg.info.range_max)
        if msg.data.mask is not None:
            s.mask = s.mask & np.asarray(msg.data.mask, bool)

    @_ingest
    def set_static_dataset(self, name: str, model, points, mask, tsb=None):
        """Static dataset mode (reference data_source: parameters,
        MICPSphericalSensorCPU::getDataFromParameters :53-95)."""
        s = self.ensure_sensor(name)
        s.model = model
        s.points = _host(points, np.float32)
        s.mask = _host(mask, bool)
        self._finish_update(s, 0.0, tsb)

    def _ingest_ok(self, name: str, stamp: float) -> bool:
        """Ingest diagnostics (reference MICPSphericalSensorCPU updateMsg
        :104-124) against the odometry stamps: a message wildly off that
        clock (another clock source) is dropped; moderate skew warns."""
        if not self._odom_hist or not stamp:
            return True
        import warnings

        now = self._odom_hist[-1][0]
        diff = now - float(stamp)
        if abs(diff) > self.ingest_clock_mismatch:
            warnings.warn(
                f"[{name}] STAMP MISMATCH: message stamp {stamp:.3f} is "
                f"{diff:.1f}s from the odometry clock {now:.3f} — "
                f"different clock sources? Dropping the message.",
                stacklevel=4,
            )
            return False
        if abs(diff) > self.ingest_delay_warn:
            warnings.warn(
                f"[{name}] NETWORK DELAY: (now - msg stamp) = {diff * 1e3:.0f} ms; control "
                f"algorithms may not work as expected.",
                stacklevel=4,
            )
        return True

    def _finish_update(self, s: MICPSensorState, stamp: float, tsb, stamps=None):
        if tsb is not None:
            s.tsb = self._on_device(tsb)
        if self.motion_compensation and stamps is not None and len(self._odom_hist) >= 2:
            from rmcl_tpu_torch.sensors.deskew import deskew_points

            (st_a, tbo_a), (st_b, tbo_b) = self._odom_hist[-2:]
            s.points = _host(deskew_points(
                torch.from_numpy(s.points).to(self.device),
                torch.as_tensor(np.asarray(stamps, np.float32)).to(self.device),
                stamp, s.tsb, tbo_a, st_a, tbo_b, st_b), np.float32)
        s.stamp = stamp
        s.outdated = True
        s.device_data = None  # invalidate the device-side snapshot

    def print_setup(self, color: Optional[bool] = None) -> str:
        """Console setup report (reference printSetup,
        micp_localization.cpp:313-411). Returns the text and prints it."""
        from rmcl_tpu_torch.utils.console import micp_setup_banner

        text = micp_setup_banner(self, color=color)
        print(text)
        return text

    # -- odometry / initialization ----------------------------------------

    @_ingest
    def on_odometry(self, tbo: Transform, stamp: Optional[float] = None):
        """Base -> odom update (the reference's TF subscription). Initializes
        ``Tom = initial_pose_guess * ~Tbo`` on the first one (reference
        :245-283). ``stamp`` feeds the de-skew history
        (``motion_compensation: true``)."""
        tbo = self._on_device(tbo)
        self.tbo = tbo
        if stamp is not None:
            # a duplicate stamp carries no velocity: replace the last sample
            if self._odom_hist and abs(self._odom_hist[-1][0] - float(stamp)) < 1e-3:
                self._odom_hist[-1] = (float(stamp), tbo)
            else:
                self._odom_hist.append((float(stamp), tbo))
            del self._odom_hist[:-2]
        if self.tom is None:
            self.tom = self._initial_guess @ tbo.inverse()

    def set_pose(self, pose_bm: Transform):
        """/initialpose equivalent: ``Tom = (Tbm * offset) * ~Tbo`` and a
        reset of the convergence state (reference poseCB :413-505, :489)."""
        self.tom = (self._on_device(pose_bm) @ self._pose_guess_offset) @ self.tbo.inverse()
        self.convergence_progress = torch.zeros((), dtype=torch.float32, device=self.device)
        self.corrections = 0

    # -- correction --------------------------------------------------------

    def step(self) -> Optional[MICPStats]:
        """One correction (the correctionLoop body, reference :1086-1171).
        Returns the correction's statistics, or None if not ready. With
        tracing on, every 1000th correction prints the mean of the
        ``rmcl.micp.step`` span over the corrections since the last print
        (the reference's MEASURE_TIMES average, :1120-1161; host time, no
        synchronisation)."""
        if self.tom is None:
            return None
        active = [s for s in self.sensors.values() if s.has_data()]
        if not active:
            return None
        with timing.span("rmcl.micp.step"):
            stats = self._correct(active)
        if timing.tracing() and self.corrections % 1000 == 0:
            self._print_mean_step()
        return stats

    def _correct(self, active: List[MICPSensorState]) -> MICPStats:
        sensor_data, fresh = [], []
        for s in active:
            if s.device_data is None or s.outdated:
                with timing.span("rmcl.micp.upload"):
                    points = torch.from_numpy(s.points).to(self.device)
                    # a CP scan on bins keeps the query blocks of its first
                    # correction for the others (their budgets audited once)
                    order_points = None
                    if self.engine == "binned" and s.config.corr_type == "CP":
                        order_points = (self.tom @ self.tbo @ s.tsb).apply(points)
                    s.device_data = MICPSensorData(
                        model=s.model,
                        points=points,
                        mask=torch.from_numpy(s.mask).to(self.device),
                        tsb=s.tsb,
                        config=s.config,
                        cp_order_points=order_points,
                    )
                fresh.append(s.device_data)
            sensor_data.append(s.device_data)
        accel = self.map.bins if self.engine == "binned" else self.map.bvh
        if self.engine == "binned":
            rc = [] if self._budget_checked else [d for d in sensor_data
                                                  if d.config.corr_type != "CP"]
            # CP: each new scan (a later scan of a loop can need more than
            # the first), or only the first where budgets are not adopted
            cp = [d for d in fresh if d.config.corr_type == "CP"]
            if self._cp_budget_checked and not self._auto_budget:
                cp = []
            if rc or cp:
                with timing.span("rmcl.micp.audit"):
                    if rc:
                        self._check_budgets(rc)
                    if cp:
                        self._check_cp_budgets(cp)
        tom_new, stats = correct_once(accel, sensor_data, self.tom, self.tbo,
                                      self.convergence_progress, config=self.micp_config)
        self.tom = tom_new
        self.convergence_progress = stats.convergence_progress
        self.last_stats = stats
        self.corrections += 1
        for s in active:
            s.outdated = False
        return stats

    def _print_mean_step(self) -> None:
        st = timing.store()
        total, n = st.total["rmcl.micp.step"], st.count["rmcl.micp.step"]
        mark, self._step_mark = self._step_mark, (st, total, n)
        if mark[0] is st:  # the same store: take the corrections since the mark
            total, n = total - mark[1], n - mark[2]
        if n:
            print(f"[micp] {self.corrections} corrections, avg {total / n * 1e3:.2f} ms "
                  f"over the last {n}")

    # -- outputs -----------------------------------------------------------

    def _check_budgets(self, sensor_data) -> None:
        """Audit the dense engine's candidate budgets on every RC sensor's
        scan rays from the current pose estimate (the block composition the
        correction casts) through the engine's own cull, whose saturation
        flag covers every level. CP sensors have an audit of their own
        (:meth:`_check_cp_budgets`); the JAX node covers them by this one."""
        import warnings

        from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats
        from rmcl_tpu_torch.utils.tune import suggest_budgets

        self._budget_checked = True
        cfg = self.micp_config
        tbm = self.tom @ self.tbo
        worst_sat = 0.0
        worst_rays = None
        for data in sensor_data:
            o_s, d_s = data.model.rays(self.device)
            tsm = tbm @ data.tsb
            o = tsm.apply(o_s)
            d = tsm.rotate(d_s)
            _, sat = block_cull_stats(self.map.bins, o, d, c_super=cfg.c_super,
                                      c_bin=cfg.c_bin, c_mid=cfg.c_mid, c_hyper=cfg.c_hyper)
            sat_frac = float(sat.float().mean())
            if sat_frac > worst_sat or worst_rays is None:
                worst_sat = sat_frac
                worst_rays = (o, d)
        if worst_sat == 0.0:
            return
        if not self._auto_budget:
            warnings.warn(
                f"MICP binned-engine budgets saturate ({worst_sat:.0%} of ray blocks truncated "
                f"at some cull level, c_super={cfg.c_super}/c_bin={cfg.c_bin}) — "
                f"correspondences may silently drop geometry. Raise engine_options budgets or "
                f"enable engine_options.auto_budget.",
                stacklevel=4,
            )
            return
        rec = suggest_budgets(self.map.bins, *worst_rays)
        self.micp_config = dataclasses.replace(
            cfg, c_super=max(rec.c_super, cfg.c_super), c_bin=max(rec.c_bin, cfg.c_bin),
            c_mid=rec.c_mid)
        print(f"[rmcl_tpu_torch] MICP binned budgets saturated at c_bin={cfg.c_bin}; "
              f"auto-adopting c_super={self.micp_config.c_super} "
              f"c_bin={self.micp_config.c_bin} c_mid={self.micp_config.c_mid} "
              f"(worst sampled block: {rec.max_bins} bins)")

    def _check_cp_budgets(self, sensor_data) -> None:
        """Audit the closest-point query's budgets on each CP sensor's new
        scan from the current pose estimate: the supers and bins within
        each query block's bound of its box, in the blocks the query forms
        and keeps for the scan (``cp_order_points``, the scan's points in
        the map frame at this pose;
        :func:`~rmcl_tpu_torch.utils.tune.suggest_cp_budgets`, one
        readback). Where the CP budgets (``MICPConfig.cp_budgets``) do not
        cover the widest block with the suggestion's margin, adopts budgets
        that do (they only grow), unless engine_options.auto_budget is
        false, in which case it warns. The RC budgets stay as they are."""
        import warnings

        from rmcl_tpu_torch.utils.tune import suggest_cp_budgets

        self._cp_budget_checked = True
        cfg = self.micp_config
        cs, cb = cfg.cp_budgets()
        need, rec = (0, 0), (cs, cb)
        for data in sensor_data:
            c_super, c_bin, ns, nb = suggest_cp_budgets(self.map.bins, data.cp_order_points,
                                                        data.config.max_dist)
            need = (max(need[0], ns), max(need[1], nb))
            rec = (max(rec[0], c_super), max(rec[1], c_bin))
        if rec == (cs, cb):
            return
        if not self._auto_budget:
            short = "truncate" if need[0] > cs or need[1] > cb else "leave no margin"
            warnings.warn(
                f"MICP closest-point budgets {short} (the widest query block needs {need[0]} "
                f"supers and {need[1]} bins, c_super={cs}/c_bin={cb}) — correspondences may "
                f"miss nearer geometry. Raise engine_options budgets or enable "
                f"engine_options.auto_budget.",
                stacklevel=4,
            )
            return
        self.micp_config = dataclasses.replace(cfg, cp_super=rec[0], cp_bin=rec[1])
        print(f"[rmcl_tpu_torch] MICP closest-point budgets short of the margin at "
              f"c_super={cs} c_bin={cb}; auto-adopting cp_super={rec[0]} cp_bin={rec[1]} "
              f"(widest query block: {need[0]} supers, {need[1]} bins)")

    def pose_base_map(self) -> Transform:
        """Tbm = Tom * Tbo: the tracked base pose in the map frame."""
        return self.tom @ self.tbo

    def pose_with_covariance(self) -> msgs.ParticleStatsMsg:
        """Heuristic isotropic covariance from the convergence progress
        (reference publishPose :1053-1084: XX = (1 - progress) + pose_noise)."""
        p = self.pose_base_map()
        q = _host(p.rot, np.float32)
        var = float(1.0 - float(self.convergence_progress)) + self.pose_noise
        cov = np.eye(6, dtype=np.float32) * var
        pose7 = np.concatenate([_host(p.trans, np.float32), [q[1], q[2], q[3], q[0]]])
        return msgs.ParticleStatsMsg(
            pose=pose7,
            covariance=cov,
            likelihood=msgs.LikelihoodStats(0.0, 0.0, 0.0, 0.0),
            shift=0.0,
            trans_bb_min=np.zeros(3),
            trans_bb_max=np.zeros(3),
            nparticles=0,
        )

    def sensor_stats(self) -> Optional[msgs.MICPSensorStats]:
        if self.last_stats is None:
            return None
        st = self.last_stats
        return msgs.MICPSensorStats(
            total_measurements=int(st.total_measurements),
            valid_measurements=int(st.valid_measurements),
            valid_matches=float(st.valid_matches),
            covariance_trace=float(st.covariance_trace),
        )
