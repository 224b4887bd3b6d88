"""Wire-type dataclasses mirroring the reference's ``rmcl_msgs`` package.

Counterpart of ``rmcl_tpu.io.msgs``, field for field: host-side
dataclasses over numpy arrays, the ingest boundary of the localization
nodes (files, replay logs, simulators or middleware bridges all produce
these).

Mapping (reference rmcl_msgs/msg/*.msg):
  ScanInfo / DepthInfo / O1DnInfo / OnDnInfo  → the sensor-model metadata
  RangeData                                    → ranges + optional channels
  Scan/Depth/O1Dn/OnDn (+ *Stamped wrappers)   → model + data + header
  MICPSensorStats / MICPStats / ParticleStats / LikelihoodStats → outputs
  srv/SetInitialPose                           → MCLNode.initial_pose_guess
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Header:
    stamp: float = 0.0  # seconds
    frame_id: str = ""


@dataclasses.dataclass
class RangeData:
    """reference msg/RangeData.msg:1-10 — ranges plus optional per-ray
    channels, all aligned to the sensor model's buffer order."""

    ranges: np.ndarray  # (N,) float32
    mask: Optional[np.ndarray] = None  # (N,) bool
    normals: Optional[np.ndarray] = None  # (N, 3)
    colors: Optional[np.ndarray] = None  # (N, 3)
    stamps: Optional[np.ndarray] = None  # (N,) per-ray time offsets
    intensities: Optional[np.ndarray] = None  # (N,)
    labels: Optional[np.ndarray] = None  # (N,) int32


@dataclasses.dataclass
class ScanInfo:
    """reference msg/ScanInfo.msg:1-14 — spherical scan grid."""

    phi_n: int
    theta_n: int
    phi_min: float
    phi_inc: float
    theta_min: float
    theta_inc: float
    range_min: float
    range_max: float


@dataclasses.dataclass
class DepthInfo:
    """Pinhole intrinsics (reference msg/DepthInfo.msg)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    range_min: float
    range_max: float


@dataclasses.dataclass
class O1DnInfo:
    """reference msg/O1DnInfo.msg: one origin, N directions, organized as a
    width x height grid (width/height None = unorganized N x 1)."""

    orig: np.ndarray  # (3,)
    dirs: np.ndarray  # (N, 3)
    range_min: float
    range_max: float
    width: Optional[int] = None
    height: Optional[int] = None

    def grid(self) -> tuple:
        n = len(self.dirs)
        w = self.width if self.width else n
        h = self.height if self.height else (n // max(w, 1))
        return w, h


@dataclasses.dataclass
class OnDnInfo:
    origs: np.ndarray  # (N, 3)
    dirs: np.ndarray  # (N, 3)
    range_min: float
    range_max: float


@dataclasses.dataclass
class ScanStamped:
    header: Header
    info: ScanInfo
    data: RangeData


@dataclasses.dataclass
class DepthStamped:
    header: Header
    info: DepthInfo
    data: RangeData


@dataclasses.dataclass
class O1DnStamped:
    header: Header
    info: O1DnInfo
    data: RangeData


@dataclasses.dataclass
class OnDnStamped:
    header: Header
    info: OnDnInfo
    data: RangeData


@dataclasses.dataclass
class PointCloud2:
    """Minimal unorganized cloud stand-in for sensor_msgs/PointCloud2:
    xyz points + optional channels (the fields the reference's
    estimateModelAndData extracts — conversions.cpp:869-1074)."""

    header: Header
    points: np.ndarray  # (N, 3) float32 (NaN rows = invalid)
    normals: Optional[np.ndarray] = None
    intensities: Optional[np.ndarray] = None
    stamps: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None  # (N, 4) RGBA in [0, 1]
    # organized clouds (depth-camera style): row-major height x width grid;
    # None = unorganized (N x 1)
    width: Optional[int] = None
    height: Optional[int] = None

    def valid_mask(self) -> np.ndarray:
        return np.isfinite(self.points).all(axis=1)


@dataclasses.dataclass
class LaserScan:
    """sensor_msgs/LaserScan equivalent (input of ScanToScanNode)."""

    header: Header
    angle_min: float
    angle_increment: float
    range_min: float
    range_max: float
    ranges: np.ndarray  # (N,)


@dataclasses.dataclass
class LikelihoodStats:
    mean: float
    sigma: float
    min: float
    max: float


@dataclasses.dataclass
class MICPSensorStats:
    """reference msg/MICPSensorStats.msg (published per correction,
    micp_localization.cpp:1009-1015)."""

    total_measurements: int
    valid_measurements: int
    valid_matches: float
    covariance_trace: float


@dataclasses.dataclass
class ParticleStatsMsg:
    """reference msg/ParticleStats.msg:1-11."""

    pose: np.ndarray  # (7,) x y z qx qy qz qw
    covariance: np.ndarray  # (6, 6)
    likelihood: LikelihoodStats
    shift: float
    trans_bb_min: np.ndarray
    trans_bb_max: np.ndarray
    nparticles: int


@dataclasses.dataclass
class SetInitialPoseRequest:
    """reference srv/SetInitialPose.srv."""

    pose: np.ndarray  # (7,) or (6,)
    covariance: Optional[np.ndarray] = None  # (6, 6)
