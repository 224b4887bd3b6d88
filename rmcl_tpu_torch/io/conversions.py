"""Message ⇄ sensor-model conversions and cloud projections.

Counterpart of ``rmcl_tpu.io.conversions`` (the reference's conversion
layer, rmcl_ros/src/util/conversions.cpp and the conversion nodes):

  * model ⇄ info structs (LaserScan/ScanInfo→SphericalModel,
    DepthInfo→PinholeModel, O1Dn/OnDnInfo→models)
  * pointcloud → spherical scan grid binning  (Pc2ToScanNode —
    reference pc2_to_scan.cpp:105-213)
  * pointcloud → O1Dn model+data estimation   (Pc2ToO1DnNode —
    reference pc2_to_o1dn.cpp + conversions.cpp:869-1074)
  * LaserScan → ScanStamped with decimation   (ScanToScanNode —
    reference scan_to_scan.cpp:5-132)
  * scan ⇄ cartesian point rendering

Host-side (numpy, and torch on the CPU where a sensor model renders
points): these run at message rate, not ray rate. The O1Dn and OnDn info →
model functions take ``device`` for the model's tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.io import msgs
from rmcl_tpu_torch.sensors.models import (O1DnModel, OnDnModel, PinholeModel, RangeInterval,
                                           SphericalModel)


# ---------------------------------------------------------------------------
# info ⇄ model
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    return float(np.float32(x))


def scan_info_to_model(info: msgs.ScanInfo) -> SphericalModel:
    """reference convert(ScanInfo, SphericalModel)."""
    return SphericalModel(
        theta_min=_f32(info.theta_min),
        theta_inc=_f32(info.theta_inc),
        phi_min=_f32(info.phi_min),
        phi_inc=_f32(info.phi_inc),
        range=RangeInterval.of(info.range_min, info.range_max),
        width=info.theta_n,
        height=info.phi_n,
    )


def model_to_scan_info(model: SphericalModel) -> msgs.ScanInfo:
    return msgs.ScanInfo(
        phi_n=model.height,
        theta_n=model.width,
        phi_min=float(model.phi_min),
        phi_inc=float(model.phi_inc),
        theta_min=float(model.theta_min),
        theta_inc=float(model.theta_inc),
        range_min=float(model.range.min),
        range_max=float(model.range.max),
    )


def depth_info_to_model(info: msgs.DepthInfo) -> PinholeModel:
    return PinholeModel.create(
        width=info.width,
        height=info.height,
        fx=info.fx,
        fy=info.fy,
        cx=info.cx,
        cy=info.cy,
        range_min=info.range_min,
        range_max=info.range_max,
    )


def o1dn_info_to_model(info: msgs.O1DnInfo, device="cuda") -> O1DnModel:
    return O1DnModel.create(
        info.dirs, orig=info.orig, range_min=info.range_min, range_max=info.range_max,
        device=device,
    )


def ondn_info_to_model(info: msgs.OnDnInfo, device="cuda") -> OnDnModel:
    return OnDnModel.create(
        info.origs, info.dirs, range_min=info.range_min, range_max=info.range_max,
        device=device,
    )


def laser_scan_to_scan_info(scan: msgs.LaserScan) -> msgs.ScanInfo:
    """sensor_msgs/LaserScan → spherical grid (single elevation row)."""
    return msgs.ScanInfo(
        phi_n=1,
        theta_n=len(scan.ranges),
        phi_min=0.0,
        phi_inc=0.0,
        theta_min=scan.angle_min,
        theta_inc=scan.angle_increment,
        range_min=scan.range_min,
        range_max=scan.range_max,
    )


# ---------------------------------------------------------------------------
# scan data ⇄ points
# ---------------------------------------------------------------------------


def scan_to_points(
    msg: msgs.ScanStamped, model: Optional[SphericalModel] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Polar ranges → sensor-frame cartesian points + validity mask
    (reference unpackMessage — MICPSphericalSensorCPU.cpp:181-233).
    Pass ``model`` when the caller already built it from msg.info. Host-side:
    the points are computed on the CPU."""
    if model is None:
        model = scan_info_to_model(msg.info)
    r = np.asarray(msg.data.ranges, np.float32)
    pts = model.polar_to_cartesian(torch.from_numpy(r)).numpy()
    mask = (r >= msg.info.range_min) & (r <= msg.info.range_max)
    if msg.data.mask is not None:
        mask = mask & np.asarray(msg.data.mask, bool)
    return pts, mask


# ---------------------------------------------------------------------------
# Pc2ToScan — project an unorganized cloud into a spherical grid
# ---------------------------------------------------------------------------


def _safe_inc(inc: float) -> float:
    """Sign-preserving division guard: negative angle increments are legal
    (flipped-mount lidars); clamping them positive binned every point out
    of range."""
    if abs(inc) < 1e-12:
        return 1e-12
    return inc


def pointcloud_to_scan(
    cloud: msgs.PointCloud2,
    info: msgs.ScanInfo,
    keep: str = "nearest",
) -> msgs.ScanStamped:
    """Project points into the scan grid (reference Pc2ToScanNode::convert —
    pc2_to_scan.cpp:105-213: nearest-bin rounding + range gating).

    The reference keeps the LAST point written per bin; ``keep='nearest'``
    keeps the closest (strictly better, and deterministic); ``keep='last'``
    reproduces the reference exactly.
    """
    pts = cloud.points
    finite = np.isfinite(pts).all(axis=1)
    p = pts[finite]
    rng = np.linalg.norm(p, axis=1)
    # angles (note: the reference computes the vertical angle against the
    # full range — atan2(z, |p|) — reference pc2_to_scan.cpp:196; we use the
    # geometrically exact atan2(z, sqrt(x^2+y^2)))
    theta = np.arctan2(p[:, 1], p[:, 0])  # horizontal
    phi = np.arctan2(p[:, 2], np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2))  # vertical

    theta_id = np.floor((theta - info.theta_min) / _safe_inc(info.theta_inc) + 0.5).astype(int)
    if abs(abs(info.theta_n * info.theta_inc) - 2 * np.pi) < 1e-3:  # sign-agnostic
        theta_id = theta_id % info.theta_n  # full-circle grids wrap at ±pi
    phi_id = (
        np.floor((phi - info.phi_min) / _safe_inc(info.phi_inc) + 0.5).astype(int)
        if info.phi_n > 1
        else np.zeros(len(p), int)
    )
    ok = (
        (theta_id >= 0)
        & (theta_id < info.theta_n)
        & (phi_id >= 0)
        & (phi_id < info.phi_n)
        & (rng >= info.range_min)
        & (rng <= info.range_max)
    )
    buffer_id = phi_id[ok] * info.theta_n + theta_id[ok]
    r_ok = rng[ok]

    ranges = np.zeros(info.phi_n * info.theta_n, np.float32)  # 0 = invalid
    if keep == "nearest":
        nearest = np.full_like(ranges, np.inf)
        np.minimum.at(nearest, buffer_id, r_ok)
        ranges = np.where(np.isfinite(nearest), nearest, 0.0).astype(np.float32)
    else:
        ranges[buffer_id] = r_ok
    return msgs.ScanStamped(
        header=cloud.header,
        info=info,
        data=msgs.RangeData(ranges=ranges, mask=ranges > 0),
    )


# ---------------------------------------------------------------------------
# Pc2ToO1Dn — estimate a generic-LiDAR model + data from a cloud
# ---------------------------------------------------------------------------


def pointcloud_to_o1dn(
    cloud: msgs.PointCloud2,
    width_skip: int = 1,
) -> msgs.O1DnStamped:
    """Synthesize per-ray directions from the points themselves — full
    estimateModelAndData parity (reference conversions.cpp:869-1074):
    organized width x height grids pass through, every optional channel
    (mask/normals/colors/stamps/intensities/labels) is carried.

    The reference stores the mask byte INTO data.ranges
    (conversions.cpp:1014-1017, an apparent copy-paste slip); here the mask
    lands in data.mask where downstream consumers read it.

    ``width_skip`` is a convenience shim — use :func:`filter_o1dn` for the
    reference Pc2ToO1DnNode's full 2-D decimation (scan_operations.h:52-79).
    """
    pts = np.asarray(cloud.points, np.float32)
    finite = np.isfinite(pts).all(axis=1)
    rng = np.linalg.norm(np.where(finite[:, None], pts, 0.0), axis=1)
    safe = np.maximum(rng, 1e-12)
    # invalid points get zero dirs + zero range (reference :1001-1007)
    dirs = np.where(finite[:, None], pts / safe[:, None], 0.0)
    ranges = np.where(finite, rng, 0.0).astype(np.float32)
    r_top = float(ranges.max()) if ranges.size else 0.0  # empty clouds are legal
    w, h = cloud.width, cloud.height
    if w is None:
        w, h = len(pts), 1
    elif h is None:
        h = len(pts) // max(w, 1)
    info = msgs.O1DnInfo(
        orig=np.zeros(3, np.float32),
        dirs=dirs.astype(np.float32),
        range_min=0.0,
        range_max=r_top * 1.5 + 1e-3,
        width=w,
        height=h,
    )
    data = msgs.RangeData(ranges=ranges, mask=finite)
    if cloud.normals is not None:
        data.normals = np.asarray(cloud.normals, np.float32)
    if cloud.colors is not None:
        c = np.asarray(cloud.colors, np.float32)
        if c.shape[1] == 3:  # rgb -> rgba with a = 1 (reference :1043-1055)
            c = np.concatenate([c, np.ones((len(c), 1), np.float32)], axis=1)
        data.colors = c
    if cloud.intensities is not None:
        data.intensities = np.asarray(cloud.intensities, np.float32)
    if cloud.stamps is not None:
        # per-point capture offsets survive the conversion so downstream
        # motion compensation (sensors.deskew) keeps working
        data.stamps = np.asarray(cloud.stamps)
    if cloud.labels is not None:
        data.labels = np.asarray(cloud.labels)
    out = msgs.O1DnStamped(header=cloud.header, info=info, data=data)
    if width_skip > 1:
        out = filter_o1dn(out, width_increment=width_skip)
    return out


def filter_o1dn(
    o1dn: msgs.O1DnStamped,
    range_min: float = 0.0,
    range_max: float = 3.0e38,
    width_skip_begin: int = 0,
    width_skip_end: int = 0,
    width_increment: int = 1,
    height_skip_begin: int = 0,
    height_skip_end: int = 0,
    height_increment: int = 1,
) -> msgs.O1DnStamped:
    """2-D organized decimation of an O1Dn scan — the reference
    ``rmcl::filter`` / FilterOptions2D (scan_operations.h:52-79, impl
    scan_operations.cpp:41-130; the Pc2ToO1DnNode's dynamic-reconfigurable
    width/height params — pc2_to_o1dn.cpp:54-76): per-axis
    skip_begin/skip_end/increment over the width x height grid, with range
    limits tightened by the options (out.range_min = max, out.range_max =
    min — scan_operations.cpp:53-54). All optional channels ride along."""
    w, h = o1dn.info.grid()
    wi = np.arange(width_skip_begin, w - width_skip_end, max(width_increment, 1))
    hi = np.arange(height_skip_begin, h - height_skip_end, max(height_increment, 1))
    # buffer ids of the kept grid cells, row-major like the reference loop
    keep = (hi[:, None] * w + wi[None, :]).reshape(-1)
    take = lambda a: None if a is None else np.asarray(a)[keep]
    info = msgs.O1DnInfo(
        orig=o1dn.info.orig,
        dirs=np.asarray(o1dn.info.dirs)[keep],
        range_min=max(o1dn.info.range_min, range_min),
        range_max=min(o1dn.info.range_max, range_max),
        width=len(wi),
        height=len(hi),
    )
    d = o1dn.data
    data = msgs.RangeData(
        ranges=take(d.ranges),
        mask=take(d.mask),
        normals=take(d.normals),
        colors=take(d.colors),
        stamps=take(d.stamps),
        intensities=take(d.intensities),
        labels=take(d.labels),
    )
    return msgs.O1DnStamped(header=o1dn.header, info=info, data=data)


# ---------------------------------------------------------------------------
# ScanToScan — LaserScan ingestion with decimation
# ---------------------------------------------------------------------------


def laser_scan_to_scan(scan: msgs.LaserScan, skip_begin: int = 0, skip_end: int = 0, increment: int = 1) -> msgs.ScanStamped:
    """reference ScanToScanNode (scan_to_scan.cpp:5-132): skip/increment
    decimation of a planar laser scan."""
    n = len(scan.ranges)
    idx = np.arange(skip_begin, n - skip_end, increment)
    info = msgs.ScanInfo(
        phi_n=1,
        theta_n=len(idx),
        phi_min=0.0,
        phi_inc=0.0,
        theta_min=scan.angle_min + skip_begin * scan.angle_increment,
        theta_inc=scan.angle_increment * increment,
        range_min=scan.range_min,
        range_max=scan.range_max,
    )
    return msgs.ScanStamped(
        header=scan.header,
        info=info,
        data=msgs.RangeData(ranges=np.asarray(scan.ranges, np.float32)[idx]),
    )


def scan_to_pointcloud(msg: msgs.ScanStamped) -> msgs.PointCloud2:
    """Spherical scan → unorganized cloud (the reference's scan→PointCloud
    renderers, conversions.h:140-165 family; used for debug clouds —
    pc2_to_scan.cpp debug output). Invalid rays become NaN rows (the
    PointCloud2 invalid-point convention)."""
    pts, mask = scan_to_points(msg)
    out = pts.copy()
    out[~mask] = np.nan
    opt = lambda x: None if x is None else np.asarray(x)
    return msgs.PointCloud2(
        header=msg.header,
        points=out,
        normals=opt(msg.data.normals),
        intensities=opt(msg.data.intensities),
        stamps=opt(msg.data.stamps),
        labels=opt(msg.data.labels),
    )


def o1dn_to_pointcloud(msg: msgs.O1DnStamped) -> msgs.PointCloud2:
    """O1Dn scan → unorganized cloud (same renderer family). Per-ray
    channels (stamps/intensities/labels/normals) ride along so the
    o1dn → cloud → o1dn roundtrip preserves them (de-skew needs stamps)."""
    model = o1dn_info_to_model(msg.info, device="cpu")
    r = np.asarray(msg.data.ranges, np.float32)
    pts = model.polar_to_cartesian(torch.from_numpy(r)).numpy()
    mask = (r >= msg.info.range_min) & (r <= msg.info.range_max)
    if msg.data.mask is not None:
        mask = mask & np.asarray(msg.data.mask, bool)
    out = pts.copy()
    out[~mask] = np.nan
    opt = lambda x: None if x is None else np.asarray(x)
    return msgs.PointCloud2(
        header=msg.header,
        points=out,
        normals=opt(msg.data.normals),
        intensities=opt(msg.data.intensities),
        stamps=opt(msg.data.stamps),
        labels=opt(msg.data.labels),
    )
