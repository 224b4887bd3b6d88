"""Scan/map segmentation CLI — the reference's ``*_map_segmentation_*`` nodes.

Counterpart of ``rmcl_tpu.tools.map_segmentation``. For every scan record
in the log, classify each beam against the map from the current
(odometry-tracked) pose: *scan outliers* are dynamic obstacles not in the
map; *map outliers* are stale map geometry the sensor sees through. Writes
one NPZ with per-scan outlier masks and points.

    python -m rmcl_tpu_torch.tools.map_segmentation --map world.obj --log run.npz \
        [--pose x y z r p yaw] [--min-dist-scan 0.15] [--min-dist-map 0.15] \
        [--out segmentation.npz] [--device cuda|cpu]

Reference: map_segmentation.cpp:6-80 (params/pubs),
scan_map_segmentation_embree.cpp:31-194 (classification).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from rmcl_tpu_torch.tools._common import add_device_argument


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--map", required=True)
    ap.add_argument("--log", required=True, help="NPZ MessageLog (scan [+ odom] records)")
    ap.add_argument("--pose", nargs=6, type=float, default=None,
                    help="fixed sensor pose if the log has no odometry")
    ap.add_argument("--min-dist-scan", type=float, default=0.15)
    ap.add_argument("--min-dist-map", type=float, default=0.15)
    ap.add_argument("--out", default="segmentation.npz")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from rmcl_tpu_torch.io.conversions import o1dn_info_to_model, scan_info_to_model
    from rmcl_tpu_torch.io.replay import MessageLog, replay
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.ops.segmentation import segment_scan
    from rmcl_tpu_torch.tools._common import load_map, pose_tuple

    world = load_map(args.map, device=args.device)
    pose = (pose_tuple(args.pose, device=args.device) if args.pose
            else Transform.identity(device=args.device))
    out, state = {}, {"pose": pose, "i": 0}

    def on_odom(rec):
        state["pose"] = rec.payload

    def on_scan(rec):
        _segment(scan_info_to_model(rec.payload.info), rec)

    def on_o1dn(rec):
        # generic-LiDAR variant (reference O1DnMapSegmentationEmbreeNode —
        # o1dn_map_segmentation_embree.cpp): segment_scan is model-generic,
        # only the record unpacking differs
        _segment(o1dn_info_to_model(rec.payload.info, device=args.device), rec)

    def _segment(model, rec):
        ranges = torch.from_numpy(np.asarray(rec.payload.data.ranges, np.float32))
        mask = rec.payload.data.mask
        seg = segment_scan(
            world.bvh, model, state["pose"], ranges,
            min_dist_outlier_scan=args.min_dist_scan,
            min_dist_outlier_map=args.min_dist_map,
            mask_real=None if mask is None else torch.from_numpy(np.asarray(mask, bool)),
        )
        i = state["i"]
        out[f"s{i}_stamp"] = np.float64(rec.stamp)
        for name in ("scan_outlier", "map_outlier", "scan_points", "map_points"):
            out[f"s{i}_{name}"] = getattr(seg, name).cpu().numpy()
        state["i"] += 1
        print(
            f"scan {i} @ {rec.stamp:.3f}: "
            f"{int(out[f's{i}_scan_outlier'].sum())} scan outliers, "
            f"{int(out[f's{i}_map_outlier'].sum())} map outliers",
            flush=True,
        )

    replay(MessageLog.load(args.log, device=args.device),
           {"odom": on_odom, "scan": on_scan, "o1dn": on_o1dn})
    np.savez_compressed(args.out, n_scans=state["i"], **out)
    print(f"wrote {args.out} ({state['i']} scans)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
