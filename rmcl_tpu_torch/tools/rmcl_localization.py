"""RMCL particle-filter CLI — the reference's ``rmcl_localization_node``.

Counterpart of ``rmcl_tpu.tools.rmcl_localization``. Replays an NPZ
message log (odometry + point clouds) through
``mcl.node.MCLNode``: motion updates on odometry records, sensor updates
+ resampling on cloud records, pose estimation after every resample.

    python -m rmcl_tpu_torch.tools.rmcl_localization --map world.obj --log run.npz \
        [--config rmcl.yaml] [--device cuda|cpu] \
        [--global-box xmin ymin zmin rmin pmin yawmin xmax ymax zmax rmax pmax yawmax] \
        [--initial-pose x y z roll pitch yaw] [--out track.npz]

Reference: rmcl_localization.cpp:19-111 (node), :277-342 (global init),
services rmcl/global_localization + rmcl/initial_pose_guess (:54-77).
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
    ap.add_argument("--log", required=True, help="NPZ MessageLog (odom + cloud records)")
    ap.add_argument("--config", default=None, help="YAML config (reference schema)")
    ap.add_argument("--out", default=None, help="pose-track NPZ output")
    ap.add_argument("--global-box", nargs=12, type=float, default=None,
                    help="uniform global init box (min6 then max6)")
    ap.add_argument("--initial-pose", nargs=6, type=float, default=None,
                    help="Gaussian init around (x y z roll pitch yaw)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from rmcl_tpu_torch.io.replay import MessageLog, replay
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.node import MCLConfig, MCLNode
    from rmcl_tpu_torch.tools._common import load_config, load_map, pose_tuple, save_track

    world = load_map(args.map, device=args.device)
    config = MCLConfig.from_params(load_config(args.config))
    node = MCLNode(world, config)

    if args.global_box is not None:
        node.global_localization(args.global_box[:6], args.global_box[6:])
    elif args.initial_pose is not None:
        node.initial_pose_guess(pose_tuple(args.initial_pose, device=args.device))
    else:
        lo = world.mesh.vertices.min(axis=0)
        hi = world.mesh.vertices.max(axis=0)
        node.global_localization(
            (lo[0], lo[1], lo[2], 0.0, 0.0, -np.pi),
            (hi[0], hi[1], hi[2], 0.0, 0.0, np.pi),
        )

    # build the kernels' libraries before the first update
    log = MessageLog.load(args.log, device=args.device)
    for rec in log:
        if rec.kind == "cloud":
            node.warm(int(np.shape(rec.payload["points"])[0]))
            break

    stamps, track, tbo_latest = [], [], Transform.identity(device=args.device)

    def on_odom(rec):
        nonlocal tbo_latest
        tbo_latest = rec.payload
        node.motion_update(rec.payload, rec.stamp)

    def on_cloud(rec):
        points = torch.from_numpy(np.asarray(rec.payload["points"], np.float32))
        mask = torch.from_numpy(np.asarray(rec.payload["mask"], bool))
        node.sensor_update(points, mask, Transform.identity(device=args.device))
        node.resample()
        est = node.estimate()
        stamps.append(rec.stamp)
        track.append(est.pose)

    n = replay(log, {"odom": on_odom, "cloud": on_cloud})
    print(f"replayed {n} records, {len(track)} pose estimates", flush=True)
    if track:
        est = node.estimate()
        print(
            f"final pose {est.pose.trans.cpu().numpy().round(3).tolist()}, "
            f"likelihood mean {float(est.likelihood_mean):.3e}, "
            f"ESS {node.ess():.0f}"
        )
    if args.out and track:
        save_track(args.out, stamps, track)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
