"""MICP-L pose tracking CLI — the reference's ``micp_localization_node``.

Counterpart of ``rmcl_tpu.tools.micp_localization``. Replays an NPZ
message log (odometry + per-channel scans) through
``micp.node.MICPLocalization`` and writes the corrected base→map pose
track. The YAML config uses the reference schema (solver, engine,
``sensors.*`` blocks — docs/MICPL.md); sensors default to one RC block per
scan channel found in the log.

    python -m rmcl_tpu_torch.tools.micp_localization --map world.obj \
        --log run.npz [--config micp.yaml] [--out track.npz] [--banner] \
        [--device cuda|cpu]

Reference: micp_localization.cpp:108-311 (node), :1086-1171 (loop).
"""

from __future__ import annotations

import argparse
import sys

from rmcl_tpu_torch.tools._common import add_device_argument


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--map", required=True,
                    help="mesh map file (obj, stl, ply, off, dae, gltf, glb, 3mf, x3d, 3ds)")
    ap.add_argument("--log", required=True, help="NPZ MessageLog (odom + scan records)")
    ap.add_argument("--config", default=None, help="YAML config (reference schema)")
    ap.add_argument("--out", default=None, help="pose-track NPZ output")
    ap.add_argument("--banner", action="store_true", help="print the setup report")
    ap.add_argument("--steps-per-scan", type=int, default=1,
                    help="corrections to run per scan message")
    ap.add_argument("--initial-pose-guess", nargs="+", type=float, default=None,
                    help="6- or 7-tuple base pose in the map frame at start "
                         "(overrides the config key)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from rmcl_tpu_torch.io.replay import MessageLog, replay
    from rmcl_tpu_torch.micp.node import MICPLocalization
    from rmcl_tpu_torch.tools._common import load_config, load_map, save_track
    from rmcl_tpu_torch.utils.console import micp_setup_banner

    log = MessageLog.load(args.log, device=args.device)
    config = load_config(args.config)
    # default sensor blocks for channels the config doesn't mention
    channels = {
        r.channel for r in log if r.kind in ("scan", "depth", "o1dn", "ondn")
    }
    sensors = config.get("sensors", {}) or {}
    for ch in sorted(channels):
        sensors.setdefault(ch, {})
    config.set("sensors", sensors)
    if args.initial_pose_guess is not None:
        config.set("initial_pose_guess", list(args.initial_pose_guess))

    world = load_map(args.map, device=args.device)
    node = MICPLocalization(world, config)

    stamps, track = [], []

    def on_odom(rec):
        node.on_odometry(rec.payload, stamp=rec.stamp)

    def correct_and_record(stamp):
        for _ in range(args.steps_per_scan):
            node.step()
        if node.tom is not None:
            stamps.append(stamp)
            track.append(node.pose_base_map())

    def on_scan(rec):
        node.on_scan(rec.channel, rec.payload)
        correct_and_record(rec.stamp)

    def on_o1dn(rec):
        node.on_o1dn(rec.channel, rec.payload)
        correct_and_record(rec.stamp)

    def on_depth(rec):
        node.on_depth(rec.channel, rec.payload)
        correct_and_record(rec.stamp)

    def on_ondn(rec):
        node.on_ondn(rec.channel, rec.payload)
        correct_and_record(rec.stamp)

    n = replay(log, {"odom": on_odom, "scan": on_scan, "o1dn": on_o1dn,
                     "depth": on_depth, "ondn": on_ondn})
    if args.banner:
        print(micp_setup_banner(node))
    print(f"replayed {n} records, {len(track)} corrected poses", flush=True)
    if node.last_stats is not None:
        s = node.last_stats
        print(
            f"last correction: matches {float(s.valid_matches):.0f}/"
            f"{float(s.valid_measurements):.0f}, cov trace "
            f"{float(s.covariance_trace):.2e}"
        )
    if args.out and track:
        save_track(args.out, stamps, track)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
