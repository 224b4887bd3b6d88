"""Cloud/scan conversion CLI — the reference's ``conv_*`` nodes.

Counterpart of ``rmcl_tpu.tools.convert``. Rewrites a message log,
converting point-cloud records into spherical scan records (``--to scan``,
the Pc2ToScanNode projection) so they can drive the MICP CLI, or into a
standalone NPZ of O1Dn data (``--to o1dn``, the Pc2ToO1DnNode model
estimation). The conversions run on the host; ``--device`` holds the log's
odometry records.

    python -m rmcl_tpu_torch.tools.convert --log run.npz --to scan --out run_scan.npz \
        --width 900 --height 16 [--phi-min -0.2618 --phi-max 0.2618] \
        [--range-min 0.3 --range-max 130] [--device cuda|cpu]

Reference: pc2_to_scan.cpp:105-213, pc2_to_o1dn.cpp:16-120,
scan_to_scan.cpp:5-132.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rmcl_tpu_torch.tools._common import add_device_argument


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", required=True, help="NPZ MessageLog with cloud records")
    ap.add_argument("--to", choices=("scan", "o1dn"), default="scan")
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=900)
    ap.add_argument("--height", type=int, default=16)
    ap.add_argument("--phi-min", type=float, default=-0.2618)
    ap.add_argument("--phi-max", type=float, default=0.2618)
    ap.add_argument("--range-min", type=float, default=0.3)
    ap.add_argument("--range-max", type=float, default=130.0)
    ap.add_argument("--keep", choices=("nearest", "last"), default="nearest",
                    help="per-bin policy ('last' reproduces the reference exactly)")
    ap.add_argument("--skip", type=int, default=1, help="o1dn decimation stride")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from rmcl_tpu_torch.io import msgs
    from rmcl_tpu_torch.io.conversions import pointcloud_to_o1dn, pointcloud_to_scan
    from rmcl_tpu_torch.io.replay import MessageLog

    # the conversions are host-side; --device holds the odometry records
    log = MessageLog.load(args.log, device=args.device)
    out = MessageLog()
    phi_inc = (
        (args.phi_max - args.phi_min) / max(args.height - 1, 1)
        if args.height > 1
        else 0.0
    )
    info = msgs.ScanInfo(
        phi_n=args.height, theta_n=args.width,
        phi_min=args.phi_min, phi_inc=phi_inc,
        theta_min=-np.pi, theta_inc=2 * np.pi / args.width,
        range_min=args.range_min, range_max=args.range_max,
    )
    n_conv = 0
    o1dn_arrays = {}
    for rec in log:
        if rec.kind != "cloud":
            out.add(rec.stamp, rec.kind, rec.channel, rec.payload)
            continue
        cloud = msgs.PointCloud2(
            header=msgs.Header(stamp=rec.stamp),
            points=np.asarray(rec.payload["points"]),
        )
        if args.to == "scan":
            scan = pointcloud_to_scan(cloud, info, keep=args.keep)
            out.add(rec.stamp, "scan", rec.channel, scan)
        else:
            o = pointcloud_to_o1dn(cloud, width_skip=args.skip)
            i = n_conv
            o1dn_arrays[f"s{i}_stamp"] = np.float64(rec.stamp)
            o1dn_arrays[f"s{i}_dirs"] = o.info.dirs
            o1dn_arrays[f"s{i}_ranges"] = o.data.ranges
            o1dn_arrays[f"s{i}_mask"] = np.asarray(o.data.mask)
        n_conv += 1

    if args.to == "scan":
        out.save(args.out)
    else:
        np.savez_compressed(args.out, n_scans=n_conv, **o1dn_arrays)
    print(f"converted {n_conv} cloud records -> {args.to}; wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
