"""Readings of a cell's numbers over many seeds, for setting its limits:
the program's, and the control's: the plain reference put in the program's
place with TF32 matrix products, the precision below the configurations'
float32 (``reference.se3.TF32``).

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

One JSON line a seed: {"seed", "program": {...}, "tf32": {...}}. The
benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = run.run_cell(args.workload, seed, args.seconds, False, control=True)
        line = {"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()}}
        line["tf32"] = r["control"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
