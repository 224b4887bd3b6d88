"""Does ``torch.profiler``'s device trace keep seeing the port's kernels
through a long run, and K2g's and K1's device times at ``chip_smoke.py``
phase 13's inputs by that trace, in a process of their own.

    python -m scripts.torch_trace_probe [--sessions N]

On the card, from the repo root (the card's name and power limit first):

1. a canary: K1 (``intersect_bins``) on a small sphere's cast, traced in
   ``--sessions`` profiler sessions in a row (``chip_smoke.device_ms``'s
   recipe), counting the sessions whose trace holds all its launches;
2. phase 13's inputs: the bench's sweep rays at full width, materialised at
   the truth + 0.2 m in z, through the library's dense cast, which records
   the K3 lists and launch order it hands K2g (``chip_smoke.dense_cast``);
   K2g and K1 on them by the device trace and by CUDA events;
3. phase 12 (the node and the tools, ``chip_smoke.phase_node_and_tools``),
   with the canary traced before it and after each of its command-line runs;
4. after it, the canary in sessions that the host's sleep opens and closes
   (``PADS`` seconds), and in sessions that it does not.

Prints one JSON line per step: for each traced session, how many of the
kernel's launches its trace holds, read through ``key_averages()`` and
through the raw device events, and their mean time.
"""

import argparse
import json
import time

import torch

import chip_smoke as cs

REPS = 5
PADS = (0.0, 0.05, 0.5)
PAD_SESSIONS = 10


def traced(fn, kernel, reps=REPS, pad_s=0.0):
    """The device trace of reps calls of fn after one warm-up, in one fresh
    profiler session (``pad_s`` seconds of the host's sleep open and close
    it), read two ways: ``key_averages()`` (``chip_smoke.device_ms``'s
    reading) and the profiler's raw device events. For each, the mean ms of
    the launches of the kernels whose name holds ``kernel`` (None where it
    holds none) and how many it holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                for e in events)
    count = sum(e.count for e in events)
    raw = [e.duration_ns() for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA and kernel in e.name()]
    return dict(ms=total / 1e3 / count if count and total else None, held=count,
                raw_ms=sum(raw) / 1e6 / len(raw) if raw else None, raw_held=len(raw))


def canary():
    """A K1 launch on a small sphere's cast (the sphere's centre, VLP-16)."""
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.mesh import make_sphere
    from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _kernel_inputs
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins

    bins = build_bins(make_sphere(60, 60, radius=50.0), bin_size=64)
    o, d, _ = cs.vlp16_rays([0.0, 0.0, 0.0])
    o, d, t_min, t_max, _ = _flat_rays(o, d, 0.0, 3.0e38)
    inputs, _ = _kernel_inputs(bins, o, d, t_min, t_max, 128, 24, 96, 4)
    return lambda: intersect_bins(bins.tri, *inputs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=120)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe traces the port's kernels on the card")
    smi = cs.phase_device()
    cs.phase_build()
    launch = canary()
    hits = [traced(launch, "intersect_bins")["held"] == REPS for _ in range(args.sessions)]
    print(json.dumps({"step": "canary", "device": smi, "torch": torch.__version__,
                      "sessions": args.sessions,
                      "sessions_with_launches": sum(hits),
                      "first_without": hits.index(False) if False in hits else None}), flush=True)

    from rmcl_tpu_torch.bench import SweepBench, settings_from_env
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_groups

    cfg, _ = settings_from_env({})
    bench = SweepBench(**cfg, device="cuda")
    est = bench.trans_true + torch.tensor([0.0, 0.0, 0.2], device="cuda")
    (args, kw), = cs.dense_cast(bench.bins, bench.sweep, bench.sweep.rays(est, bench.dirs))[1]
    inputs, order, G = args[1:-1], kw["order"], args[-1]
    out = {"step": "phase 13 inputs", "blocks": int(inputs[0].shape[0]), "groups": G}
    for name, kernel, fn in (
            ("K2g", "intersect_groups",
             lambda: intersect_groups(bench.bins.tri, *inputs, G, order=order)),
            ("K1", "intersect_bins", lambda: intersect_bins(bench.bins.tri, *inputs, order=order))):
        out[name] = dict(traced(fn, kernel), events_ms=cs.cuda_ms(fn))
    out["canary_after"] = traced(launch, "intersect_bins")
    print(json.dumps(out), flush=True)
    del bench, inputs, order

    # phase 12, with the canary traced before it and after each of its CLI runs
    canaries, run_cli = [("before", traced(launch, "intersect_bins"))], cs.run_cli

    def run_and_trace(label, *a):
        out = run_cli(label, *a)
        canaries.append((label, traced(launch, "intersect_bins")))
        return out

    cs.run_cli = run_and_trace
    try:
        r12 = cs.phase_node_and_tools()
    finally:
        cs.run_cli = run_cli
    print(json.dumps({"step": "phase 12", "canary": canaries,
                      "k7_timed_by": r12["k7"]["timed_by"],
                      "k6b_ms": r12["runs"]["cp"].get("k6b_ms")}), flush=True)

    # after phase 12: how many of the canary's launches the trace holds,
    # with the session opened and closed by the host's sleep or not
    held = {}
    for pad_s in PADS:
        runs = [traced(launch, "intersect_bins", pad_s=pad_s) for _ in range(PAD_SESSIONS)]
        held[str(pad_s)] = {k: [r[k] for r in runs] for k in ("held", "raw_held")}
    print(json.dumps({"step": "padded sessions", "reps": REPS, "held_by_pad_s": held}),
          flush=True)


if __name__ == "__main__":
    main()
