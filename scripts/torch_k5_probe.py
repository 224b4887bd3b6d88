#!/usr/bin/env python3
"""K5, the BVH traversal (``rmcl_tpu_torch/csrc/traverse_bvh.cu``), timed on
the card on the rays of ``chip_smoke.py``'s phases:

- phase 8: the ~480k-face building map's BVH, one VLP-16 scan at the
  phase's start pose (the first RC correction's rays);
- phase 9: the ~1M-face sphere's BVH, 1000 VLP-16 poses (14.4M rays);
- phase 10: the building's BVH, MCL's sensor-update cast: 1,048,576
  particles x 100 beams sampled from a scan at phase 4's true pose,
  t_max = range + 12 m, with the beams in sampled and in angular order.

With ``--parent DIR`` it also times the kernel built from
``DIR/rmcl_tpu_torch/csrc`` (an older checkout) on the same rays, which
must equal this one bitwise (t, slot, visits), for a before/after in one
run. Each case prints one JSON line: the card, milliseconds a launch (CUDA
events; the kernels timed in turn, median of 5 rounds after a warm-up, 3
in phase 10; in phase 8 25 rounds of 20 launches back to back, which a
14,400-ray launch needs to be timed on the device rather than by the
host's calls), the hit fraction and the visits. Needs one card; run from
the repo root (~3 minutes):

    python -m scripts.torch_k5_probe [--parent build/parent]
"""

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
from pathlib import Path

import torch

import chip_smoke
from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.geom.mesh import make_building_scene, make_sphere
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate

OUT_DIR = _build.BUILD_DIR.parent / "k5_probe"


def build(src_dir=_build.CSRC, tag="as built"):
    """csrc/traverse_bvh.cu from ``src_dir``, compiled with the port's
    flags; returns the loaded library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / ("".join(c if c.isalnum() else "_" for c in tag) + ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(Path(src_dir) / "traverse_bvh.cu")], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(so))


def entry(lib):
    """The library's entry, ``rmcl_traverse_bvh``."""
    fn = lib.rmcl_traverse_bvh
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run(fn, bvh, rays, out=None):
    """One launch of entry ``fn``; ``out`` (t, slot) preallocated for
    timing, else new outputs with visits."""
    R = rays[0].shape[0]
    if out is None:
        out = (torch.empty(R, device="cuda"), torch.empty(R, dtype=torch.int32, device="cuda"),
               torch.empty((R, 2), dtype=torch.int32, device="cuda"))
    err = fn(bvh.nodes.data_ptr(), bvh.root_link.data_ptr(), *(x.data_ptr() for x in rays),
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr() if len(out) > 2 else 0,
             R, bvh.n_slots, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 launch failed: cudaError {err}")
    return out


def interleaved_ms(shapes, reps, inner):
    """Milliseconds a launch of each shape (name -> launch function): the
    median over ``reps`` rounds that time every shape in turn, each by CUDA
    events around ``inner`` launches back to back (so that a launch shorter
    than the host's call is still timed on the device)."""
    for launch in shapes.values():
        launch()
    times = {k: [] for k in shapes}
    for _ in range(reps):
        for k, launch in shapes.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(inner):
                launch()
            ev[1].record()
            ev[1].synchronize()
            times[k].append(ev[0].elapsed_time(ev[1]) / inner)
    return {k: statistics.median(v) for k, v in times.items()}


def probe(name, fn, parent, bvh, rays, card, reps=5, inner=1):
    R = rays[0].shape[0]
    want = run(fn, bvh, rays)
    if not all(torch.equal(a, b) for a, b in zip(run(fn, bvh, rays), want)):
        raise SystemExit(f"{name}: K5 is not deterministic")
    out = (torch.empty(R, device="cuda"), torch.empty(R, dtype=torch.int32, device="cuda"))
    shapes = {"K5": functools.partial(run, fn, bvh, rays, out=out)}
    if parent is not None:
        if not all(torch.equal(a, b) for a, b in zip(run(parent, bvh, rays), want)):
            raise SystemExit(f"{name}: the parent's K5 differs from this one")
        shapes["parent"] = functools.partial(run, parent, bvh, rays, out=out)
    ms = interleaved_ms(shapes, reps, inner)
    print(json.dumps({"case": name, "kernel": "K5", "card": card, "rays": R, "ms": ms,
                      "hit_frac": float((want[1] >= 0).float().mean()),
                      "visits": float(want[2].double().sum())}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose K5 to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    lib = build()
    regs, local = ctypes.c_int(), ctypes.c_int()
    attrs = lib.rmcl_traverse_bvh_attrs
    attrs.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if attrs(ctypes.byref(regs), ctypes.byref(local)):
        raise SystemExit("cudaFuncGetAttributes failed")
    print(json.dumps({"kernel": "K5", "card": card, "registers": regs.value,
                      "local_bytes": local.value}), flush=True)
    fn = entry(lib)
    parent = None
    if args.parent:
        parent = entry(build(Path(args.parent) / "rmcl_tpu_torch" / "csrc", tag="parent"))
    model = SphericalModel.vlp16()
    o_s, d_s = model.rays("cuda")
    n = o_s.shape[0]
    lim = (torch.full((n,), model.range.min, device="cuda"),
           torch.full((n,), model.range.max, device="cuda"))

    # phase 8
    bmap = MeshMap.from_mesh(make_building_scene(subdiv=chip_smoke.BUILDING_SUBDIV))
    start = Transform.from_pose_tuple(chip_smoke.EXACT_START)
    rays = (start.apply(o_s), start.rotate(d_s), *lim)
    probe("phase 8", fn, parent, bmap.bvh, rays, card, reps=25, inner=20)

    # phase 10, both beam orders
    scan = simulate(bmap.bins, model, Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3]))
    dirs, ranges = chip_smoke.mcl_beams(scan.point, scan.hit)
    for order, perm in (("sampled", None), ("angular", chip_smoke.angular_order(dirs))):
        o, d, t_max = chip_smoke.mcl_rays(dirs if perm is None else dirs[perm],
                                          ranges if perm is None else ranges[perm])
        probe(f"phase 10 {order} order", fn, parent, bmap.bvh,
              (o, d, torch.zeros_like(t_max), t_max), card, reps=3)
        del o, d, t_max
    del bmap, scan

    # phase 9
    lat_lon = chip_smoke.SPHERE_LAT_LON
    bvh = build_bvh(make_sphere(lat_lon, lat_lon, radius=50.0))
    o, d, _ = chip_smoke.reference_scan_rays(model)
    R = o.shape[0]
    probe("phase 9", fn, parent, bvh,
          (o, d, torch.full((R,), model.range.min, device="cuda"),
           torch.full((R,), model.range.max, device="cuda")), card)


if __name__ == "__main__":
    main()
