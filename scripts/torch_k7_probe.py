#!/usr/bin/env python3
"""K7, the closest-point candidate cull (``rmcl_tpu_torch/csrc/cull_boxes.cu``),
timed on the card on the query blocks of ``chip_smoke.py``'s phases:

- phase 8: phase 4's building (bins of 64, 119 supers of 64), the exact
  engine's VLP-16 scan at phase 4's true pose, its points in the map frame
  at that pose (where the phase's CP-on-bins corrections converge): 113
  blocks of 128 at cs 24, cb 96, max_dist 2 m;
- wide: the same blocks on the building binned at 16 faces a bin, 476
  supers of 64 at cs 300, cb 4,000 (a level of 19,200 keys, which the
  parent's K7 refuses);
- phase 12: the CP run of the MICP-L CLI on phase 12's log, its last K7
  launch's blocks recorded through the wrapper as ``chip_smoke.py`` records
  them (cs and cb as the node's budget audit adopted them);
- phase 9: the ~1M-face sphere's bins (244 supers of 64), phase 5's 14.4M
  rays' hit points moved by N(0, 0.05 m), in cluster order: 112,500 blocks
  at the budgets the blocks need (cs 40, cb 835).

With ``--parent DIR`` it also builds the K7 of an older checkout from
``DIR/rmcl_tpu_torch/csrc`` (whose entry takes a power-of-two key capacity
for the widest level) and times it on the same inputs; the two must be
bitwise equal (lists, counts, bounds). Each case prints one JSON line: the
card, milliseconds a launch (CUDA events around ``inner`` launches back to
back, the kernels and an empty kernel at the same grid timed in turn,
median of the rounds; a launch shorter than the host's call is timed by
the host there) and each kernel's mean device time by the profiler's
trace (``chip_smoke.device_ms``), the bound
(``chip_smoke.cp_candidates_bound``), the launch plan (threads a CTA,
dynamic shared bytes) and the mean list length.
Needs one card; run from the repo root (~3 minutes):

    python -m scripts.torch_k7_probe [--parent build/parent]
"""

import argparse
import contextlib
import ctypes
import io
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.geom.mesh import make_building_scene, make_sphere, save_obj
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops import closest_cuda, closest_point
from rmcl_tpu_torch.ops.closest_point import _max_d2, binned_inputs
from rmcl_tpu_torch.ops.order import cluster_order
from rmcl_tpu_torch.ops.raycast import cast_rays
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate
from rmcl_tpu_torch.tools import micp_localization
from scripts.torch_k5_probe import interleaved_ms

OUT_DIR = _build.BUILD_DIR.parent / "k7_probe"


class ParentBoxArgs(ctypes.Structure):
    """The older entry's struct: a key capacity (a power of two at least
    the widest level) where this one has the CTA width and key slots."""
    _fields_ = closest_cuda._BoxArgs._fields_[:-2] + [("key_cap", ctypes.c_int)]


def build(src_dir=_build.CSRC, tag="as built"):
    """csrc/cull_boxes.cu from ``src_dir``, compiled with the port's
    flags; returns the loaded library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / ("".join(c if c.isalnum() else "_" for c in tag) + ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(Path(src_dir) / "cull_boxes.cu")], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    # an entry that takes the launch plan (CTA width, key slots), or the
    # older one that sizes its keys by the widest level
    lib.planned = "int key_slots;" in (Path(src_dir) / "cull_boxes.cu").read_text()
    return lib


def launcher(lib, bins, qb, d2b, cs, cb, parent=False):
    """A function that launches ``lib``'s K7 on these blocks into fixed
    outputs and returns them; None where an older parent refuses the shape
    (its widest level past its shared memory)."""
    fn = lib.rmcl_cull_boxes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_blk, Rq = qb.shape[:2]
    S, n_super, n_bins = bins.bins_per_super, bins.n_super, bins.n_bins
    id_bits = max(1, (n_bins - 1).bit_length())
    packed = id_bits <= closest_point._PACKED_ID_BITS
    if parent and not lib.planned:
        key_cap = 1 << (max(n_super, cs * S, 32) - 1).bit_length()
        if key_cap * 8 + cs * 4 > closest_cuda._SMEM_CAP:
            return None
        tail, struct = (key_cap,), ParentBoxArgs
    else:
        tail = closest_cuda.cp_launch_plan(n_blk, n_super, S, cs, cb,
                                           closest_cuda.fill_threads(qb.device))[:2]
        struct = closest_cuda._BoxArgs
    out = (torch.empty((n_blk, cb), dtype=torch.int32, device="cuda"),
           torch.empty((n_blk,), dtype=torch.int32, device="cuda"),
           torch.empty((n_blk, cb), dtype=torch.float32, device="cuda"))
    args = struct(qb.data_ptr(), d2b.data_ptr(), bins.super_aabb.data_ptr(),
                  bins.bin_aabb.data_ptr(), *(x.data_ptr() for x in out), n_blk, Rq, n_super,
                  n_bins, S, cs, cb, (1 << id_bits) - 1 if packed else 0, int(packed), *tail)

    def launch():
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K7 launch failed: cudaError {err}")
        return out

    return launch


def probe(name, lib, parent, card, bins, qb, d2b, cs, cb, reps=25, inner=20):
    n_blk = qb.shape[0]
    threads, _, smem = closest_cuda.cp_launch_plan(n_blk, bins.n_super, bins.bins_per_super, cs,
                                                   cb, closest_cuda.fill_threads(qb.device))
    k7 = launcher(lib, bins, qb, d2b, cs, cb)
    want = [x.clone() for x in k7()]
    plain = closest_point._cp_candidates(bins, qb, torch.amax(d2b, dim=1), cs, cb)
    if not all(torch.equal(a, b) for a, b in zip(want, plain)):
        raise SystemExit(f"{name}: K7 differs from its plain version")
    floor = lib.rmcl_launch_floor
    floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"K7": k7, "empty launch": lambda: floor(n_blk, threads, stream)}
    old = parent and launcher(parent, bins, qb, d2b, cs, cb, parent=True)
    if old:
        if not all(torch.equal(a, b) for a, b in zip(old(), want)):
            raise SystemExit(f"{name}: the parent's K7 differs from this one")
        shapes["parent"] = old
    ms = interleaved_ms(shapes, reps, inner)
    trace = {k: chip_smoke.device_ms(f, "cull_boxes_kernel") for k, f in shapes.items()
             if k != "empty launch"}
    bound_ms, bound_by, tests = chip_smoke.cp_candidates_bound(bins, qb, d2b, cs, cb)
    print(json.dumps({"case": name, "kernel": "K7", "card": card, "blocks": n_blk,
                      "n_super": bins.n_super, "S": bins.bins_per_super, "cs": cs, "cb": cb,
                      "threads": threads, "shared_bytes": smem, "ms": ms, "trace_ms": trace,
                      "parent": "refuses the shape" if parent and not old else None,
                      "bitwise_parent": bool(old) or None, "bound_ms": bound_ms,
                      "bound_by": bound_by, "box_box_tests": tests,
                      "mean_count": float(want[1].float().mean())}), flush=True)


def phase12_blocks(mesh, bvh):
    """The CP run of phase 12's CLI drive; returns the last K7 launch's
    (bins, qb, d2b, cs, cb) as the wrapper received them."""
    model = SphericalModel.vlp16()
    truth, full, _ = chip_smoke.node_log(model, bvh)
    paths = {k: str(OUT_DIR / f) for k, f in (("map", "building.obj"), ("log", "run.npz"),
                                              ("cfg", "cp.yaml"), ("out", "track_cp.npz"))}
    save_obj(mesh, paths["map"])
    full.save(paths["log"])
    with open(paths["cfg"], "w") as f:
        f.write("sensors:\n  lidar:\n    correspondences:\n      type: CP\n")
    recorded, wrapper = {}, closest_point.cp_candidates

    def recording(*a):
        recorded["args"] = a
        return wrapper(*a)

    closest_point.cp_candidates = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = micp_localization.main([
                "--device", "cuda", "--map", paths["map"], "--log", paths["log"],
                "--steps-per-scan", str(chip_smoke.NODE_STEPS_PER_SCAN), "--out", paths["out"],
                "--initial-pose-guess", *[f"{v:.6f}" for v in truth[0]],
                "--config", paths["cfg"]])
    finally:
        closest_point.cp_candidates = wrapper
    if rc != 0 or "args" not in recorded:
        raise SystemExit(f"phase 12's CP run failed (rc {rc})")
    return recorded["args"][:5]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose K7 to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    lib = build()
    regs, local, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    attrs = lib.rmcl_cull_boxes_attrs
    attrs.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    for threads in (closest_cuda.K7_NARROW, closest_cuda.K7_WIDE):
        if attrs(threads, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(static)):
            raise SystemExit("cudaFuncGetAttributes failed")
        print(json.dumps({"kernel": "K7", "card": card, "threads": threads,
                          "registers": regs.value, "local_bytes": local.value,
                          "static_shared_bytes": static.value}), flush=True)
    parent = None
    if args.parent:
        parent = build(Path(args.parent) / "rmcl_tpu_torch" / "csrc", tag="parent")

    # phase 8 and the wide level: the converged pose's scan in the map frame
    mesh = make_building_scene(subdiv=chip_smoke.BUILDING_SUBDIV)
    bmap = MeshMap.from_mesh(mesh)
    true_pose = Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3])
    hits = simulate(bmap.bvh, SphericalModel.vlp16(), true_pose)
    q = true_pose.apply(hits.point)
    q = q[cluster_order(q, None)[0].long()]
    md = _max_d2(chip_smoke.EXACT_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19)
    qb, d2b = binned_inputs(bmap.bins, q, md)[:2]
    probe("phase 8", lib, parent, card, bmap.bins, qb, d2b, 24, 96)
    S, cs, cb = chip_smoke.K7_WIDE_LEVELS[0]
    wide = build_bins(mesh, bin_size=chip_smoke.K7_WIDE_BIN_SIZE, bins_per_super=S)
    probe("wide level (cs x S = 19,200)", lib, parent, card, wide, qb, d2b, cs, cb)
    del wide

    # phase 12
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    bins, qb, d2b, cs, cb = phase12_blocks(mesh, bmap.bvh)
    probe("phase 12", lib, parent, card, bins, qb, d2b, cs, cb)
    del bmap, bins, qb, d2b

    # phase 9
    lat_lon = chip_smoke.SPHERE_LAT_LON
    sphere_mesh = make_sphere(lat_lon, lat_lon, radius=50.0)
    sphere = build_bins(sphere_mesh, bin_size=64)
    o, d, _ = chip_smoke.reference_scan_rays(SphericalModel.vlp16())
    model = SphericalModel.vlp16()
    hits = cast_rays(build_bvh(sphere_mesh), o, d, t_min=model.range.min, t_max=model.range.max)
    pts = hits.point[hits.hit]
    del o, d, hits
    noise = np.random.default_rng(chip_smoke.QUERY_SEED).normal(0.0, chip_smoke.QUERY_NOISE,
                                                                size=tuple(pts.shape))
    q = (pts + torch.from_numpy(noise.astype(np.float32)).cuda()).contiguous()
    need_s, need_b = chip_smoke.cp_budget_need(sphere, q, chip_smoke.QUERY_MAX_DIST)
    c_super, c_bin = int(need_s.max()), int(need_b.max())
    q = q[cluster_order(q, None)[0].long()]
    md = _max_d2(chip_smoke.QUERY_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19)
    qb, d2b, cand_bin, *_ = binned_inputs(sphere, q, md, c_super=c_super, c_bin=c_bin,
                                          block_chunk=chip_smoke.QUERY_BLOCK_CHUNK)
    probe("phase 9", lib, parent, card, sphere, qb, d2b, min(c_super, sphere.n_super),
          cand_bin.shape[1], reps=9, inner=5)


if __name__ == "__main__":
    main()
