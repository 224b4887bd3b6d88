#!/usr/bin/env python3
"""The closest-point kernels' launch shapes on the card: K6 (the BVH walk,
``rmcl_tpu_torch/csrc/closest_bvh.cu``) at every split P and K6b (the
candidate-bin loop, ``csrc/closest_bins.cu``) at every lane-group count G,
on the inputs of ``chip_smoke.py``'s phases:

- phase 8: the ~480k-face building map (``MeshMap``: bins of 64 and the
  BVH), one VLP-16 scan simulated at the phase's true pose, its 14,400
  points put at the phase's start pose (the first CP correction's
  queries), max_dist 2 m, budgets 24 / 96;
- phase 9: the ~1M-face sphere (BVH, bins of 64), 1000 VLP-16 poses cast
  through ``cast_rays``, the hit points moved by N(0, 0.05 m), max_dist
  0.5 m, budgets raised to what the blocks need.

The choices of ``ops/closest_cuda.py::walk_split`` and ``bins_groups``
are marked. K6b's result must equal the rule's at every G bitwise; K6's
winners at P > 1 are compared with its serial walk's (P = 1): they differ
only at float near-ties (printed: how many, and the largest gap between
the two distances in float32 spacings). Each case prints one
JSON line: the card, milliseconds (CUDA events, median of 5 after a
warm-up) per launch shape, the rule's choice. With ``--parent DIR`` it
also times the two kernels built from ``DIR/rmcl_tpu_torch/csrc`` (an
older checkout) on the same inputs, for a before/after in one run: at the
rule's P and G where its entry points take them, else in their own launch
shape. An older source's variants are measured the same way. Needs one
card; run from the repo root (~2 minutes):

    python -m scripts.torch_cp_split_probe [--parent build/parent]
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.geom.mesh import make_building_scene, make_sphere
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops import closest_cuda as cc
from rmcl_tpu_torch.ops.closest_point import _max_d2, binned_inputs
from rmcl_tpu_torch.ops.order import cluster_order
from rmcl_tpu_torch.ops.raycast import cast_rays
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate

OUT_DIR = _build.BUILD_DIR.parent / "cp_probe"


def build(name, src_dir=_build.CSRC, tag="as built"):
    """csrc/<name>.cu from ``src_dir``, compiled with the port's flags;
    returns the loaded library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / ("".join(c if c.isalnum() else "_" for c in f"{name} {tag}") + ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
                    str(Path(src_dir) / f"{name}.cu")], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(so))


def bvh_fn(lib, with_split=True):
    fn = lib.rmcl_closest_bvh
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (3 if with_split else 2)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bins_fn(lib, with_groups=True):
    fn = lib.rmcl_closest_bins
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (5 if with_groups else 4)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_bvh(fn, bvh, q, max_d2, P=None):
    R = q.shape[0]
    out = (torch.empty(R, device="cuda"), torch.empty((R, 3), device="cuda"),
           torch.empty(R, dtype=torch.int32, device="cuda"),
           torch.empty((R, 2), dtype=torch.int32, device="cuda"))
    shape = (R, bvh.n_slots) if P is None else (R, bvh.n_slots, P)
    err = fn(bvh.nodes.data_ptr(), bvh.root_link.data_ptr(), q.data_ptr(), max_d2.data_ptr(),
             *(x.data_ptr() for x in out), *shape, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6 launch failed at P={P}: cudaError {err}")
    return out


def run_bins(fn, tri, inputs, G=None):
    n_blk, Rq = inputs[0].shape[:2]
    out = (torch.empty((n_blk, Rq), dtype=torch.int32, device="cuda"),
           torch.empty((n_blk, Rq), dtype=torch.int32, device="cuda"))
    shape = (n_blk, Rq, inputs[2].shape[1], tri.shape[2]) + (() if G is None else (G,))
    err = fn(tri.data_ptr(), *(x.data_ptr() for x in inputs), *(x.data_ptr() for x in out),
             *shape, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6b launch failed at G={G}: cudaError {err}")
    return out


def probe_bvh(name, fn, parent, bvh, q, max_d2, card):
    rule = cc.walk_split(q.shape[0], q.device)
    want = run_bvh(fn, bvh, q, max_d2, 1)  # the serial walk
    ms, near_ties, gap_ulps = {}, {}, {}
    for P in cc.WALK_SPLITS:
        got = run_bvh(fn, bvh, q, max_d2, P)
        torch.cuda.synchronize()
        off = got[2] != want[2]
        near_ties[P] = int(off.sum())
        # non-negative floats order like their bits
        dk, ds = (x[off].sqrt().view(torch.int32) for x in (got[0], want[0]))
        gap_ulps[P] = int((dk - ds).abs().max()) if near_ties[P] else 0
        ms[f"P={P}"] = chip_smoke.cuda_ms(lambda: run_bvh(fn, bvh, q, max_d2, P))
    if parent is not None:
        pfn, takes_split = parent
        P = rule if takes_split else None  # a parent older than the split walk is serial
        got = run_bvh(pfn, bvh, q, max_d2, P)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, run_bvh(fn, bvh, q, max_d2, P or 1))):
            raise SystemExit(f"{name}: the parent's K6 differs from this walk at P={P or 1}")
        ms["parent"] = chip_smoke.cuda_ms(lambda: run_bvh(pfn, bvh, q, max_d2, P))
    print(json.dumps({"case": name, "kernel": "K6", "card": card, "queries": q.shape[0],
                      "rule_P": rule, "ms": ms, "winners_off_serial": near_ties,
                      "dist_gap_ulps": gap_ulps, "serial_visits": float(want[3].double().sum())}),
          flush=True)


def probe_bins(name, fn, parent, tri, inputs, card):
    n_blk, Rq = inputs[0].shape[:2]
    B = tri.shape[2]
    rule = cc.bins_groups(n_blk, Rq, B, tri.device)
    want = cc.closest_bins(tri, *inputs)
    ms = {}
    for G in (1, 2, 4, 8):
        got = run_bins(fn, tri, inputs, G)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{name}: K6b at G={G} differs from the rule's result")
        ms[f"G={G}"] = chip_smoke.cuda_ms(lambda: run_bins(fn, tri, inputs, G))
    if parent is not None:
        pfn, takes_groups = parent
        G = rule if takes_groups else None
        got = run_bins(pfn, tri, inputs, G)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{name}: the parent's K6b differs")
        ms["parent"] = chip_smoke.cuda_ms(lambda: run_bins(pfn, tri, inputs, G))
    print(json.dumps({"case": name, "kernel": "K6b", "card": card, "blocks": n_blk, "Rq": Rq,
                      "B": B, "rule_G": rule, "ms": ms}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose csrc kernels to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    bvh_k, bins_k = bvh_fn(build("closest_bvh")), bins_fn(build("closest_bins"))
    parent_bvh = parent_bins = None
    if args.parent:
        src = Path(args.parent) / "rmcl_tpu_torch" / "csrc"
        # entries that take P and G come with an _attrs query; older ones have neither
        lib = build("closest_bvh", src, tag="parent")
        split = hasattr(lib, "rmcl_closest_bvh_attrs")
        parent_bvh = (bvh_fn(lib, with_split=split), split)
        lib = build("closest_bins", src, tag="parent")
        groups = hasattr(lib, "rmcl_closest_bins_attrs")
        parent_bins = (bins_fn(lib, with_groups=groups), groups)
    model = SphericalModel.vlp16()

    # phase 8
    bmap = MeshMap.from_mesh(make_building_scene(subdiv=chip_smoke.BUILDING_SUBDIV))
    hits = simulate(bmap.bins, model, Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3]))
    q = Transform.from_pose_tuple(chip_smoke.EXACT_START).apply(hits.point).contiguous()
    probe_bvh("phase 8", bvh_k, parent_bvh, bmap.bvh, q,
              _max_d2(chip_smoke.EXACT_MAX_DIST, q.shape[:1], "cuda"), card)
    order, _ = cluster_order(q, None)
    inputs = binned_inputs(bmap.bins, q[order.long()],
                           _max_d2(chip_smoke.EXACT_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19))
    probe_bins("phase 8", bins_k, parent_bins, bmap.bins.tri, inputs, card)
    del bmap, inputs

    # phase 9
    lat_lon = chip_smoke.SPHERE_LAT_LON
    mesh = make_sphere(lat_lon, lat_lon, radius=50.0)
    bvh, bins = build_bvh(mesh), build_bins(mesh, bin_size=64)
    o, d, _ = chip_smoke.reference_scan_rays(model)
    hits = cast_rays(bvh, o, d, t_min=model.range.min, t_max=model.range.max)
    pts = hits.point[hits.hit]
    noise = np.random.default_rng(chip_smoke.QUERY_SEED).normal(0.0, chip_smoke.QUERY_NOISE,
                                                                size=tuple(pts.shape))
    q = (pts + torch.from_numpy(noise.astype(np.float32)).cuda()).contiguous()
    probe_bvh("phase 9", bvh_k, parent_bvh, bvh, q,
              _max_d2(chip_smoke.QUERY_MAX_DIST, q.shape[:1], "cuda"), card)
    need_s, need_b = chip_smoke.cp_budget_need(bins, q, chip_smoke.QUERY_MAX_DIST)
    order, _ = cluster_order(q, None)
    inputs = binned_inputs(bins, q[order.long()],
                           _max_d2(chip_smoke.QUERY_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19),
                           c_super=int(need_s.max()), c_bin=int(need_b.max()),
                           block_chunk=chip_smoke.QUERY_BLOCK_CHUNK)
    probe_bins("phase 9", bins_k, parent_bins, bins.tri, inputs, card)


if __name__ == "__main__":
    main()
