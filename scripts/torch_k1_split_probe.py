#!/usr/bin/env python3
"""K1's lane split on the card: the candidate-bin intersection kernel
(``rmcl_tpu_torch/csrc/intersect_bins.cu``) timed at every split S (lane
groups that share one ray's triangles) on the inputs of ``chip_smoke.py``'s
phases, with the split ``ops/raycast_cuda.py::lane_split`` picks marked:

- phase 4: one VLP-16 scan at the phase's true pose on the ~480k-face
  building map (``MeshMap`` bins of 64), 113 blocks of 128 rays, budgets
  24 / 96;
- phase 5: 1000 VLP-16 poses (uniform in +-5 m from ``default_rng(0)``,
  identity rotations) in the ~1M-face sphere, 450,000 blocks of 32 rays.

Every split must give the rule's result bitwise (the packed-key min does
not depend on how the triangles are split). Each case prints one JSON line:
the card, milliseconds per split (CUDA events, median of 5 after a
warm-up), the bound of ``chip_smoke.kernel_bound``. Needs one card; run
from the repo root (~1 minute):

    python -m scripts.torch_k1_split_probe
"""

import json
import subprocess

import numpy as np
import torch

import chip_smoke
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.map import MeshMap
from rmcl_tpu_torch.geom.mesh import make_building_scene, make_sphere
from rmcl_tpu_torch.math.se3 import Quaternion, Transform
from rmcl_tpu_torch.ops import raycast_cuda as rc
from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _kernel_inputs
from rmcl_tpu_torch.sensors.models import SphericalModel


def launch(tri, inputs, S):
    """One launch of the kernel's C entry point at split S."""
    n_blk, Rb = inputs[0].shape[:2]
    t_best = torch.empty((n_blk, Rb), dtype=torch.float32, device="cuda")
    ref = torch.empty((n_blk, Rb), dtype=torch.int32, device="cuda")
    err = rc._kernel()(tri.data_ptr(), *(x.data_ptr() for x in inputs), t_best.data_ptr(),
                       ref.data_ptr(), n_blk, Rb, inputs[4].shape[1], tri.shape[2], S,
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch at S={S} failed: cudaError {err}")
    return t_best, ref


def probe(name, tri, inputs, card):
    B, Rb = tri.shape[2], inputs[0].shape[1]
    want = rc.intersect_bins(tri, *inputs)
    ms = {}
    for S in (1, 2, 4, 8):
        if -(-Rb // (32 // S)) * 32 > 1024:
            continue
        got = launch(tri, inputs, S)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"{name}: S={S} differs from the rule's result")
        ms[S] = chip_smoke.cuda_ms(lambda: launch(tri, inputs, S))
    bound_ms, bound_by, visits = chip_smoke.kernel_bound(inputs, want[0], B)
    print(json.dumps({"case": name, "card": card, "blocks": inputs[0].shape[0], "Rb": Rb,
                      "B": B, "rule_S": rc.lane_split(Rb, B), "ms_by_S": ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "visits": visits}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    model = SphericalModel.vlp16()

    bmap = MeshMap.from_mesh(make_building_scene(subdiv=chip_smoke.BUILDING_SUBDIV))
    tsm = Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3])
    o_s, d_s = model.rays("cuda")
    rays = _flat_rays(tsm.apply(o_s), tsm.rotate(d_s), model.range.min, model.range.max)[:4]
    inputs, _ = _kernel_inputs(bmap.bins, *rays, chip_smoke.DEFAULT_BLOCK_SIZE, 24, 96, 4)
    probe("phase 4", bmap.bins.tri, inputs, card)
    del bmap, inputs

    lat_lon = chip_smoke.SPHERE_LAT_LON
    sphere = build_bins(make_sphere(lat_lon, lat_lon, radius=50.0), bin_size=64)
    n = chip_smoke.N_POSES
    trans = np.random.default_rng(0).uniform(-5, 5, size=(n, 3)).astype(np.float32)
    tsm = Transform(rot=Quaternion.identity((n,), "cuda"), trans=torch.from_numpy(trans).cuda())
    tsm = tsm.expand_dims(-1)
    rays = _flat_rays(tsm.apply(o_s), tsm.rotate(d_s), model.range.min, model.range.max)[:4]
    inputs, _ = _kernel_inputs(sphere, *rays, chip_smoke.CAST_BLOCK_SIZE, 24, 96, 4)
    probe("phase 5", sphere.tri, inputs, card)


if __name__ == "__main__":
    main()
