"""``chip_smoke.py``'s phase 15 (the sharded paths on ranks that share the
card) on its own, with the maps it takes from earlier phases built here.

    python -m scripts.torch_phase15_probe

On the card, from the repo root: phases 1 and 2 (the card's name and
power limit, the kernels' build), the ~1M-face sphere's bins and BVH
(phases 5 and 9) and its bins with hypers at phase 14a's audited budgets
(192/512/160, ``PERF.md`` §4), then phase 15 with all its checks. Prints
phase 15's JSON line; exits nonzero where a check fails.
"""

import json
import time

import torch

import chip_smoke as cs

BUDGETS_14A = (192, 512, 160)


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = cs.phase_device()
    cs.phase_build()
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.mesh import make_sphere

    t0 = time.perf_counter()
    mesh = make_sphere(cs.SPHERE_LAT_LON, cs.SPHERE_LAT_LON, radius=50.0)
    bins = build_bins(mesh, bin_size=64)
    bvh = build_bvh(mesh)
    hyper = build_bins(mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16)
    torch.cuda.synchronize()
    cs.log(f"sphere maps built in {time.perf_counter() - t0:.2f} s")
    r15 = cs.phase_multi_device(mesh, bins, bvh, dict(bins=hyper, budgets=BUDGETS_14A))
    cs.log(json.dumps(r15))
    cs.log(f"card: {smi}")


if __name__ == "__main__":
    main()
