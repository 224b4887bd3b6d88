#!/usr/bin/env python3
"""The JAX backward benchmark's candidate budgets, JAX package and PyTorch
port side by side on the CPU.

``scripts/bench_backward.py`` casts 100 poses x VLP-16 (900 columns) from
inside the ~1M-face sphere (``make_sphere(707, 707, radius=50)``, bins of
64 in supers of 16 and hypers of 16) with ``c_super=24, c_bin=64,
c_hyper=20``. For the first poses this probe prints one JSON line each:
per package the hit fraction of ``cast_rays_binned`` at those budgets, the
rays whose hits the two packages disagree on, and the port's audit (every
budget doubled until no 128-ray block saturates) with its hit fraction
there. ``chip_smoke.py`` phase 14a runs both settings on the card. Run
from the repo root (~1 minute):

    python -m scripts.torch_backward_budget_probe
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_sphere  # noqa: E402
from rmcl_tpu.ops import raycast_binned as jrb  # noqa: E402
from rmcl_tpu_torch.bvh.bins import build_bins as t_build_bins  # noqa: E402
from rmcl_tpu_torch.ops import raycast_binned as trb  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel  # noqa: E402

POSES = 2
BUDGETS = dict(c_super=24, c_bin=64, c_hyper=20)


def main():
    t0 = time.perf_counter()
    mesh = make_sphere(707, 707, radius=50.0)
    jb = build_bins(mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16)
    tb = t_build_bins(mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16, device="cpu")
    same_bins = bool(np.array_equal(np.asarray(jb.tri), tb.tri.numpy()))
    model = SphericalModel.vlp16(width=900)
    _, d = model.rays("cpu")
    trans = np.random.default_rng(0).uniform(-5, 5, (100, 3)).astype(np.float32)
    print(json.dumps({"faces": mesh.n_faces, "bins_bitwise": same_bins,
                      "setup_s": round(time.perf_counter() - t0, 1)}), flush=True)
    kw = dict(block_size=128, sort_blocks=True)
    for p in range(POSES):
        o = torch.from_numpy(np.broadcast_to(trans[p], (model.n_rays, 3)).copy())
        jh = jrb.cast_rays_binned(jb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                  dir_groups=0, **kw, **BUDGETS)
        th = trb.cast_rays_binned(tb, o, d, **kw, **BUDGETS)
        cs, cb, ch = BUDGETS["c_super"], BUDGETS["c_bin"], BUDGETS["c_hyper"]
        audit = []
        while True:
            sat = trb.block_cull_stats(tb, o, d, block_size=128, c_super=cs, c_bin=cb,
                                       c_hyper=ch)[1]
            audit.append([cs, cb, ch, int(sat.sum())])
            if not bool(sat.any()):
                break
            cs, cb, ch = 2 * cs, 2 * cb, 2 * ch
        hits = trb.cast_rays_binned(tb, o, d, **kw, c_super=cs, c_bin=cb, c_hyper=ch).hit
        print(json.dumps({
            "pose": p, "rays": model.n_rays,
            "jax_hit_frac": float(np.asarray(jh.hit).mean()),
            "port_hit_frac": float(th.hit.float().mean()),
            "hit_disagree": int((np.asarray(jh.hit) != th.hit.numpy()).sum()),
            "audit_[cs,cb,ch,saturated]": audit,
            "port_hit_frac_audited": float(hits.float().mean())}), flush=True)


if __name__ == "__main__":
    main()
