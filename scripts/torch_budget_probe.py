#!/usr/bin/env python3
"""Candidate budgets of the binned cast, JAX package and PyTorch port side
by side on the CPU, at the geometry of ``chip_smoke.py``'s phases:

- building (phase 4): ``make_building_scene(subdiv=45)`` with ``MeshMap``'s
  bins (64, 64 bins per super), one VLP-16 scan at the phase's true pose,
  128-ray blocks, at the default budgets and with no budget at all;
- sphere (phase 5): the ~1M-face sphere (``make_sphere(707, 707,
  radius=50)``, bins of 64), VLP-16 scans from the first 3 of the phase's
  poses (uniform in +-5 m, identity rotations), 128- and 32-ray blocks at
  the default budgets.

Both packages cast on the same bins: the JAX package's, in its default
(native) order, which the port's default takes too, carried across. Each
case prints one JSON line: per package, the blocks whose candidate set a
budget truncated, the mean and largest candidate count, and the hit
fraction of ``cast_rays_binned``; and how many blocks' counts and rays'
hits the two packages disagree on. Run from the repo root (~1 minute):

    python -m scripts.torch_budget_probe
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_building_scene, make_sphere  # noqa: E402
from rmcl_tpu.ops import raycast_binned as jrb  # noqa: E402
from rmcl_tpu_torch.convert import bins_from_arrays  # noqa: E402
from rmcl_tpu_torch.math.se3 import Transform  # noqa: E402
from rmcl_tpu_torch.ops import raycast_binned as trb  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel  # noqa: E402

C_SUPER, C_BIN = 24, 96  # the defaults of cast_rays_binned and MICPConfig
SPHERE_POSES = 3


def _scene(name):
    """(JAX bins, VLP-16 origins and directions (n, 3) as torch tensors)."""
    model = SphericalModel.vlp16()
    o_s, d_s = model.rays("cpu")
    if name == "sphere":
        jb = build_bins(make_sphere(707, 707, radius=50.0), bin_size=64)
        trans = np.random.default_rng(0).uniform(-5, 5, size=(1000, 3)).astype(np.float32)
        o = (torch.from_numpy(trans[:SPHERE_POSES])[:, None] + o_s).reshape(-1, 3)
        d = d_s.repeat(SPHERE_POSES, 1)
    else:  # MeshMap.from_mesh's bins for this map: 64 per bin, 64 per super
        jb = build_bins(make_building_scene(subdiv=45), bin_size=64, bins_per_super=64,
                        supers_per_hyper=8)
        tsm = Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3], device="cpu")
        o, d = tsm.apply(o_s), tsm.rotate(d_s)
    return jb, o.contiguous(), d.contiguous(), model


def probe(name, block_sizes, unbudgeted):
    t0 = time.perf_counter()
    jb, o, d, model = _scene(name)
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    tb = bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                          bins_per_mid=jb.bins_per_mid,
                          supers_per_hyper=jb.supers_per_hyper, device="cpu")
    print(f"{name}: {tb.n_bins} bins of {tb.bin_size}, {tb.n_super} supers of "
          f"{tb.bins_per_super}, built in {time.perf_counter() - t0:.1f} s", flush=True)

    n = o.shape[0]
    t_min, t_max = float(model.range.min), float(model.range.max)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    budgets = [(C_SUPER, C_BIN)]
    if unbudgeted:  # every super and every bin a candidate: nothing truncates
        budgets.append((tb.n_super, tb.n_super * tb.bins_per_super))

    for Rb in block_sizes:
        for cs, cb in budgets:
            t0 = time.perf_counter()
            j_count, j_sat = (np.asarray(x) for x in jrb.block_cull_stats(
                jb, jo, jd, t_min, t_max, block_size=Rb, c_super=cs, c_bin=cb))
            j_hit = np.asarray(jrb.cast_rays_binned(
                jb, jo, jd, t_min, t_max, block_size=Rb, c_super=cs, c_bin=cb).hit)
            inputs, t_sat = trb._kernel_inputs(
                tb, o, d, torch.full((n,), t_min), torch.full((n,), t_max), Rb, cs, cb, 4)
            t_count, t_sat = inputs[5].numpy(), t_sat.numpy()
            t_hit = trb.cast_rays_binned(tb, o, d, t_min, t_max, block_size=Rb, c_super=cs,
                                         c_bin=cb).hit.numpy()
            side = lambda count, sat, hit: dict(
                saturated_blocks=int(sat.sum()), mean_count=float(count.mean()),
                max_count=int(count.max()), hit_frac=float(hit.mean()))
            print(json.dumps(dict(
                scene=name, block_size=Rb, rays=n, blocks=int(t_count.shape[0]),
                c_super=cs, c_bin=cb,
                jax=side(j_count, j_sat, j_hit), torch=side(t_count, t_sat, t_hit),
                count_mismatch_blocks=int((j_count != t_count).sum()),
                sat_mismatch_blocks=int((j_sat != t_sat).sum()),
                hit_mismatch_rays=int((j_hit != t_hit).sum()),
                seconds=round(time.perf_counter() - t0, 1))), flush=True)


def main():
    torch.set_num_threads(4)
    probe("building", [128], unbudgeted=True)
    probe("sphere", [128, 32], unbudgeted=False)


if __name__ == "__main__":
    main()
