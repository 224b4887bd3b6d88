#!/usr/bin/env python3
"""Rays that the dense binned engine decides apart from the exact engine at
budgets where no block saturates, JAX package and PyTorch port side by side
on the CPU.

Phase 4's building (``make_building_scene(subdiv=45)``, bins of 64 in
supers of 64, both packages' default order), VLP-16 scans from the first
poses of ``chip_smoke.py`` phase 14b (uniform over the floor at 1.5 m with
a yaw, seed 14), 128-ray blocks at c_super 3,072 and c_bin 12,288 (phase
14b's audited budgets; no block saturates). One JSON line a pose: per
package the rays whose hit or winner differs from the exact engine's
(``cast_rays`` on the BVH) beyond a near-tie, whether the packages' sets
coincide, and for the port's how many exact winners' bins the cull left
out of the ray's block list. Run from the repo root (~2 minutes):

    python -m scripts.torch_flat_bin_probe
"""

import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_building_scene  # noqa: E402
from rmcl_tpu.ops import raycast_binned as jrb  # noqa: E402
from rmcl_tpu_torch.bvh.bins import build_bins as t_build_bins  # noqa: E402
from rmcl_tpu_torch.bvh.builder import build_bvh  # noqa: E402
from rmcl_tpu_torch.math.se3 import Transform  # noqa: E402
from rmcl_tpu_torch.ops import raycast_binned as trb  # noqa: E402
from rmcl_tpu_torch.ops.raycast import cast_rays  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel  # noqa: E402

POSES = 3
BUDGETS = dict(c_super=3072, c_bin=12288)
FLOOR = (24.0, 18.0)


def main():
    mesh = make_building_scene(subdiv=45)
    jb = build_bins(mesh, bin_size=64, bins_per_super=64)
    tb = t_build_bins(mesh, bin_size=64, bins_per_super=64, device="cpu")
    bvh = build_bvh(mesh, device="cpu")
    model = SphericalModel.vlp16()
    lim = dict(t_min=model.range.min, t_max=model.range.max)
    rng = np.random.default_rng(14)
    pose = np.zeros((100, 6), np.float32)
    pose[:, :2] = rng.uniform((0.0, 0.0), FLOOR, (100, 2))
    pose[:, 2] = 1.5
    pose[:, 5] = rng.uniform(-np.pi, np.pi, 100)
    o_s, d_s = model.rays("cpu")
    # the bin of each face, from the packed prim ids (-1: padding)
    prim = tb.tri[:, 12, :].reshape(-1).long()
    face_bin = torch.full((mesh.n_faces,), -1, dtype=torch.long)
    face_bin[prim[prim >= 0]] = torch.nonzero(prim >= 0).squeeze(1) // tb.bin_size
    print(json.dumps({"faces": mesh.n_faces,
                      "bins_bitwise": bool(np.array_equal(np.asarray(jb.tri), tb.tri.numpy()))}),
          flush=True)
    for p in range(POSES):
        tsm = Transform.from_pose_tuple(torch.from_numpy(pose[p]), device="cpu")
        o, d = tsm.apply(o_s).contiguous(), tsm.rotate(d_s).contiguous()
        ex = cast_rays(bvh, o, d, **lim)
        th = trb.cast_rays_binned(tb, o, d, block_size=128, **BUDGETS, **lim)
        jh = jrb.cast_rays_binned(jb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                  block_size=128, **BUDGETS, **lim)

        def apart(hit, t, prim_id):
            both = hit & ex.hit.numpy()
            rel = np.abs(t - ex.t.numpy()) / np.abs(ex.t.numpy())
            other = both & (prim_id != ex.prim_id.numpy()) & (rel > 1e-4)
            return (hit != ex.hit.numpy()) | other

        a_t = apart(th.hit.numpy(), th.t.numpy(), th.prim_id.numpy())
        a_j = apart(np.asarray(jh.hit), np.asarray(jh.t), np.asarray(jh.prim_id))
        n = o.shape[0]
        inputs, sat = trb._kernel_inputs(tb, o, d, torch.full((n,), model.range.min),
                                         torch.full((n,), model.range.max), 128,
                                         BUDGETS["c_super"], BUDGETS["c_bin"], 4)
        rays = torch.from_numpy(np.nonzero(a_t & ex.hit.numpy())[0])
        blk = rays // 128
        want = face_bin[ex.prim_id[rays].long()]
        slot = torch.arange(inputs[4].shape[1])
        listed = ((inputs[4][blk] == want[:, None]) & (slot < inputs[5][blk][:, None])).any(1)
        print(json.dumps({"pose": p, "rays": n, "saturated_blocks": int(sat.sum()),
                          "port_apart": int(a_t.sum()), "jax_apart": int(a_j.sum()),
                          "same_rays": bool(np.array_equal(a_t, a_j)),
                          "port_winner_bin_left_out": int((~listed).sum())}), flush=True)


if __name__ == "__main__":
    main()
