#!/usr/bin/env python3
"""The MCL budget audit, JAX package and PyTorch port side by side on the
CPU, at ``chip_smoke.py`` phase 11's geometry: the 4 x 3-room building
(subdiv 45, doors at mid-wall) in bins of 64, 16 a super, 16 supers a
hyper; one VLP-16 scan (900 wide) at the truth (3, 3, 1.2); clouds of 4,096
particles from N(truth, diag(0.04, 0.04, 0.01, 1e-4, 1e-4, 3e-3)); the
sensor update's beam-major rays at c_super 48, c_bin 288, c_hyper 8, 128-ray
blocks of 8 sub-blocks (``probe_update_rays``).

For each draw seed (the cloud and the 100 beams), both packages'
``block_cull_stats`` run on the same rays and bins (the JAX bins carried
across). One JSON line a seed: each package's saturated-block fraction and
largest count, and the blocks whose flag or count differ. Run from the
repo root (~1 minute):

    python -m scripts.torch_mcl_audit_probe
"""

import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_building_scene  # noqa: E402
from rmcl_tpu.ops.raycast_binned import block_cull_stats as j_stats  # noqa: E402
from rmcl_tpu_torch.bvh.builder import build_bvh  # noqa: E402
from rmcl_tpu_torch.convert import bins_from_arrays  # noqa: E402
from rmcl_tpu_torch.geom import mesh as tmesh  # noqa: E402
from rmcl_tpu_torch.math.se3 import Transform  # noqa: E402
from rmcl_tpu_torch.math.stats import sample_pose_gaussian  # noqa: E402
from rmcl_tpu_torch.mcl.particles import ParticleCloud  # noqa: E402
from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig, probe_update_rays  # noqa: E402
from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats as t_stats  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel  # noqa: E402
from rmcl_tpu_torch.sensors.simulate import simulate  # noqa: E402

SCENE = dict(rooms_x=4, rooms_y=3, subdiv=45, seed=0, door_t=0.5)
TRUTH = [3.0, 3.0, 1.2, 0.0, 0.0, 0.0]
COV = [0.04, 0.04, 0.01, 1e-4, 1e-4, 3e-3]
N_PARTICLES = 4096
SEEDS = (0, 1, 2)
CULL = dict(block_size=128, c_super=48, c_bin=288, sub_blocks=8, c_hyper=8)


def main():
    torch.set_num_threads(8)
    jb = build_bins(make_building_scene(**SCENE), bin_size=64, bins_per_super=16,
                    supers_per_hyper=16)
    fields = ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb", "hyper_aabb")
    tb = bins_from_arrays({f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
                           for f in fields}, bins_per_super=jb.bins_per_super,
                          bins_per_mid=jb.bins_per_mid, supers_per_hyper=jb.supers_per_hyper,
                          device="cpu")
    mesh = tmesh.make_building_scene(**SCENE)
    model = SphericalModel.vlp16(width=900)
    truth = Transform.from_pose_tuple(TRUTH, device="cpu")
    hits = simulate(build_bvh(mesh, device="cpu"), model, truth)
    points = model.polar_to_cartesian(torch.where(hits.hit, hits.t, 0.0))
    cfg = SensorUpdateConfig.create(samples=100, engine="binned", layout="beam",
                                    range_max=30.0, dist_sigma=0.4, **CULL)
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        poses = sample_pose_gaussian(gen, truth, torch.diag(torch.tensor(COV)), N_PARTICLES)
        cloud = ParticleCloud.create(N_PARTICLES, device="cpu").with_poses(poses)
        o, d, t = probe_update_rays(cloud, gen, points, hits.hit, Transform.identity(device="cpu"),
                                    cfg)
        tc, ts = (x.numpy() for x in t_stats(tb, o, d, t_max=t, **CULL))
        jc, js = (np.asarray(x) for x in j_stats(jb, jnp.asarray(o.numpy()),
                                                  jnp.asarray(d.numpy()),
                                                  t_max=jnp.asarray(t.numpy()), **CULL))
        print(json.dumps(dict(seed=seed, blocks=int(tc.shape[0]),
                              port_saturated=float(ts.mean()), port_max=int(tc.max()),
                              jax_saturated=float(js.mean()), jax_max=int(jc.max()),
                              sat_differ=int((ts != js).sum()),
                              count_differ=int((tc != jc).sum()))), flush=True)


if __name__ == "__main__":
    main()
