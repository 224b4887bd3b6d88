#!/usr/bin/env python3
"""MICP-L on the exact engine and with closest-point correspondences, JAX
package and PyTorch port side by side on the CPU, at the geometry of
``chip_smoke.py``'s phase 8:

- map: ``make_building_scene(subdiv=45)`` (486,544 faces) with ``MeshMap``'s
  bins (64, 64 bins per super; the JAX package held to the numpy kd order
  the port copies) and the LBVH, both carried across to the port;
- dataset: one VLP-16 scan simulated by the JAX package on the bins at the
  true pose (9, 3, 1.5, yaw 0.3) at the default budgets, as phase 4 makes
  it;
- ten ``correct_once`` from (9, 3, 1.7, yaw 0.35) with the default
  ``MICPConfig`` and ``max_dist=2.0``, for each of: closest-point
  correspondences on the bins, ray-cast ones on the BVH, closest-point ones
  on the BVH.

Prints one JSON line per variant with each package's translation error
after every correction, and one for the hit fractions at the true pose: the
exact engine (K5's path), the dense engine at the default budgets and with
no budget. ``chip_smoke.py`` holds the card to the JAX figures. Run from the
repo root (~3 minutes):

    python -m scripts.torch_exact_probe
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import rmcl_tpu.bvh.native  # noqa: E402
from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.bvh.builder import build_bvh  # noqa: E402
from rmcl_tpu.geom.mesh import make_building_scene  # noqa: E402
from rmcl_tpu.math.se3 import Transform as JTransform  # noqa: E402
from rmcl_tpu.micp import pipeline as jp  # noqa: E402
from rmcl_tpu.ops.raycast import cast_rays as j_cast_rays  # noqa: E402
from rmcl_tpu.ops.raycast_binned import cast_rays_binned as j_cast_binned  # noqa: E402
from rmcl_tpu.sensors.models import SphericalModel as JSpherical  # noqa: E402
from rmcl_tpu.sensors.simulate import simulate as j_simulate  # noqa: E402
from rmcl_tpu_torch.convert import bins_from_arrays, bvh_from_arrays  # noqa: E402
from rmcl_tpu_torch.math.se3 import Transform as TTransform  # noqa: E402
from rmcl_tpu_torch.micp import pipeline as tp  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel as TSpherical  # noqa: E402

TRUE_POSE = [9.0, 3.0, 1.5, 0.0, 0.0, 0.3]
START_POSE = [9.0, 3.0, 1.7, 0.0, 0.0, 0.35]
N_CORRECTIONS = 10
MAX_DIST = 2.0
VARIANTS = (("bins", "CP"), ("bvh", "RC"), ("bvh", "CP"))


def _numpy_order_only(*_args, **_kwargs):
    raise RuntimeError("native bin order disabled: use the numpy kd order the port copies")


def main():
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    rmcl_tpu.bvh.native.bin_order = _numpy_order_only
    mesh = make_building_scene(subdiv=45)
    jbins = build_bins(mesh, bin_size=64, bins_per_super=64, supers_per_hyper=8)
    jbvh = build_bvh(mesh)
    tbins = bins_from_arrays(
        {f: None if getattr(jbins, f) is None else np.asarray(getattr(jbins, f))
         for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max", "mid_aabb",
                   "hyper_aabb")},
        bins_per_super=jbins.bins_per_super, bins_per_mid=jbins.bins_per_mid,
        supers_per_hyper=jbins.supers_per_hyper, device="cpu")
    tbvh = bvh_from_arrays({f: np.asarray(getattr(jbvh, f)) for f in
                            ("nodes", "root_link", "aabb_min", "aabb_max", "n_tris")},
                           device="cpu")
    print(f"building: {mesh.n_faces} faces, {tbins.n_bins} bins, {tbvh.n_slots} BVH slots, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    jmodel, tmodel = JSpherical.vlp16(), TSpherical.vlp16()
    true_j = JTransform.from_pose_tuple(jnp.asarray(TRUE_POSE))
    hits = j_simulate(jbins, jmodel, true_j)
    points, mask = np.array(hits.point), np.array(hits.hit)

    # hit fractions at the true pose: exact vs dense, budgeted and not
    o_s, d_s = jmodel.rays()
    o, d = true_j.apply(o_s), true_j.rotate(d_s)
    lim = dict(t_min=jmodel.range.min, t_max=jmodel.range.max)
    exact = j_cast_rays(jbvh, o, d, **lim)
    dense = j_cast_binned(jbins, o, d, **lim)
    free = j_cast_binned(jbins, o, d, c_super=jbins.n_super,
                         c_bin=jbins.n_super * jbins.bins_per_super, **lim)
    print(json.dumps({"hits_at_true_pose": {
        "exact": float(jnp.mean(exact.hit)), "dense_default_budgets": float(jnp.mean(dense.hit)),
        "dense_unbudgeted": float(jnp.mean(free.hit)),
        "exact_vs_unbudgeted_disagree": int(jnp.sum(exact.hit != free.hit))}}), flush=True)

    maps = {"bins": (jbins, tbins), "bvh": (jbvh, tbvh)}
    for engine, corr in VARIANTS:
        t0 = time.perf_counter()
        jmap, tmap = maps[engine]
        cfg = dict(max_dist=MAX_DIST, corr_type=corr)
        js = jp.MICPSensorData(model=jmodel, points=jnp.asarray(points), mask=jnp.asarray(mask),
                               tsb=JTransform.identity(), config=jp.MICPSensorConfig.create(**cfg))
        ts = tp.MICPSensorData(model=tmodel, points=torch.from_numpy(points),
                               mask=torch.from_numpy(mask), tsb=TTransform.identity(device="cpu"),
                               config=tp.MICPSensorConfig.create(**cfg))
        j_tom = JTransform.from_pose_tuple(jnp.asarray(START_POSE))
        t_tom = TTransform.from_pose_tuple(START_POSE, device="cpu")
        j_prog, t_prog = jnp.float32(0.0), torch.tensor(0.0)
        errs = {"jax": [], "port": []}
        for _ in range(N_CORRECTIONS):
            j_tom, j_st = jp.correct_once(jmap, [js], j_tom, JTransform.identity(), j_prog,
                                          jp.MICPConfig())
            t_tom, t_st = tp.correct_once(tmap, [ts], t_tom, TTransform.identity(device="cpu"),
                                          t_prog, tp.MICPConfig())
            j_prog, t_prog = j_st.convergence_progress, t_st.convergence_progress
            errs["jax"].append(float(np.linalg.norm(np.asarray(j_tom.trans) - TRUE_POSE[:3])))
            errs["port"].append(float(np.linalg.norm(t_tom.trans.numpy() - TRUE_POSE[:3])))
        print(json.dumps({"engine": engine, "corr_type": corr, "final_err": {
            k: v[-1] for k, v in errs.items()}, "err_by_correction": errs,
            "matches": {"jax": float(j_st.valid_matches), "port": float(t_st.valid_matches)},
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
