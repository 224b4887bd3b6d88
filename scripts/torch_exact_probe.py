#!/usr/bin/env python3
"""MICP-L on the exact engine and with closest-point correspondences, JAX
package and PyTorch port side by side on the CPU, at the geometry of
``chip_smoke.py``'s phase 8:

- map: ``make_building_scene(subdiv=45)`` (486,544 faces) with ``MeshMap``'s
  bins (64, 64 bins per super; in the JAX package's default order, the
  native one, which the port's default takes too) and the LBVH, both
  carried across to the port;
- datasets: two VLP-16 scans at the true pose (9, 3, 1.5, yaw 0.3). The
  exact scan, simulated by the JAX package on the BVH (the exact engine,
  what the sensor measures), as phase 8 makes it; both packages localise
  against it. And phase 4's budgeted scan, simulated on the bins at the
  default budgets, each package by its own cast as the card's phase 4 makes
  it (so the port's scan is the port's). The budgets truncate blocks and
  drop 10.3% of its rays, and with the native order's bins the rest leave
  the correction ill-conditioned: on it the corrections wander 0.02-0.56 m
  and do not settle;
- ten ``correct_once`` from (9, 3, 1.7, yaw 0.35) with the default
  ``MICPConfig`` and ``max_dist=2.0``, for each of: closest-point
  correspondences on the bins, ray-cast ones on the BVH, closest-point ones
  on the BVH.

Prints one JSON line per scan and variant with each package's translation
error and translation after every correction, and one for the hit fractions
at the true pose: the exact engine (K5's path), the dense engine at the
default budgets and with no budget, and how far the port's budgeted scan is
from JAX's. ``chip_smoke.py`` holds the card to the JAX figures. Run from the
repo root (~6 minutes):

    python -m scripts.torch_exact_probe
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

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
from rmcl_tpu_torch.sensors.simulate import simulate as t_simulate  # noqa: E402

TRUE_POSE = [9.0, 3.0, 1.5, 0.0, 0.0, 0.3]
START_POSE = [9.0, 3.0, 1.7, 0.0, 0.0, 0.35]
N_CORRECTIONS = 10
MAX_DIST = 2.0
VARIANTS = (("bins", "CP"), ("bvh", "RC"), ("bvh", "CP"))


def main():
    torch.set_num_threads(4)
    t0 = time.perf_counter()
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
    exact_hits = j_simulate(jbvh, jmodel, true_j)
    exact_scan = (np.array(exact_hits.point), np.array(exact_hits.hit))
    budgeted_hits = j_simulate(jbins, jmodel, true_j)
    t_budgeted = t_simulate(tbins, tmodel, TTransform.from_pose_tuple(TRUE_POSE, device="cpu"))
    scans = {"exact": (exact_scan, exact_scan),
             "budgeted": ((np.array(budgeted_hits.point), np.array(budgeted_hits.hit)),
                          (t_budgeted.point.numpy(), t_budgeted.hit.numpy()))}

    # hit fractions at the true pose: exact vs dense, budgeted and not
    o_s, d_s = jmodel.rays()
    o, d = true_j.apply(o_s), true_j.rotate(d_s)
    lim = dict(t_min=jmodel.range.min, t_max=jmodel.range.max)
    exact = j_cast_rays(jbvh, o, d, **lim)
    dense = j_cast_binned(jbins, o, d, **lim)
    free = j_cast_binned(jbins, o, d, c_super=jbins.n_super,
                         c_bin=jbins.n_super * jbins.bins_per_super, **lim)
    (jp_pts, jp_mask), (tp_pts, tp_mask) = scans["budgeted"]
    both = jp_mask & tp_mask
    print(json.dumps({"hits_at_true_pose": {
        "exact": float(jnp.mean(exact.hit)), "dense_default_budgets": float(jnp.mean(dense.hit)),
        "dense_unbudgeted": float(jnp.mean(free.hit)),
        "exact_vs_unbudgeted_disagree": int(jnp.sum(exact.hit != free.hit))},
        "budgeted_scan_port_vs_jax": {"hits_differ": int((jp_mask != tp_mask).sum()),
                                      "max_point_diff": float(np.abs(jp_pts - tp_pts)[both].max())}}),
          flush=True)

    maps = {"bins": (jbins, tbins), "bvh": (jbvh, tbvh)}
    for scan, ((j_points, j_mask), (t_points, t_mask)) in scans.items():
        for engine, corr in VARIANTS:
            t0 = time.perf_counter()
            jmap, tmap = maps[engine]
            cfg = dict(max_dist=MAX_DIST, corr_type=corr)
            js = jp.MICPSensorData(model=jmodel, points=jnp.asarray(j_points),
                                   mask=jnp.asarray(j_mask), tsb=JTransform.identity(),
                                   config=jp.MICPSensorConfig.create(**cfg))
            ts = tp.MICPSensorData(model=tmodel, points=torch.from_numpy(t_points),
                                   mask=torch.from_numpy(t_mask),
                                   tsb=TTransform.identity(device="cpu"),
                                   config=tp.MICPSensorConfig.create(**cfg))
            j_tom = JTransform.from_pose_tuple(jnp.asarray(START_POSE))
            t_tom = TTransform.from_pose_tuple(START_POSE, device="cpu")
            j_prog, t_prog = jnp.float32(0.0), torch.tensor(0.0)
            errs, trans = {"jax": [], "port": []}, {"jax": [], "port": []}
            for _ in range(N_CORRECTIONS):
                j_tom, j_st = jp.correct_once(jmap, [js], j_tom, JTransform.identity(), j_prog,
                                              jp.MICPConfig())
                t_tom, t_st = tp.correct_once(tmap, [ts], t_tom, TTransform.identity(device="cpu"),
                                              t_prog, tp.MICPConfig())
                j_prog, t_prog = j_st.convergence_progress, t_st.convergence_progress
                for k, tr in (("jax", np.asarray(j_tom.trans)), ("port", t_tom.trans.numpy())):
                    trans[k].append([float(x) for x in tr])
                    errs[k].append(float(np.linalg.norm(tr - TRUE_POSE[:3])))
            print(json.dumps({"scan": scan, "engine": engine, "corr_type": corr, "final_err": {
                k: v[-1] for k, v in errs.items()}, "err_by_correction": errs,
                "trans_by_correction": trans,
                "matches": {"jax": float(j_st.valid_matches), "port": float(t_st.valid_matches)},
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
