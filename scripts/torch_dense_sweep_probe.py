"""The JAX package's own figures for the corrector benchmark's dense engine
and fused reduction, on the CPU, beside the port's at the same inputs.

    python -m scripts.torch_dense_sweep_probe [--poses N]

At the settings of ``chip_smoke.py`` phase 13 (the ~1M-face sphere of
``make_sphere(707, 707, radius=50)`` in bins of 64, 16 a super, 16 supers a
hyper; VLP-16 at 900 x 16; ``TiledSweep`` blocks of 16 poses x 8
directions; the JAX bench's ``cast_kw`` and ``fact_kw``) but at a reduced
pose count (default 32 of the benchmark's 1000: the JAX engines at full
width take minutes a cast on the CPU), it prints one JSON line:

* ``dense_median_err``: JAX's dense engine (``cast_rays_binned`` with
  ``dir_groups=8``), ten corrections composed from the reference's +0.2 m
  z offset, the median translation error after each; ``port_dense_median_err``
  the port's, from ``rmcl_tpu_torch.bench.SweepBench(engine="dense")`` on
  the same bins;
* ``fused_gap``: JAX's fused (sweep-order, pose-local) correction against
  its unfused one at the same estimate (trans + 0.2 m z): the largest
  per-pose difference of the increments' translations, the largest after
  adding (I - R) t_est to the fused one, the frame term, and the poses whose
  fused increment is not finite; ``port_fused_gap`` the same for the port.

The bins are built by both packages (native order) and must agree bitwise.
About five minutes on four cores at 32 poses.
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_sphere  # noqa: E402
from rmcl_tpu_torch.bench import SweepBench, settings_from_env  # noqa: E402
from rmcl_tpu_torch.geom import mesh as tmesh  # noqa: E402
from tests.jax_sweep import JaxSweep  # noqa: E402

ITERS = 10
OFFSET = (0.0, 0.0, 0.2)
SPHERE = 707


def _median_err(est, trans):
    return float(np.median(np.linalg.norm(np.asarray(est) - trans, axis=1)))


def _frame_gap(fused, unfused, est):
    """max |t_u - t_f|, max |t_u - (t_f + (I - R_f) est)| over the poses
    whose fused increment is finite, and the count of those that are not
    (the JAX bench multiplies the moments by the mask, so a ray its dataset
    cast missed, at t = 3e38, turns its pose's sums into NaN), of a fused
    and an unfused increment (Transforms of either package)."""
    as64 = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
    t_f, t_u, e = as64(fused.trans), as64(unfused.trans), as64(est)
    R = as64(fused.to_matrix())[..., :3, :3]
    framed = t_f + e - np.einsum("nij,nj->ni", R, e)
    ok = np.isfinite(t_f).all(1)
    return (float(np.abs(t_u - t_f)[ok].max()), float(np.abs(t_u - framed)[ok].max()),
            int((~ok).sum()))


def jax_side(jb, bench):
    """The JAX bench's dense engine and fused correction, composed from JAX
    library calls on the same bins, poses and sweep."""
    ref = JaxSweep(jb, bench)
    trans, sweep, tj = bench.trans_true_np, ref.sweep, ref.trans
    dense_cast, fact_cast, correction = ref.dense_cast, ref.fact_cast, ref.correction
    out = {}
    p, _, mask = dense_cast(tj)
    data = p - tj[:, None]
    out["dense_hit_frac"] = float(jnp.mean(mask))
    est = tj + jnp.asarray(OFFSET)
    errs = []
    for _ in range(ITERS):
        est = correction(dense_cast, data, mask, est).apply(est)
        errs.append(_median_err(est, trans))
    out["dense_median_err"] = errs

    p, _, mask = fact_cast(tj)
    data = p - tj[:, None]
    est = tj + jnp.asarray(OFFSET)
    unfused = correction(fact_cast, data, mask, est)
    f = ref.fused(sweep.permute(data), sweep.permute(mask[..., None])[..., 0], est)
    out["fused_gap"] = _frame_gap(f, unfused, est)
    return out


def port_side(bench, dense):
    out = {}
    dp, dm = dense.make_dataset(dense.trans_true)
    est = dense.trans_true + torch.tensor(OFFSET)
    errs = []
    for _ in range(ITERS):
        est = dense.correction(dp, dm, est)[0].apply(est)
        errs.append(_median_err(est.numpy(), dense.trans_true_np))
    out["port_dense_median_err"] = errs
    dp, dm = bench.make_dataset(bench.trans_true)
    est = bench.trans_true + torch.tensor(OFFSET)
    unfused = bench.correction(dp, dm, est)[0]
    fused = bench.correction_fused(bench.sweep.permute(dp),
                                   bench.sweep.permute(dm[..., None])[..., 0], est)[0]
    out["port_fused_gap"] = _frame_gap(fused, unfused, est)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=32)
    args = ap.parse_args()
    t0 = time.time()
    cfg, _ = settings_from_env({})
    cfg = dict(cfg, n_poses=args.poses)
    mesh = make_sphere(SPHERE, SPHERE, radius=50.0)
    jb = build_bins(mesh, bin_size=cfg["bin_size"], bins_per_super=cfg["bins_per_super"],
                    supers_per_hyper=cfg["supers_per_hyper"])
    tm = tmesh.make_sphere(SPHERE, SPHERE, radius=50.0)
    bench = SweepBench(**cfg, mesh=tm, device="cpu")
    dense = SweepBench(**dict(cfg, engine="dense"), mesh=tm, device="cpu")
    if not np.array_equal(bench.bins.tri.numpy(), np.asarray(jb.tri)):
        raise SystemExit("the two packages built different bins")
    out = {"poses": args.poses, "width": bench.model.width, "faces": int(mesh.n_faces)}
    out.update(jax_side(jb, bench))
    out.update(port_side(bench, dense))
    out["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
