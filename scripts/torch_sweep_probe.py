"""The pose sweep's iterated correction, JAX and the port side by side, on
the CPU.

    python -m scripts.torch_sweep_probe

Runs the corrector benchmark's correction (cast -> point-to-plane reduce ->
Umeyama, composed onto the estimate) ten times from the reference's +0.2 m
z offset, with JAX library calls and with ``rmcl_tpu_torch.bench``, on the
same bins (32 poses x VLP-16 at 180 wide in a 20k-face 50 m sphere), then
the port alone at 1000 poses x 90 wide. Prints the median translation
error after each iteration: the figure ``chip_smoke.py`` phase 7 is held
to. About two minutes on four cores.
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import rmcl_tpu.ops.raycast_binned as jrb  # noqa: E402
from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_sphere  # noqa: E402
from rmcl_tpu.math.gaussian import CrossStatistics  # noqa: E402
from rmcl_tpu.math.stats import umeyama_transform  # noqa: E402
from rmcl_tpu_torch.bench import MAX_DIST, SweepBench  # noqa: E402
from rmcl_tpu_torch.convert import bins_from_arrays  # noqa: E402
from rmcl_tpu_torch.geom import mesh as tmesh  # noqa: E402

ITERS = 10
OFFSET = (0.0, 0.0, 0.2)


def _carry(jb):
    arrays = {f: None if getattr(jb, f) is None else np.asarray(getattr(jb, f))
              for f in ("tri", "bin_aabb", "super_aabb", "aabb_min", "aabb_max",
                        "mid_aabb", "hyper_aabb")}
    return bins_from_arrays(arrays, bins_per_super=jb.bins_per_super,
                            bins_per_mid=jb.bins_per_mid,
                            supers_per_hyper=jb.supers_per_hyper, device="cpu")


def _median_err(est, trans):
    return float(np.median(np.linalg.norm(np.asarray(est) - trans, axis=1)))


def jax_track(bench, jb):
    """The same iteration composed from JAX library calls."""
    trans = bench.trans_true_np
    dirs = jnp.asarray(bench.dirs.numpy())
    sweep = jrb.TiledSweep(trans, bench.model.width, bench.model.height, bench.sweep.pt,
                           bench.sweep.at, bench.sweep.et)

    def cast(tr):
        o, d = sweep.factored_rays(tr, dirs)
        h = jrb.cast_rays_binned_factored(jb, o, d, sort_blocks=True, payload="plane",
                                          **bench.corrector.cull_kw)
        n = sweep.n_rays
        up = sweep.unpermute(jnp.concatenate(
            [h.normal.reshape(n, 3), h.t.reshape(n, 1), h.hit.reshape(n, 1).astype(jnp.float32)],
            1))
        return tr[:, None] + up[..., 3:4] * dirs[None], up[..., 0:3], up[..., 4] > 0.5

    tj = jnp.asarray(trans)
    p, _, mask = cast(tj)
    data = p - tj[:, None]
    est = tj + jnp.asarray(OFFSET)
    errs = []
    for _ in range(ITERS):
        sp, sn, sh = cast(est)
        d_map = data + est[:, None]
        s = jnp.sum(sn * (d_map - sp), -1)
        ok = mask & sh & (jnp.abs(s) <= MAX_DIST)
        delta = umeyama_transform(CrossStatistics.from_masked_points(
            d_map, d_map - s[..., None] * sn, ok))
        est = delta.apply(est)
        errs.append(_median_err(est, trans))
    return errs


def port_track(bench):
    data, mask = bench.make_dataset(bench.trans_true)
    est = bench.trans_true + torch.tensor(OFFSET)
    errs = []
    for _ in range(ITERS):
        est = bench.iterate(data, mask, est, 1)
        errs.append(_median_err(est.numpy(), bench.trans_true_np))
    return errs


def main():
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    bench = SweepBench(n_poses=32, width=180, mesh=tmesh.make_sphere(100, 100, radius=50.0),
                       sub_blocks=8, device="cpu")
    jb = build_bins(make_sphere(100, 100, radius=50.0), bin_size=64, bins_per_super=16,
                    supers_per_hyper=16)
    bench.bins = _carry(jb)  # the same packing on both sides
    print(json.dumps(dict(poses=32, width=180, jax=jax_track(bench, jb),
                          port=port_track(bench))), flush=True)
    big = SweepBench(n_poses=1000, width=90, mesh=tmesh.make_sphere(100, 100, radius=50.0),
                     sub_blocks=8, device="cpu")
    print(json.dumps(dict(poses=1000, width=90, port=port_track(big),
                          seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
