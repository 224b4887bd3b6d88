"""The JAX bench's sweep casts and corrections (``bench.py``'s dense and
factored ``cast_sweep``, ``correction`` and ``correction_fused``), composed
from JAX library calls on a port ``SweepBench``'s bins, poses and settings:
the reference that ``tests/test_torch_bench.py`` holds the port's bench to
and that ``scripts/torch_dense_sweep_probe.py`` measures beside it."""

import jax.numpy as jnp

import rmcl_tpu.ops.raycast_binned as jrb
from rmcl_tpu.math.gaussian import CrossStatistics
from rmcl_tpu.math.stats import umeyama_transform
from rmcl_tpu_torch.bench import MAX_DIST


class JaxSweep:
    """The JAX side of a port bench: ``jb`` the JAX package's bins (the
    same as the bench's), ``bench`` the port's ``SweepBench``."""

    def __init__(self, jb, bench):
        self.jb = jb
        self.sweep = jrb.TiledSweep(bench.trans_true_np, bench.model.width, bench.model.height,
                                    bench.sweep.pt, bench.sweep.at, bench.sweep.et)
        self.dirs = jnp.asarray(bench.dirs.numpy())
        self.trans = jnp.asarray(bench.trans_true_np)
        self.cast_kw, self.fact_kw = dict(bench.cast_kw), dict(bench.fact_kw)

    def dense_cast(self, tr):
        """(points, normals, hits) of the dense engine's sweep at poses tr."""
        o, d = self.sweep.rays(tr, self.dirs)
        h = jrb.cast_rays_binned(self.jb, o, d, **self.cast_kw)
        up = self.sweep.unpermute(jnp.concatenate(
            [h.point, h.normal, h.hit[:, None].astype(jnp.float32)], 1))
        return up[..., 0:3], up[..., 3:6], up[..., 6] > 0.5

    def fact_cast(self, tr):
        """The same from the factored engine."""
        o, d = self.sweep.factored_rays(tr, self.dirs)
        h = jrb.cast_rays_binned_factored(self.jb, o, d, **self.fact_kw)
        n = self.sweep.n_rays
        up = self.sweep.unpermute(jnp.concatenate(
            [h.normal.reshape(n, 3), h.t.reshape(n, 1), h.hit.reshape(n, 1).astype(jnp.float32)],
            1))
        return tr[:, None] + up[..., 3:4] * self.dirs[None], up[..., 0:3], up[..., 4] > 0.5

    @staticmethod
    def correction(cast, data, mask, est):
        """One point-to-plane Umeyama increment per pose against cast(est)."""
        sp, sn, sh = cast(est)
        d_map = data + est[:, None]
        s = jnp.sum(sn * (d_map - sp), -1)
        ok = mask & sh & (jnp.abs(s) <= MAX_DIST)
        return umeyama_transform(CrossStatistics.from_masked_points(
            d_map, d_map - s[..., None] * sn, ok))

    def fused(self, data_sw, mask_sw, est):
        """The JAX bench's correction_fused, line for line: the dataset in
        sweep order, the moments summed per pose in pose-local frames."""
        sweep = self.sweep
        o_blk, d_blk = sweep.factored_rays(est, self.dirs)
        h = jrb.cast_rays_binned_factored(self.jb, o_blk, d_blk, **self.fact_kw)
        n_rays = sweep.n_rays
        sim_p, sim_n = h.point.reshape(n_rays, 3), h.normal.reshape(n_rays, 3)
        n_blk, P, _ = o_blk.shape
        o_r = jnp.broadcast_to(o_blk[:, None], (n_blk, d_blk.shape[1], P, 3)).reshape(n_rays, 3)
        signed = jnp.sum(sim_n * (data_sw - (sim_p - o_r)), axis=-1)
        ok = mask_sw & h.hit.reshape(n_rays) & (jnp.abs(signed) <= MAX_DIST)
        m_loc = data_sw - signed[:, None] * sim_n
        w = ok.astype(jnp.float32)
        outer = (m_loc[:, :, None] * data_sw[:, None, :]).reshape(n_rays, 9)
        ps = sweep.pose_sums(jnp.concatenate([w[:, None], data_sw, m_loc, outer], 1) * w[:, None])
        n = ps[:, 0]
        safe = jnp.maximum(n, 1.0)[:, None]
        d_mean, m_mean = ps[:, 1:4] / safe, ps[:, 4:7] / safe
        cov = ps[:, 7:16].reshape(-1, 3, 3) / safe[..., None] - m_mean[:, :, None] * d_mean[:, None, :]
        empty = (n <= 0.0)[:, None]
        return umeyama_transform(CrossStatistics(
            dataset_mean=jnp.where(empty, 0.0, d_mean), model_mean=jnp.where(empty, 0.0, m_mean),
            covariance=jnp.where(empty[..., None], 0.0, cov), n_meas=n))
