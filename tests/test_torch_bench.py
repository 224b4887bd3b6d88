"""The corrector benchmark's dense engine and fused reduction
(``rmcl_tpu_torch.bench.SweepBench(engine="dense")`` and ``fused=True``)
against the same compositions of JAX library calls as the JAX bench's
``cast_sweep`` and ``correction_fused``, at a small size: 32 poses x
VLP-16 at 90 wide in a 20k-face 50 m sphere. Both packages build their
bins in their default (native) order, which gives the same bins."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_sweep import JaxSweep
from rmcl_tpu.bvh.bins import build_bins
from rmcl_tpu.geom.mesh import make_sphere
from rmcl_tpu_torch.bench import SweepBench, settings_from_env
from rmcl_tpu_torch.geom import mesh as tmesh

torch.set_num_threads(2)

SPHERE = (100, 100)
WIDTH = 90
POSES = 32
# increments: float32 sums of ~1,400 points a pose in two frameworks' orders
TRANS_TOL = 2e-5
# the iterated median error of the two packages
ITER_TOL = 1e-4
# the fused increments of the two packages: the fused reduction sums raw
# second moments of points up to ~55 m from the pose in float32 and centres
# them after (cov = E[m d^T] - m_mean d_mean^T), which cancels ~3 digits, so
# the two frameworks' summation orders move the Kabsch rotation by ~1e-5 rad
# and the translation by that times the local means (measured 3.1e-5 m)
FUSED_TOL = 1e-4
OFFSET = (0.0, 0.0, 0.2)


@functools.lru_cache(maxsize=None)
def _jax_bins():
    return build_bins(make_sphere(*SPHERE, radius=50.0), bin_size=64, bins_per_super=16,
                      supers_per_hyper=16)


def _bench(**kw):
    bench = SweepBench(n_poses=POSES, width=WIDTH, sub_blocks=8, device="cpu",
                       mesh=tmesh.make_sphere(*SPHERE, radius=50.0), **kw)
    np.testing.assert_array_equal(bench.bins.tri.numpy(), np.asarray(_jax_bins().tri))
    return bench


def _median_err(est, trans):
    return float(np.median(np.linalg.norm(np.asarray(est) - trans, axis=1)))


def test_dense_sweep_correction_matches_jax():
    """The dense engine (cast_rays_binned with dir_groups = the block's 8
    directions, the JAX bench's cast_kw): the same dataset, one correction
    within TRANS_TOL, three iterations that end where JAX's do."""
    bench = _bench(engine="dense")
    assert bench.cast_kw == dict(block_size=128, dir_groups=8, c_bin=64, block_chunk=512,
                                 sort_blocks=True, c_mid=0)
    assert not bench.reuse
    ref = JaxSweep(_jax_bins(), bench)
    j_cast, tj = ref.dense_cast, ref.trans
    jp, _, jm = j_cast(tj)
    tp_, tm_ = bench.make_dataset(bench.trans_true)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm))
    assert tm_.float().mean() > 0.999
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp - tj[:, None]), atol=1e-4)
    jdp = jp - tj[:, None]
    est_j = tj + jnp.asarray(OFFSET)
    est_t = bench.trans_true + torch.tensor(OFFSET)
    dj = ref.correction(j_cast, jdp, jm, est_j)
    dt, n_meas = bench.correction(tp_, tm_, est_t)
    np.testing.assert_allclose(dt.trans.numpy(), np.asarray(dj.trans), rtol=0, atol=TRANS_TOL)
    assert float(n_meas.min()) > 0.9 * WIDTH * 16
    for _ in range(3):
        est_j = ref.correction(j_cast, jdp, jm, est_j).apply(est_j)
    est_t = bench.iterate(tp_, tm_, bench.trans_true + torch.tensor(OFFSET), 3)
    np.testing.assert_allclose(_median_err(est_t.numpy(), bench.trans_true_np),
                               _median_err(est_j, bench.trans_true_np), rtol=0, atol=ITER_TOL)


def test_fused_correction_matches_jax():
    """The fused reduction (the JAX bench's correction_fused, line for line
    in jax_sweep.py) on the dataset permuted once into sweep order: the same
    increments as JAX's fused correction, and the same gap to the unfused
    correction as JAX's (pose-local frames: (I - R) t_est)."""
    bench = _bench(fused=True)
    assert not bench.reuse  # the fused correction culls afresh
    ref = JaxSweep(_jax_bins(), bench)
    sweep, j_fact_cast, tj = ref.sweep, ref.fact_cast, ref.trans

    jp, _, jm = j_fact_cast(tj)
    jdp = jp - tj[:, None]
    tp_, tm_ = bench.make_dataset(bench.trans_true)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm))
    data_sw, mask_sw = bench.correction_layout(tp_, tm_)
    assert data_sw.shape == (bench.sweep.n_rays, 3) and mask_sw.shape == (bench.sweep.n_rays,)
    est_j = tj + jnp.asarray(OFFSET)
    est_t = bench.trans_true + torch.tensor(OFFSET)
    fj = ref.fused(sweep.permute(jdp), sweep.permute(jm[..., None])[..., 0], est_j)
    ft, n_meas = bench.correction(data_sw, mask_sw, est_t)
    np.testing.assert_allclose(ft.trans.numpy(), np.asarray(fj.trans), rtol=0, atol=FUSED_TOL)
    assert float(n_meas.min()) > 0.9 * WIDTH * 16
    uj = ref.correction(j_fact_cast, jdp, jm, est_j)
    ut = _bench().correction(tp_, tm_, est_t)[0]  # the same poses, unfused
    gap_j = np.asarray(uj.trans) - np.asarray(fj.trans)
    gap_t = ut.trans.numpy() - ft.trans.numpy()
    np.testing.assert_allclose(gap_t, gap_j, rtol=0, atol=FUSED_TOL)
    # the gap is the frame term: t_unfused = t_fused + (I - R) t_est
    R = ft.to_matrix()[..., :3, :3].double()
    framed = ft.trans.double() + est_t.double() - torch.einsum("nij,nj->ni", R, est_t.double())
    np.testing.assert_allclose(ut.trans.double().numpy(), framed.numpy(), rtol=0, atol=TRANS_TOL)
    with pytest.raises(ValueError, match="iterate"):
        bench.iterate(data_sw, mask_sw, est_t, 1)


def test_settings_read_the_engine_and_fused_variables():
    cfg, _ = settings_from_env({"BENCH_ENGINE": "dense", "BENCH_FUSED": "1"})
    assert cfg["engine"] == "dense" and cfg["fused"] is True
    cfg, _ = settings_from_env({})
    assert cfg["engine"] == "factored" and cfg["fused"] is False
    mesh = tmesh.make_sphere(8, 8, radius=5.0)
    with pytest.raises(ValueError, match="factored engine only"):
        SweepBench(n_poses=4, width=8, mesh=mesh, engine="dense", fused=True, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        SweepBench(n_poses=4, width=8, mesh=mesh, engine="exact", device="cpu")
