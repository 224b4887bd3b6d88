"""The port's two-level scene (``geom/tlas.py``) against the JAX package's on
the CPU: the five cases of ``tests/test_tlas.py`` (the flattened match, the
pose override, the gradient with respect to the instance poses, closest
points, chained t_max), each held to JAX's own outputs on the same scene
(``mixed_scene``, with its scale-2 box), carried across by
``convert.scene_from_arrays``.

Both packages cast on bitwise-equal local bins and BVHs; the rays move into
each instance frame through each framework's own float32 quaternion
arithmetic, an ulp apart. Tolerances, ``tests/test_tlas.py``'s: t within
1e-4 relative (and 1e-4 absolute), ids and hits equal, normals within
1e-4; closest-point distances within 1e-4 relative + 1e-5, points within
1e-4. Gradients against ``jax.grad`` within 1e-4 relative + 1e-5, and
against central differences (eps 1e-3) within 1%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.geom.scene import SceneGraph as JSceneGraph
from rmcl_tpu.geom.tlas import build_tlas as j_build_tlas
from rmcl_tpu.geom.tlas import cast_rays_tlas as j_cast_rays_tlas
from rmcl_tpu.geom.tlas import closest_points_tlas as j_closest_points_tlas
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu_torch.geom.tlas import build_tlas, cast_rays_tlas, closest_points_tlas
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.ops.closest_point import closest_points
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from test_tlas import fan_rays, mixed_scene
from test_torch_scene import port_scene

torch.set_num_threads(2)

T_TOL = 1e-4
CP_RTOL, CP_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FD_EPS, FD_RTOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, JAX TLAS, the port's scene, the port's TLAS)."""
    jsg = mixed_scene()
    sg = port_scene(jsg)
    return (jsg, j_build_tlas(jsg, bin_size=16, bins_per_super=8), sg,
            build_tlas(sg, bin_size=16, bins_per_super=8, device="cpu"))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _same_hits(jh, th):
    hit = th.hit.numpy()
    np.testing.assert_array_equal(np.asarray(jh.hit), hit)
    np.testing.assert_allclose(th.t.detach().numpy()[hit], np.asarray(jh.t)[hit], rtol=T_TOL,
                               atol=T_TOL)
    np.testing.assert_array_equal(th.inst_id.numpy(), np.asarray(jh.inst_id))
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_allclose(th.normal.detach().numpy(), np.asarray(jh.normal), atol=T_TOL)


def test_tlas_matches_jax_and_the_flattened_scene(scenes):
    jsg, jt, sg, tt = scenes
    assert tt.n_instances == 3 and tt.scales.tolist() == [1.0, 2.0, 1.0]
    o, d = fan_rays()
    th = cast_rays_tlas(tt, _t(o), _t(d), block_size=32)
    _same_hits(j_cast_rays_tlas(jt, o, d, block_size=32), th)
    assert set(th.inst_id.numpy()[th.hit.numpy()]) == {0, 1, 2}  # the scale-2 box too
    hf = cast_rays_binned(sg.build(bin_size=16, bins_per_super=8, device="cpu").bins, _t(o),
                          _t(d), block_size=32)
    m = hf.hit.numpy()
    np.testing.assert_array_equal(m, th.hit.numpy())
    np.testing.assert_allclose(th.t.numpy()[m], hf.t.numpy()[m], rtol=T_TOL, atol=T_TOL)
    np.testing.assert_array_equal(th.inst_id.numpy(), hf.inst_id.numpy())
    np.testing.assert_array_equal(th.prim_id.numpy(), hf.prim_id.numpy())
    np.testing.assert_allclose(th.normal.numpy(), hf.normal.numpy(), atol=T_TOL)


def test_tlas_pose_override_matches_jax(scenes):
    _, jt, _, tt = scenes
    o, d = np.zeros((8, 3), np.float32), np.tile(np.float32([[1.0, 0, 0]]), (8, 1))
    h0 = cast_rays_tlas(tt, _t(o), _t(d), block_size=32)
    np.testing.assert_allclose(h0.t.numpy()[0], 4.0 - 0.5 / np.cos(0.3), atol=1e-4)
    # instance 0 one metre farther along +x, without a rebuild
    trans = tt.poses.trans.clone()
    trans[0, 0] += 1.0
    h1 = cast_rays_tlas(tt, _t(o), _t(d), poses=Transform(rot=tt.poses.rot, trans=trans),
                        block_size=32)
    np.testing.assert_allclose(h1.t.numpy()[0], h0.t.numpy()[0] + 1.0, atol=1e-4)
    jposes = JTransform(rot=jt.poses.rot, trans=jt.poses.trans.at[0, 0].add(1.0))
    _same_hits(j_cast_rays_tlas(jt, o, d, poses=jposes, block_size=32), h1)


def test_tlas_gradient_wrt_instance_poses_matches_jax(scenes):
    """d(sum of hit t)/d(every instance's quaternion and translation, and
    scale) by autograd against ``jax.grad``, and the translation of the
    hit box against central differences (moving it +x lengthens each of the
    4 rays 1:1; its yaw of 0.3 adds the face's slope along y)."""
    _, jt, _, tt = scenes
    o = np.zeros((4, 3), np.float32)
    o[:, 1] = np.linspace(-0.2, 0.2, 4)
    d = np.tile(np.float32([[1.0, 0, 0]]), (4, 1))

    def j_loss(rot, trans, scales):
        h = j_cast_rays_tlas(jt, o, d, poses=JTransform(rot=rot, trans=trans), scales=scales,
                             block_size=32)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    def t_loss(rot, trans, scales):
        h = cast_rays_tlas(tt, _t(o), _t(d), poses=Transform(rot=rot, trans=trans),
                           scales=scales, block_size=32)
        return torch.where(h.hit, h.t, 0.0).sum()

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(jt.poses.rot, jt.poses.trans, jt.scales)
    args = [x.clone().requires_grad_(True) for x in (tt.poses.rot, tt.poses.trans, tt.scales)]
    t_loss(*args).backward()
    for a, g in zip(args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    g_tx = args[1].grad.numpy()[0]
    np.testing.assert_allclose(g_tx[0], 4.0, atol=1e-3)
    with torch.no_grad():
        for axis in range(3):
            step = torch.zeros_like(tt.poses.trans)
            step[0, axis] = FD_EPS
            fd = (float(t_loss(tt.poses.rot, tt.poses.trans + step, tt.scales))
                  - float(t_loss(tt.poses.rot, tt.poses.trans - step, tt.scales))) / (2 * FD_EPS)
            np.testing.assert_allclose(fd, g_tx[axis], rtol=FD_RTOL, atol=FD_RTOL)


def test_tlas_closest_points_match_jax(scenes):
    jsg, jt, sg, tt = scenes
    q = np.random.default_rng(1).uniform(-6, 6, size=(128, 3)).astype(np.float32)
    jc, ji = j_closest_points_tlas(jt, jnp.asarray(q))
    tc, ti = closest_points_tlas(tt, _t(q))
    np.testing.assert_array_equal(tc.found.numpy(), np.asarray(jc.found))
    m = tc.found.numpy()
    np.testing.assert_allclose(tc.dist.numpy()[m], np.asarray(jc.dist)[m], rtol=CP_RTOL,
                               atol=CP_ATOL)
    np.testing.assert_allclose(tc.point.numpy()[m], np.asarray(jc.point)[m], atol=1e-4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.prim_id.numpy(), np.asarray(jc.prim_id))
    # against the flattened scene's exact query
    cf = closest_points(sg.build(bin_size=16, bins_per_super=8, device="cpu").bvh, _t(q))
    np.testing.assert_array_equal(tc.found.numpy(), cf.found.numpy())
    np.testing.assert_allclose(tc.dist.numpy()[m], cf.dist.numpy()[m], rtol=CP_RTOL,
                               atol=CP_ATOL)
    # scaled-instance distances are world-metric: 2 m above the scale-2 box's top
    c2, i2 = closest_points_tlas(tt, _t([[-4.0, 1.0, 3.0]]))
    np.testing.assert_allclose(c2.dist.numpy()[0], 2.0, atol=1e-5)
    assert int(i2[0]) == 1
    # a bound excludes what lies beyond it
    c3, i3 = closest_points_tlas(tt, _t([[-4.0, 1.0, 3.0]]), max_dist=1.5)
    assert not bool(c3.found[0]) and int(i3[0]) == -1


def test_tlas_chained_tmax_semantics_match_jax():
    """An instance cast FIRST that is farther must be replaced by a later,
    closer one; and a bound t_max below every hit leaves the rays missing."""
    jsg = JSceneGraph()
    jsg.add_geometry("box", jm.make_box((1.0, 1.0, 1.0)))
    jsg.add_instance("box", JTransform.from_pose_tuple(jnp.asarray([8.0, 0, 0, 0, 0, 0])))
    jsg.add_instance("box", JTransform.from_pose_tuple(jnp.asarray([2.0, 0, 0, 0, 0, 0])))
    jt = j_build_tlas(jsg, bin_size=8, bins_per_super=4)
    tt = build_tlas(port_scene(jsg), bin_size=8, bins_per_super=4, device="cpu")
    o, d = np.zeros((4, 3), np.float32), np.tile(np.float32([[1.0, 0, 0]]), (4, 1))
    tmax = np.float32([10.0, 10.0, 1.0, 7.9])
    th = cast_rays_tlas(tt, _t(o), _t(d), t_max=_t(tmax), block_size=32)
    _same_hits(j_cast_rays_tlas(jt, o, d, t_max=jnp.asarray(tmax), block_size=32), th)
    np.testing.assert_array_equal(th.hit.numpy(), [True, True, False, True])
    np.testing.assert_allclose(th.t.numpy()[[0, 1, 3]], 1.5, atol=1e-5)
    np.testing.assert_array_equal(th.inst_id.numpy(), [1, 1, -1, 1])
