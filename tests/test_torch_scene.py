"""The port's scene graph (``geom/scene.py``) against the JAX package's on
the CPU: the flattened world mesh and its ids, the casts on the flattened
structures, and ``refine_instance_pose``.

Both packages get the identical instances (``convert.scene_from_arrays``
carries the JAX poses across). Tolerances:

- flattened vertices within FLAT_TOL (1e-6): the rotation matrix comes from
  each framework's own float32 quaternion arithmetic, an ulp apart; faces
  and ids exactly;
- casts: t within 1e-4 relative, ids equal (``tests/test_tlas.py``'s bar);
- refinement: both runs take float32 Newton steps on a 6x6 Hessian that
  the two autodiff systems sum in another order. A sphere's rotation is a
  gauge (the ranges do not see it), so its damped steps amplify those
  roundings: the deltas' rotations part by ~2e-4 and, through the lever of
  the 4 m offset, their translations by ~1e-4 m. What the ranges observe
  is the refined centre: within CENTRE_TOL (2e-5 m; the runs part by
  2.4e-6 m) of JAX's. Each step's loss within LOSS_RTOL (1%) of JAX's: the
  loss reaches its floor (8.4e-6 m^2, the facets) in three steps, where
  poses 1e-5 m apart give losses 0.4% apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.geom import mesh as jm
from rmcl_tpu.geom.scene import SceneGraph as JSceneGraph
from rmcl_tpu.geom.scene import refine_instance_pose as j_refine
from rmcl_tpu.math.se3 import Transform as JTransform
from rmcl_tpu.ops.raycast import cast_rays as j_cast_rays
from rmcl_tpu.ops.raycast_binned import cast_rays_binned as j_cast_rays_binned
from rmcl_tpu_torch.convert import scene_from_arrays
from rmcl_tpu_torch.geom.scene import refine_instance_pose
from rmcl_tpu_torch.ops.raycast import cast_rays
from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
from test_scene import two_box_scene

torch.set_num_threads(2)

FLAT_TOL = 1e-6
T_RTOL = 1e-4
LOSS_RTOL = 1e-2
CENTRE_TOL = 2e-5


def port_scene(jsg, device="cpu"):
    """The port's SceneGraph holding a JAX SceneGraph's geometries and
    instances."""
    return scene_from_arrays(
        {k: (m.vertices, m.faces) for k, m in jsg.geometries.items()},
        [dict(geometry=i.geometry, rot=np.asarray(i.pose.rot), trans=np.asarray(i.pose.trans),
              scale=i.scale, name=i.name) for i in jsg.instances],
        device=device)


def _scaled_scene():
    sg = JSceneGraph()
    sg.add_geometry("s", jm.make_sphere(24, 24, radius=1.0))
    sg.add_geometry("box", jm.make_box((1.0, 1.0, 1.0)))
    sg.add_instance("s", JTransform.identity(), scale=2.0)
    sg.add_instance("box", JTransform.from_pose_tuple(jnp.asarray([5.0, 1.0, 0.5, 0.1, 0.2, 0.3])),
                    scale=0.5, name="small")
    return sg


@pytest.mark.parametrize("make", [two_box_scene, _scaled_scene])
def test_flatten_ids_and_scale_match_jax(make):
    jsg = make()
    sg = port_scene(jsg)
    assert [i.name for i in sg.instances] == [i.name for i in jsg.instances]
    (jmesh, jprim, jinst), (mesh, prim, inst) = jsg.flatten(), sg.flatten()
    np.testing.assert_allclose(mesh.vertices, jmesh.vertices, rtol=FLAT_TOL, atol=FLAT_TOL)
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)
    np.testing.assert_array_equal(prim, jprim)
    np.testing.assert_array_equal(inst, jinst)
    table, jtable = sg.instance_pose_table(), jsg.instance_pose_table()
    np.testing.assert_array_equal(table.rot.numpy(), np.asarray(jtable.rot))
    np.testing.assert_array_equal(table.trans.numpy(), np.asarray(jtable.trans))


def test_scene_casts_match_jax():
    """``tests/test_scene.py``'s casts on the flattened structures (the
    BVH and the bins carry the instance and geometry ids)."""
    jsg = two_box_scene()
    jacc = jsg.build(bin_size=8, bins_per_super=4)
    acc = port_scene(jsg).build(bin_size=8, bins_per_super=4, device="cpu")
    assert acc.world_mesh.n_faces == 24 and acc.bvh.device.type == "cpu"
    o = np.asarray([[0.0, 0, 0], [0.0, 0, 0], [0.2, 0.1, 0], [0.0, 0, 0]], np.float32)
    d = np.asarray([[1.0, 0, 0], [-1.0, 0, 0], [-1.0, 0.05, 0.02], [0, 0, 1.0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for jh, th in ((j_cast_rays(jacc.bvh, jnp.asarray(o), jnp.asarray(d)),
                    cast_rays(acc.bvh, torch.from_numpy(o), torch.from_numpy(d))),
                   (j_cast_rays_binned(jacc.bins, jnp.asarray(o), jnp.asarray(d), block_size=32),
                    cast_rays_binned(acc.bins, torch.from_numpy(o), torch.from_numpy(d),
                                     block_size=32))):
        hit = th.hit.numpy()
        np.testing.assert_array_equal(hit, [True, True, True, False])
        np.testing.assert_array_equal(np.asarray(jh.hit), hit)
        np.testing.assert_array_equal(th.inst_id.numpy(), np.asarray(jh.inst_id))
        np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
        assert (th.prim_id.numpy()[hit] < 12).all()
        np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=T_RTOL)
        np.testing.assert_allclose(th.t.numpy()[0], 2.5, atol=1e-5)


def test_refine_instance_pose_matches_jax():
    """``tests/test_scene.py::test_refine_instance_pose``'s scenario at 8
    steps and 128 rays (of 10 and 256): one ball misplaced by (0, 0.15, -0.1) m, the
    ranges from the true scene's exact cast; both packages' losses step by
    step and their deltas, and the recovered centre within the JAX test's
    0.02 m."""
    ball = jm.make_sphere(32, 32, radius=1.0)
    true_pose = JTransform.from_pose_tuple(jnp.asarray([4.0, 0.15, -0.1, 0, 0, 0]))
    est_pose = JTransform.from_pose_tuple(jnp.asarray([4.0, 0.0, 0.0, 0, 0, 0]))
    sg_true, sg = JSceneGraph(), JSceneGraph()
    for s, p in ((sg_true, true_pose), (sg, est_pose)):
        s.add_geometry("ball", ball)
        s.add_instance("ball", p)
    n = 128
    rng = np.random.default_rng(0)
    d = np.stack([np.ones(n), rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    meas = np.asarray(j_cast_rays(sg_true.build(bin_size=16, bins_per_super=8).bvh,
                                  jnp.asarray(o), jnp.asarray(d)).t)

    jdelta, jlosses = j_refine(sg.build(bin_size=16, bins_per_super=8), 0, jnp.asarray(o),
                               jnp.asarray(d), jnp.asarray(meas), steps=8)
    acc = port_scene(sg).build(bin_size=16, bins_per_super=8, device="cpu")
    delta, losses = refine_instance_pose(acc, 0, torch.from_numpy(o), torch.from_numpy(d),
                                         torch.from_numpy(meas.copy()), steps=8)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=LOSS_RTOL)
    assert float(losses[-1]) < 0.1 * float(losses[0])
    refined = (delta @ acc.scene.instances[0].pose).trans.numpy()
    np.testing.assert_allclose(refined, np.asarray((jdelta @ est_pose).trans), atol=CENTRE_TOL)
    np.testing.assert_allclose(refined, [4.0, 0.15, -0.1], atol=0.02)
