"""The port on the card: the intersection kernel against its plain PyTorch
version on the same CUDA tensors, and the main path on the card against
the same path on the CPU.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch (``--noconftest`` skips ``tests/conftest.py``, which
imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -m cuda -q
"""

import numpy as np
import pytest
import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.mesh import make_room_scene, make_sphere
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.micp import pipeline as tp
from rmcl_tpu_torch.ops import raycast_binned as trb
from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference, winner_t
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# kernel vs plain version: both built without FMA contraction, so they round
# alike; a winner may differ only at a near-tie of this relative size
T_RTOL = 1e-5
# card vs CPU through the whole cast: the cull's float32 reductions run in
# another order on the card, which can only matter where a budget truncates
HIT_MIN_AGREE = 0.999
PRIM_MIN_AGREE = 0.995
T_TOL = 1e-4
POSE_TOL = 1e-4

MESHES = {
    "room": lambda: make_room_scene(n_pillars=4, seed=3),
    "sphere": lambda: make_sphere(64, 64, radius=5.0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _vlp16_rays(origin, device):
    model = SphericalModel.vlp16()
    o, d = model.rays(device)
    o = o + torch.tensor(origin, dtype=torch.float32, device=device)
    n = o.shape[0]
    t_min = torch.full((n,), model.range.min, device=device)
    t_max = torch.full((n,), model.range.max, device=device)
    return o, d, t_min, t_max


@pytest.mark.parametrize("mesh,B,Rb", [
    ("room", 8, 32),
    ("room", 32, 100),  # the last warp of each block is partly idle
    ("sphere", 64, 128),
    ("sphere", 512, 256),  # the largest bin MeshMap builds
])
def test_kernel_matches_plain_version(card, mesh, B, Rb):
    bins = build_bins(MESHES[mesh](), bin_size=B, bins_per_super=8, device=card)
    rays = _vlp16_rays((0.5, -0.3, 1.0), card)
    inputs, _ = trb._kernel_inputs(bins, *rays, Rb, 24, 96, 256, 4)
    before = intersect_bins.launches
    kt, kref = intersect_bins(bins.tri, *inputs)
    pt, pref = intersect_bins_reference(bins.tri, *inputs)
    torch.cuda.synchronize()
    assert intersect_bins.launches == before + 1  # the plain version is not counted
    assert (pref >= 0).float().mean() > 0.9  # the rays really hit geometry
    torch.testing.assert_close(kt, pt, rtol=T_RTOL, atol=0.0)
    # a winner may differ only at a near-tie: the plain version's t for the
    # triangle the kernel chose agrees with the plain version's t_best
    ob, db, t_min_b = inputs[:3]
    mis = kref != pref
    tie_t = winner_t(bins.tri, ob[mis], db[mis], t_min_b[mis], kref[mis])
    torch.testing.assert_close(tie_t, pt[mis], rtol=T_RTOL, atol=0.0)


def test_kernel_rejects_mixed_devices(card):
    bins = build_bins(MESHES["room"](), bin_size=32, bins_per_super=8, device=card)
    inputs, _ = trb._kernel_inputs(bins, *_vlp16_rays((0.5, -0.3, 1.0), card), 128, 24, 96,
                                   256, 4)
    with pytest.raises(ValueError):
        intersect_bins(bins.tri, inputs[0].cpu(), *inputs[1:])


def test_cast_on_card_matches_cpu(card):
    mesh = MESHES["room"]()
    hits = []
    for dev in (card, torch.device("cpu")):
        bins = build_bins(mesh, bin_size=32, bins_per_super=8, device=dev)
        o, d, t_min, t_max = _vlp16_rays((0.5, -0.3, 1.0), dev)
        hits.append(trb.cast_rays_binned(bins, o, d, t_min=t_min, t_max=t_max))
    g, c = hits
    assert g.t.device.type == "cuda"
    g_hit, c_hit = g.hit.cpu(), c.hit
    assert (g_hit == c_hit).float().mean() >= HIT_MIN_AGREE
    both = g_hit & c_hit
    torch.testing.assert_close(g.t.cpu()[both], c.t[both], rtol=T_TOL, atol=T_TOL)
    torch.testing.assert_close(g.normal.cpu()[both], c.normal[both], rtol=T_TOL, atol=T_TOL)
    same = g.prim_id.cpu()[both] == c.prim_id[both]
    assert same.float().mean() >= PRIM_MIN_AGREE


def test_correct_once_on_card_matches_cpu(card):
    mesh = MESHES["room"]()
    true_pose = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
    start = [0.5, -0.3, 1.2, 0.0, 0.0, 0.35]  # +0.2 m z, +0.05 rad yaw
    model = SphericalModel.create(width=180, height=8, phi_min=-0.4, phi_max=0.3,
                                  range_max=30.0)
    cpu = torch.device("cpu")
    cpu_bins = build_bins(mesh, bin_size=32, bins_per_super=8, device=cpu)
    hits = simulate(cpu_bins, model, Transform.from_pose_tuple(true_pose, device=cpu))
    poses = []
    for dev in (card, cpu):
        bins = build_bins(mesh, bin_size=32, bins_per_super=8, device=dev)
        sensor = tp.MICPSensorData(
            model=model, points=hits.point.to(dev), mask=hits.hit.to(dev),
            tsb=Transform.identity(device=dev),
            config=tp.MICPSensorConfig.create(max_dist=2.0))
        tom = Transform.from_pose_tuple(start, device=dev)
        tbo = Transform.identity(device=dev)
        progress = torch.zeros((), device=dev)
        before = intersect_bins.launches
        trail = []
        for _ in range(3):
            tom, stats = tp.correct_once(bins, [sensor], tom, tbo, progress)
            progress = stats.convergence_progress
            trail.append(tom)
        # one sensor: one kernel launch per correction on the card, none on the CPU
        assert intersect_bins.launches - before == (3 if dev.type == "cuda" else 0)
        poses.append(trail)
    for g, c in zip(*poses):
        torch.testing.assert_close(g.trans.cpu(), c.trans, rtol=0.0, atol=POSE_TOL)
        sign = torch.sign(torch.dot(g.rot.cpu(), c.rot))
        torch.testing.assert_close(g.rot.cpu() * sign, c.rot, rtol=0.0, atol=POSE_TOL)
    err = np.linalg.norm(poses[0][-1].trans.cpu().numpy() - np.float32(true_pose[:3]))
    assert err < 0.01
