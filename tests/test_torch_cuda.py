"""The port on the card: each kernel against its plain PyTorch version on
the same CUDA tensors, and the main paths on the card against the same
paths on the CPU.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch (``--noconftest`` skips ``tests/conftest.py``, which
imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -m cuda -q
"""

import functools
import re

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


def _edit_candidates(cand, count, tnear, case):
    """Candidate lists at the kernels' edges (the inputs are edited in place):
    "counts": block 0 has no candidate, the fullest block all cb slots
    (its list repeated); "exit_last": every block with two or more
    candidates exits at its last one (the prefetch edge: that slot's tile
    was staged during the slot before)."""
    if case == "counts":
        count[0] = 0
        b = int(torch.argmax(count))
        n = int(count[b])
        slots = torch.arange(cand.shape[1], device=cand.device) % n
        cand[b] = cand[b, slots]
        tnear[b] = torch.where(slots < torch.arange(cand.shape[1], device=cand.device),
                               tnear[b, n - 1], tnear[b, slots])
        count[b] = cand.shape[1]
    elif case == "exit_last":
        slot = torch.arange(cand.shape[1], device=cand.device)[None, :]
        many = (count >= 2)[:, None]
        tnear.copy_(torch.where(many & (slot < count[:, None] - 1), 0.0, tnear))
        tnear.copy_(torch.where(many & (slot == count[:, None] - 1), 3.0e38, tnear))


def _degenerate_half(tri):
    """The map with the second half of every bin's triangles zeroed, as
    padding triangles are: they give t = 0, which only t > t_min rejects."""
    out = tri.clone()
    out[:, :, tri.shape[2] // 2:] = 0.0
    return out


@pytest.mark.parametrize("mesh,B,Rb,case", [
    ("room", 8, 32, None),
    ("room", 32, 100, None),  # the last warp of each block is partly idle
    ("room", 32, 20, None),  # fewer rays than a warp
    ("sphere", 32, 128, None),
    ("sphere", 64, 128, None),
    ("sphere", 128, 128, None),
    ("sphere", 512, 256, None),  # the largest bin MeshMap builds
    ("sphere", 64, 128, "counts"),  # count = 0 and count = cb
    ("sphere", 64, 100, "exit_last"),
    ("sphere", 64, 128, "dead"),  # blocks whose rays have t_max = 0
    ("room", 32, 128, "t_min"),  # t_min > 0 against degenerate triangles
])
def test_kernel_matches_plain_version(card, mesh, B, Rb, case):
    bins = build_bins(MESHES[mesh](), bin_size=B, bins_per_super=8, device=card)
    rays = _vlp16_rays((0.5, -0.3, 1.0), card)
    inputs, _ = trb._kernel_inputs(bins, *rays, Rb, 24, 96, 4)
    tri = bins.tri
    _edit_candidates(*inputs[4:], case)
    if case == "dead":
        inputs[3][::3] = 0.0
    if case == "t_min":
        tri = _degenerate_half(tri)
        inputs[2].fill_(0.5)
    before = intersect_bins.launches
    kt, kref = intersect_bins(tri, *inputs)
    pt, pref = intersect_bins_reference(tri, *inputs)
    torch.cuda.synchronize()
    assert intersect_bins.launches == before + 1  # the plain version is not counted
    assert (pref >= 0).float().mean() > (0.5 if case else 0.9)  # the rays really hit geometry
    torch.testing.assert_close(kt, pt, rtol=T_RTOL, atol=0.0)
    # a winner may differ only at a near-tie: the plain version's t for the
    # triangle the kernel chose agrees with the plain version's t_best
    ob, db, t_min_b = inputs[:3]
    mis = kref != pref
    tie_t = winner_t(tri, ob[mis], db[mis], t_min_b[mis], kref[mis])
    torch.testing.assert_close(tie_t, pt[mis], rtol=T_RTOL, atol=0.0)


def test_kernel_takes_a_launch_order(card):
    """K1 with a random permutation as its launch order: bitwise what it
    gives without one, and the plain version's (which ignores the order)."""
    bins = build_bins(MESHES["sphere"](), bin_size=64, bins_per_super=8, device=card)
    inputs, _ = trb._kernel_inputs(bins, *_vlp16_rays((0.5, -0.3, 1.0), card), 128, 24, 96, 4)
    gen = torch.Generator(device=card).manual_seed(3)
    order = torch.randperm(inputs[0].shape[0], generator=gen, device=card).to(torch.int32)
    before = intersect_bins.launches
    kt, kref = intersect_bins(bins.tri, *inputs)
    ot, oref = intersect_bins(bins.tri, *inputs, order=order)
    pt, pref = intersect_bins_reference(bins.tri, *inputs, order=order)
    torch.cuda.synchronize()
    assert intersect_bins.launches == before + 2
    assert torch.equal(ot, kt) and torch.equal(oref, kref)
    assert (pref >= 0).float().mean() > 0.9
    torch.testing.assert_close(ot, pt, rtol=T_RTOL, atol=0.0)
    mis = oref != pref
    tie_t = winner_t(bins.tri, inputs[0][mis], inputs[1][mis], inputs[2][mis], oref[mis])
    torch.testing.assert_close(tie_t, pt[mis], rtol=T_RTOL, atol=0.0)


def _sweep_rays(tiles, device, n_poses=32, seed=4):
    """Pose-sweep rays in TiledSweep order (blocks of at * et directions
    sharing one direction a group x pt poses) inside the 5 m sphere."""
    pt, at, et = tiles
    model = SphericalModel.vlp16(width=180)
    dirs = model.rays(device)[1]
    trans = np.random.default_rng(seed).uniform(-1, 1, size=(n_poses, 3)).astype(np.float32)
    sweep = trb.TiledSweep(trans, model.width, model.height, pt, at, et)
    o, d = sweep.rays(torch.from_numpy(trans).to(device), dirs)
    n = o.shape[0]
    lim = (torch.zeros(n, device=device), torch.full((n,), 30.0, device=device))
    return (o, d) + lim, sweep.block_size, sweep.dir_groups


@pytest.mark.parametrize("B,tiles,case", [
    (64, (16, 8, 1), None),  # the bench's blocks: G = 8 groups of 16 rays
    (32, (32, 1, 1), None),  # G = 1 (shared_dir)
    (64, (16, 2, 2), None),  # G = 4 (el_tile 2), 64-ray blocks
    (64, (1, 128, 1), None),  # G = Rb = 128: the table in tiles of 4 triangles
    (128, (16, 8, 1), None),
    (8, (4, 8, 1), None),  # 32-ray blocks, bins of 8
    (64, (16, 8, 1), "counts"),
    (64, (16, 8, 1), "exit_last"),
    (64, (16, 8, 1), "dead"),
    (32, (16, 8, 1), "t_min"),
    (64, (16, 8, 1), "order"),
])
def test_groups_kernel_matches_plain_version(card, B, tiles, case):
    """K2g against its plain version, bitwise: t_best and the winners."""
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_groups, intersect_groups_reference

    bins = build_bins(MESHES["sphere"](), bin_size=B, bins_per_super=8, device=card)
    rays, Rb, G = _sweep_rays(tiles, card)
    inputs, _ = trb._kernel_inputs(bins, *rays, Rb, 24, 96, 4)
    tri = bins.tri
    _edit_candidates(*inputs[4:], case)
    if case == "dead":
        inputs[3][::3] = 0.0
    if case == "t_min":
        tri = _degenerate_half(tri)
        inputs[2].fill_(0.5)
    order = None
    if case == "order":
        gen = torch.Generator(device=card).manual_seed(3)
        order = torch.randperm(inputs[0].shape[0], generator=gen, device=card).to(torch.int32)
    before = intersect_groups.launches
    kt, kref = intersect_groups(tri, *inputs, G, order=order)
    pt, pref = intersect_groups_reference(tri, *inputs, G)
    torch.cuda.synchronize()
    assert intersect_groups.launches == before + 1  # the plain version is not counted
    # the rays really hit geometry (half of it, where half the triangles are zeroed)
    assert (pref >= 0).float().mean() > {None: 0.9, "t_min": 0.3}.get(case, 0.5)
    assert torch.equal(kt, pt) and torch.equal(kref, pref)


def test_groups_kernel_has_no_spills(card):
    from rmcl_tpu_torch.ops.raycast_cuda import kernel_registers

    for r, local in kernel_registers().values():
        assert 0 < r <= 255 and local == 0


def test_dir_groups_cast_on_card_matches_cpu(card):
    """cast_rays_binned with dir_groups on the card (K3 + K2g) against the
    same cast on the CPU, and against the K1 path on the card."""
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_groups

    mesh = MESHES["sphere"]()
    rays, Rb, G = _sweep_rays((16, 8, 1), card)
    b_gpu = build_bins(mesh, bin_size=64, bins_per_super=8, device=card)
    b_cpu = build_bins(mesh, bin_size=64, bins_per_super=8, device="cpu")
    kw = dict(block_size=Rb, dir_groups=G, sort_blocks=True)
    before = intersect_groups.launches
    hg = trb.cast_rays_binned(b_gpu, *rays[:2], rays[2], rays[3], **kw)
    hc = trb.cast_rays_binned(b_cpu, *(x.cpu() for x in rays), **kw)
    h1 = trb.cast_rays_binned(b_gpu, *rays[:2], rays[2], rays[3], block_size=Rb)
    assert intersect_groups.launches == before + 1
    for a, b in ((hc, hg), (h1, hg)):
        a_hit, b_hit = a.hit.cpu(), b.hit.cpu()
        assert (a_hit == b_hit).float().mean() >= HIT_MIN_AGREE
        both = a_hit & b_hit
        assert both.float().mean() > 0.9
        torch.testing.assert_close(b.t.cpu()[both], a.t.cpu()[both], rtol=T_TOL, atol=T_TOL)
        assert (a.prim_id.cpu()[both] == b.prim_id.cpu()[both]).float().mean() >= PRIM_MIN_AGREE


def test_misaligned_tri(card):
    """K4 stages bins with 16-byte copies: a view of tri that starts one
    float into its storage is refused, not read. K1 copies 4-byte words and
    takes it."""
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored
    bins = build_bins(MESHES["room"](), bin_size=32, bins_per_super=8, device=card)
    inputs, _ = trb._kernel_inputs(bins, *_vlp16_rays((0.5, -0.3, 1.0), card), 128, 24, 96, 4)
    flat = torch.empty(bins.tri.numel() + 1, device=card)
    tri = flat[1:].view(bins.tri.shape)
    tri.copy_(bins.tri)
    assert tri.is_contiguous() and tri.data_ptr() % 16
    for a, b in zip(intersect_bins(tri, *inputs), intersect_bins_reference(tri, *inputs)):
        assert torch.equal(a, b)
    ob, db, _, _, cand, count, tnear = inputs
    with pytest.raises(ValueError, match="16-byte"):
        intersect_factored(tri, ob, db[:, :1].contiguous(), torch.ones(ob.shape[0], device=card),
                           0.0, 100.0, cand, count, tnear)


def test_kernel_rejects_mixed_devices(card):
    bins = build_bins(MESHES["room"](), bin_size=32, bins_per_super=8, device=card)
    inputs, _ = trb._kernel_inputs(bins, *_vlp16_rays((0.5, -0.3, 1.0), card), 128, 24, 96, 4)
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


# --- the block cull (K3) and the factored pair loop (K4) ---

def _sweep_blocks(bins_dev, n_poses=48, width=120, seed=7, span=2.0):
    """Pose-sweep blocks (16 poses x 8 directions) in the 5 m sphere."""
    model = SphericalModel.vlp16(width=width)
    dirs = model.rays(bins_dev)[1]
    trans = np.random.default_rng(seed).uniform(-span, span, size=(n_poses, 3)).astype(np.float32)
    sweep = trb.TiledSweep(trans, width, model.height, 16, 8, 1)
    return sweep.factored_rays(torch.from_numpy(trans).to(bins_dev), dirs)


def _sphere_bins(dev):
    """The 5 m sphere in 128 bins of 64, 8 supers, 4 hypers."""
    return build_bins(MESHES["sphere"](), bin_size=64, bins_per_super=16, supers_per_hyper=2,
                      device=dev)


def _cull_case(card, case):
    """K3 inputs: the dense engine's chunk cull (no hyper level), or the
    factored cull with the hyper level at 4 and at 128 (per-ray) cones."""
    from rmcl_tpu_torch.ops.cull_cuda import _cull_args, _factored_bounds, _subblock_bounds
    from rmcl_tpu_torch.ops.raycast_binned import _pad_factored_blocks
    if case == "dense_room":
        bins = build_bins(MESHES["room"](), bin_size=32, bins_per_super=8, device=card)
        o, d, t_min, t_max = _vlp16_rays((0.5, -0.3, 1.0), card)
        blocks = trb._pad_rays(o, d, t_min, t_max, 128)
        raw = lambda r: _subblock_bounds(*blocks, r)
        return _cull_args(bins, raw, 4, *trb._resolve_budgets(bins, 24, 96)[:2], 0)
    bins = _sphere_bins(card)
    o_blk, d_blk = _sweep_blocks(card)
    o_p, d_p, alive, *_ = _pad_factored_blocks(o_blk, d_blk, None, 512)
    R, margin = (4, 0.0) if case == "sweep_hyper" else (128, 0.03)
    raw = _factored_bounds(o_p, d_p, alive, 0.0, 130.0, R, margin, 0.0)
    return _cull_args(bins, raw, R, bins.n_super, 64, bins.n_hyper)


@pytest.mark.parametrize("case", ["dense_room", "sweep_hyper", "sweep_per_ray_cones"])
def test_cull_kernel_matches_plain_version(card, case):
    from rmcl_tpu_torch.ops.cull_cuda import (cull_blocks, cull_blocks_reference,
                                              cull_disagreements)
    args = _cull_case(card, case)
    before = cull_blocks.launches
    k_out = cull_blocks(*args)
    p_out = cull_blocks_reference(*args)
    torch.cuda.synchronize()
    assert cull_blocks.launches == before + 1  # the plain version is not counted
    assert float(p_out[1].float().mean()) > 1  # the lists are not trivial
    bad, _ = cull_disagreements(k_out, p_out)
    assert bad == 0


@pytest.mark.parametrize("layout,case", [
    ("sweep", None), ("tracking", None), ("paired", None),
    ("sweep", "counts"), ("tracking", "counts"), ("paired", "counts"),
    ("sweep", "exit_last"), ("tracking", "exit_last"), ("paired", "exit_last"),
    ("sweep", "dead"), ("tracking", "dead"), ("paired", "dead"),
    ("sweep", "t_min"), ("tracking", "t_min"), ("paired", "t_min"),
    ("sweep", "order"), ("tracking", "order"), ("paired", "order"),
    ("sweep_5x3", None),  # odd poses and directions: ragged 2 x 2 tiles
])
def test_factored_kernel_matches_plain_version(card, layout, case):
    from rmcl_tpu_torch.ops.raycast_binned import _factored_block_candidates, _pad_factored_blocks
    from rmcl_tpu_torch.ops.raycast_cuda import (factored_winner_t, intersect_factored,
                                                 intersect_factored_reference)
    bins = _sphere_bins(card)
    paired = layout == "paired"
    if layout == "sweep":
        o_blk, d_blk = _sweep_blocks(card)
    elif layout == "sweep_5x3":
        o_blk, d_blk = _sweep_blocks(card)
        o_blk, d_blk = o_blk[:, :5].contiguous(), d_blk[:, :3].contiguous()
    else:
        model = SphericalModel.vlp16(width=240)
        d = model.rays(card)[1].reshape(-1, 128, 3)
        shift = torch.tensor([0.3, -0.2, 0.1], device=card)
        o_blk = (shift.expand(d.shape[0], 1, 3) if layout == "tracking"
                 else shift + 0.05 * torch.roll(d, 1, dims=1)).contiguous()
        d_blk = d
    o_p, d_p, alive, *_ = _pad_factored_blocks(o_blk, d_blk, None, 512)
    sub_blocks = 4 if layout != "sweep_5x3" else 1
    cand, count, tnear, _ = _factored_block_candidates(
        bins, o_p, d_p, alive, 0.1, 130.0, 8, 64, 4, sub_blocks, 0.0)
    tri, t_min, order = bins.tri, 0.1, None
    _edit_candidates(cand, count, tnear, case)
    if case == "dead":
        alive[::3] = 0.0
    if case == "t_min":
        tri, t_min = _degenerate_half(tri), 0.5
    if case == "order":
        gen = torch.Generator().manual_seed(5)
        order = torch.randperm(o_p.shape[0], generator=gen).to(card, torch.int32)
    args = (tri, o_p, d_p, alive, t_min, 130.0, cand, count, tnear)
    before = intersect_factored.launches
    kt, kref = intersect_factored(*args, paired=paired, order=order)
    pt, pref = intersect_factored_reference(*args, paired=paired)
    torch.cuda.synchronize()
    assert intersect_factored.launches == before + 1
    hits = (pref[alive > 0] >= 0).float().mean()  # padding blocks are dead
    assert hits > (0.4 if case else 0.99)
    torch.testing.assert_close(kt, pt, rtol=T_RTOL, atol=0.0)
    mis = kref != pref
    P_eff = kt.shape[2]
    o_r = (o_p[:, :, None] if paired else o_p[:, None]).expand(-1, kt.shape[1], P_eff, 3)
    d_r = d_p[:, :, None].expand(-1, -1, P_eff, 3)
    tie_t = factored_winner_t(tri, o_r[mis], d_r[mis], t_min, kref[mis])
    torch.testing.assert_close(tie_t, pt[mis], rtol=T_RTOL, atol=0.0)


def test_factored_cast_on_card_matches_cpu(card):
    hits = []
    for dev in (card, torch.device("cpu")):
        bins = _sphere_bins(dev)
        o_blk, d_blk = _sweep_blocks(dev)
        hits.append(trb.cast_rays_binned_factored(bins, o_blk, d_blk, c_super=8, c_hyper=4,
                                                  payload="index"))
    g, c = hits
    assert (g.hit.cpu() == c.hit).float().mean() >= HIT_MIN_AGREE
    both = g.hit.cpu() & c.hit
    torch.testing.assert_close(g.t.cpu()[both], c.t[both], rtol=T_TOL, atol=T_TOL)
    assert (g.prim_id.cpu()[both] == c.prim_id[both]).float().mean() >= PRIM_MIN_AGREE


def test_tracked_corrector_on_card_matches_cpu(card):
    from rmcl_tpu_torch.micp.tracking import TrackedCorrector
    from rmcl_tpu_torch.ops.cull_cuda import cull_factored
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored
    mesh = MESHES["room"]()
    model = SphericalModel.create(width=256, height=8, phi_min=-0.4, phi_max=0.3,
                                  range_max=30.0)
    true_pose = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
    cpu = torch.device("cpu")
    cpu_bins = build_bins(mesh, bin_size=32, bins_per_super=8, device=cpu)
    hits = simulate(cpu_bins, model, Transform.from_pose_tuple(true_pose, device=cpu))
    poses = []
    for dev in (card, cpu):
        bins = build_bins(mesh, bin_size=32, bins_per_super=8, device=dev)
        sensor = tp.MICPSensorData(
            model=model, points=hits.point.to(dev), mask=hits.hit.to(dev),
            tsb=Transform.identity(device=dev), config=tp.MICPSensorConfig.create(max_dist=2.0))
        tbo = Transform.identity(device=dev)
        tc = TrackedCorrector(bins, model, tp.MICPConfig())
        before = (cull_factored.launches, intersect_factored.launches)
        state = tc.init(bins, Transform.from_pose_tuple([0.5, -0.3, 1.2, 0.0, 0.0, 0.35],
                                                        device=dev), tbo, sensor.tsb)
        trail = []
        for _ in range(4):
            state, _ = tc.step(bins, [sensor], state, tbo)
            trail.append(state.tom)
        launched = (cull_factored.launches - before[0],
                    intersect_factored.launches - before[1])
        if dev.type == "cuda":
            assert launched[0] == state.n_reculls and launched[1] == 4
        else:
            assert launched == (0, 0)
        poses.append(trail)
    for g, c in zip(*poses):
        torch.testing.assert_close(g.trans.cpu(), c.trans, rtol=0.0, atol=POSE_TOL)
    err = np.linalg.norm(poses[0][-1].trans.cpu().numpy() - np.float32(true_pose[:3]))
    assert err < 0.01


def test_batch_corrector_on_card_matches_cpu(card):
    """Four closed-loop batch corrections (48 poses, VLP-16 at 120 wide, the
    5 m sphere): one K3 launch a cull that the corrector counts, one K4
    launch a correction, and the positions of the CPU run."""
    from rmcl_tpu_torch.micp.batch import BatchCorrector
    from rmcl_tpu_torch.ops.cull_cuda import cull_factored
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored
    truth = np.random.default_rng(7).uniform(-2, 2, size=(48, 3)).astype(np.float32)
    model = SphericalModel.vlp16(width=120)
    trails = []
    for dev in (card, torch.device("cpu")):
        bc = BatchCorrector(_sphere_bins(dev), model, truth, max_dist=0.5, origin_margin=0.02,
                            c_super=8, c_hyper=4, sub_blocks=8)
        t = torch.from_numpy(truth).to(dev)
        points, _, hit = bc.cast(t)
        trans = t + torch.tensor([0.0, 0.0, 0.05], device=dev)
        before = (cull_factored.launches, intersect_factored.launches)
        trail, culls = [], 0
        for _ in range(4):
            step = bc.step(points - t[:, None], hit, trans)
            culls += step.culls
            assert int(step.truncated) == 0
            trans = step.trans
            trail.append(trans.cpu())
        launched = (cull_factored.launches - before[0], intersect_factored.launches - before[1])
        assert launched == ((culls, 4) if dev.type == "cuda" else (0, 0))
        trails.append(trail)
    for g, c in zip(*trails):
        torch.testing.assert_close(g, c, rtol=0.0, atol=POSE_TOL)


# --- the fused cull (K3 with its bounds) ---

def _fused_case(card, case):
    """(wrapper, plain version, arguments) of the fused cull for one case."""
    from rmcl_tpu_torch.ops import cull_cuda as cc
    from rmcl_tpu_torch.ops.raycast_binned import _pad_factored_blocks
    if case.startswith("dense") or case.startswith("sphere_b"):
        # <map>_<Rb>_r<R>[_dead]: a VLP-16 scan in Rb-ray blocks, R sub-blocks
        Rb, R = (int(x) for x in re.search(r"_(\d+)_r(\d+)", case).groups())
        if case.startswith("sphere_b"):  # bins of B, cs * S bins at level 1
            B, S = (8, 64) if case.startswith("sphere_b8_") else (512, 4)
            bins = build_bins(make_sphere(80, 80, radius=5.0), bin_size=B, bins_per_super=S,
                              device=card)
        else:
            bins = build_bins(MESHES["room"](), bin_size=8, bins_per_super=4, device=card)
        cs, cb, _ = trb._resolve_budgets(bins, 24, 96)
        blocks = trb._pad_rays(*_vlp16_rays((0.5, -0.3, 1.0), card), Rb)
        if case.endswith("_dead"):  # dead blocks, and blocks with some inert rays
            blocks[3][::3] = 0.0
            blocks[3][1::3, ::2] = 0.0
        return cc.cull_rays, cc.cull_rays_reference, (bins, *blocks, R, cs, cb, 0)
    bins = _sphere_bins(card)
    if case.startswith("tracking"):  # one pose, 128 directions a block
        d = SphericalModel.vlp16(width=240).rays(card)[1].reshape(-1, 128, 3).contiguous()
        o = torch.tensor([0.3, -0.2, 0.1], device=card).expand(d.shape[0], 1, 3).contiguous()
        R, margins = 4, (0.05, 0.01)
    else:
        o, d = _sweep_blocks(card)
        R, margins = ((int(re.search(r"_r(\d+)", case).group(1)), (0.03, 0.0))
                      if case.startswith("per_ray") else (4, (0.05, 0.01)))
    o_p, d_p, alive, *_ = _pad_factored_blocks(o, d, None, 512)
    if case.endswith("_dead"):
        alive[::3] = 0.0
    return cc.cull_factored, cc.cull_factored_reference, (
        bins, o_p, d_p, alive, 0.0, 130.0, R, min(8, bins.n_super), 64, bins.n_hyper, *margins)


@pytest.mark.parametrize("case", [
    "dense_128_r4", "dense_100_r4", "dense_32_r4",  # 100: 25-ray sub-blocks, padded trees
    "dense_128_r1", "dense_100_r1", "dense_32_r1",
    "dense_128_r4_dead",
    "sphere_b8_128_r4",  # cs x S = 24 x 64 = 1,536 bins at level 1 (2,048 keys)
    "sphere_b512_1024_r1",  # a 1,024-ray tree: over 48 KB of shared memory
    "tracking_r4",  # factored, G % R == 0, both margins
    "sweep_r4", "sweep_r4_dead",  # factored 16 x 8 with the hyper level, both margins
    "per_ray_r128", "per_ray_r128_dead",  # R = 128 > G = 8: expanded order, margin 0.03
    "per_ray_r64",  # 2-ray sub-blocks: 2 cones a lane sharing their origin box
])
def test_fused_cull_matches_plain_version(card, case):
    from rmcl_tpu_torch.ops.cull_cuda import cull_disagreements
    fn, plain, args = _fused_case(card, case)
    before = fn.launches
    k_out = fn(*args)
    p_out = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # one launch a cull; the plain version is not counted
    assert float(p_out[1].float().mean()) > 1  # the lists are not trivial
    bad, _ = cull_disagreements(k_out, p_out)
    assert bad == 0


def _mid_bins(dev):
    """A 5 m sphere in 1,580 bins of 8: 99 supers of 16 bins, each 4 mids
    of 4 bins (the last super partly padding), 13 hypers."""
    return build_bins(make_sphere(80, 80, radius=5.0), bin_size=8, bins_per_super=16,
                      bins_per_mid=4, supers_per_hyper=8, device=dev)


@pytest.mark.parametrize("mode", ["rays", "factored", "expanded", "cones"])
@pytest.mark.parametrize("keys,cm", [("packed", 40), ("float", 40), ("packed", 6)])
def test_mid_cull_kernel_matches_plain_version(card, monkeypatch, mode, keys, cm):
    """K3 with the mid level, bitwise its plain version in every front end:
    packed mid keys (the ids fit 20 bits), the float keys of large maps (the
    rule forced here), and a small mid budget that truncates (sat)."""
    from rmcl_tpu_torch.ops import cull_cuda as cc
    from rmcl_tpu_torch.ops.raycast_binned import _pad_factored_blocks
    if keys == "float":
        monkeypatch.setattr(cc, "_packs", lambda n: False)
    bins = _mid_bins(card)
    cs, cb = 16, min(64, cm * bins.bins_per_mid)
    if mode in ("rays", "cones"):
        blocks = trb._pad_rays(*_vlp16_rays((0.5, -0.3, 1.0), card), 128)
        if mode == "rays":
            fn, plain, args = cc.cull_rays, cc.cull_rays_reference, (
                bins, *blocks, 4, cs, cb, 0, cm)
        else:
            fn, plain = cc.cull_blocks, cc.cull_blocks_reference
            args = cc._cull_args(bins, lambda r: cc._subblock_bounds(*blocks, r), 4, cs, cb, 0,
                                 cm)
    else:
        o, d = _sweep_blocks(card)
        o_p, d_p, alive, *_ = _pad_factored_blocks(o, d, None, 512)
        R = 4 if mode == "factored" else 32
        fn, plain, args = cc.cull_factored, cc.cull_factored_reference, (
            bins, o_p, d_p, alive, 0.0, 130.0, R, cs, cb, 2, 0.05, 0.01, cm)
    before = fn.launches
    k_out = fn(*args)
    p_out = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # the plain version is not counted
    assert float(p_out[1].float().mean()) > 2  # the lists are not trivial
    if cm < 10:
        assert bool(p_out[3].any())  # the mid budget truncates somewhere
    for a, b in zip(k_out, p_out):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _wide_bins(S, card):
    """The phase-4 building at 16 faces a bin, S bins a super."""
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    return build_bins(make_building_scene(subdiv=45), bin_size=16, bins_per_super=S, device=card)


def _k3_wide_case(card, case):
    """K3 inputs past the 16,384 keys a level that the kernel once refused:
    phase 8's scan of the building at 16 faces a bin, 476 supers of 64 at
    c_super 300, c_bin 4,000 (19,200 keys at level 1), or 30,409 supers of
    one bin at 96, 96 (30,409 keys at level 0); or an MCL-like hyper level
    (c_hyper 8, c_super 48, c_bin 288, 8 cones: 768 keys at level 1; the
    small building at 16 faces a bin, 137 supers of 16 in 18 hypers)."""
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    if case == "hyper":
        bins = build_bins(make_building_scene(subdiv=12), bin_size=16, bins_per_super=16,
                          supers_per_hyper=8, device=card)
        rng = np.random.default_rng(8)
        n_part, n_beam = 2048, 100
        pos = torch.from_numpy(np.stack([rng.uniform(1, 11, n_part), rng.uniform(1, 11, n_part),
                                         np.full(n_part, 1.5)], -1).astype(np.float32))
        az = torch.from_numpy(rng.uniform(-np.pi, np.pi, n_beam).astype(np.float32))
        el = torch.from_numpy(rng.uniform(-0.26, 0.26, n_beam).astype(np.float32))
        d = torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], -1)
        o = pos[None].expand(n_beam, n_part, 3).reshape(-1, 3).to(card)  # beam-major
        d = d[:, None].expand(n_beam, n_part, 3).reshape(-1, 3).to(card)
        t = torch.full((o.shape[0],), 30.0, device=card)
        blocks = trb._pad_rays(o, d, torch.zeros_like(t), t, 128)
        return (bins, *blocks, 8, 48, 288, 8, 0)
    S, cs, cb = (64, 300, 4000) if case == "level1" else (1, 96, 96)
    bins = _wide_bins(S, card)
    assert max(bins.n_super, cs * S) > 16384
    blocks = trb._pad_rays(*_vlp16_rays((9.0, 3.0, 1.5), card), 128)
    return (bins, *blocks, 4, cs, cb, 0, 0)


@pytest.mark.parametrize("stage", ["planned", "streamed"])
@pytest.mark.parametrize("threads", [256, 128])
@pytest.mark.parametrize("case", ["level1", "level0", "hyper"])
def test_cull_kernel_on_wide_levels_matches_plain_version(card, monkeypatch, case, threads,
                                                         stage):
    """K3 bitwise its plain version on levels past the old cap and at an
    MCL-like hyper level, at either CTA width (forced by the grid threshold
    of the launch plan), with the launch plan's stage or with a
    stage of 64 keys, so that every level wider than its kept list streams
    (each radix pass recomputing the tests)."""
    from rmcl_tpu_torch.ops import cull_cuda as cc
    monkeypatch.setattr(cc, "_K3_BIG_GRID", 1 if threads == 128 else 1 << 30)
    if stage == "streamed":
        monkeypatch.setattr(cc, "_K3_STAGE_MAX", 64)
    args = _k3_wide_case(card, case)
    before = cc.cull_rays.launches
    k_out = cc.cull_rays(*args)
    p_out = cc.cull_rays_reference(*args)
    torch.cuda.synchronize()
    assert cc.cull_rays.launches == before + 1
    assert float(p_out[1].float().mean()) > 2
    for a, b in zip(k_out, p_out):
        assert torch.equal(a, b)


def test_cull_kernel_has_no_spills(card):
    """K3's builds, with the mid level: 1, 2 and 4 cones a lane at either
    CTA width with the streamed passes, and at 128 threads 1 cone a lane
    and 4 sharing their origin box without them: registers within the 255 a
    thread allows, no local memory."""
    from rmcl_tpu_torch.ops.cull_cuda import kernel_registers

    regs = kernel_registers()
    assert len(regs) == 8
    for r, local in regs.values():
        assert 0 < r <= 255 and local == 0


def test_card_casts_run_no_torch_bounds(card, monkeypatch):
    """On the card the bounds are the kernel's: both engines cast with the
    plain bounds functions made to raise, one cull launch a cast."""
    from rmcl_tpu_torch.ops import cull_cuda as cc

    def refuse(*_args, **_kw):
        raise AssertionError("a torch bounds function ran on the card")

    for name in ("_block_bounds", "_subblock_bounds", "_factored_bounds", "_capped_bounds"):
        monkeypatch.setattr(cc, name, refuse)
    room = build_bins(MESHES["room"](), bin_size=32, bins_per_super=8, device=card)
    o, d, t_min, t_max = _vlp16_rays((0.5, -0.3, 1.0), card)
    before = cc.cull_rays.launches
    hits = trb.cast_rays_binned(room, o, d, t_min=t_min, t_max=t_max)
    assert cc.cull_rays.launches == before + 1 and hits.hit.float().mean() > 0.9
    bins = _sphere_bins(card)
    o_blk, d_blk = _sweep_blocks(card)
    for R, margin in ((4, 0.0), (128, 0.03)):
        before = cc.cull_factored.launches
        hits = trb.cast_rays_binned_factored(bins, o_blk, d_blk, c_super=8, c_hyper=4,
                                             sub_blocks=R, origin_margin=margin)
        assert cc.cull_factored.launches == before + 1 and hits.hit.float().mean() > 0.99


# --- the exact engine: BVH traversal (K5), closest point over the BVH (K6)
# and over candidate bins (K6b) ---


def _exact_mesh(name):
    from rmcl_tpu_torch.geom.mesh import make_building_scene

    return make_building_scene(subdiv=4) if name == "building" else MESHES[name]()


def _points_in(mesh, dev, n, seed, grow):
    """n points uniform in the mesh's AABB scaled about its centre by
    1 + grow (negative: shrunk)."""
    lo, hi = mesh.aabb()
    c, h = (lo + hi) / 2, (hi - lo) / 2 * (1.0 + grow)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(c - h, c + h, (n, 3)).astype(np.float32)).to(dev)


def _scattered_rays(mesh, dev, n=4096, seed=5):
    o = _points_in(mesh, dev, n, seed, -0.2)
    rng = np.random.default_rng(seed + 1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::97, 0] = -1e-25  # tiny negative components take the +1e20 reciprocal
    return o, torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("mesh,case", [
    ("room", "scan"),
    ("room", "scattered"),
    ("sphere", "scan"),
    ("building", "scattered"),
    ("room", "entry"),  # t_max <= t_min on every third ray: nothing visited
    ("building", "t_min"),  # t_min > 0 starts behind near surfaces
])
def test_traverse_kernel_matches_plain_version(card, mesh, case):
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, traverse_rays_reference

    m = _exact_mesh(mesh)
    bvh = build_bvh(m, device=card)
    if case == "scan":
        o, d, t_min, t_max = _vlp16_rays((0.5, -0.3, 1.0), card)
    else:
        o, d = _scattered_rays(m, card)
        t_min = torch.zeros(o.shape[0], device=card)
        t_max = torch.full((o.shape[0],), 3.0e38, device=card)
    if case == "entry":
        t_max[::3] = t_min[::3]
    if case == "t_min":
        t_min.fill_(0.75)
    before = traverse_rays.launches
    k = traverse_rays(bvh.nodes, bvh.root_link, o, d, t_min, t_max, visits=True)
    p = traverse_rays_reference(bvh.nodes, bvh.root_link, o, d, t_min, t_max, visits=True)
    torch.cuda.synchronize()
    assert traverse_rays.launches == before + 1  # the plain version is not counted
    assert (p[1] >= 0).float().mean() > 0.5  # the rays really hit geometry
    for a, b in zip(k, p):  # t_best, slot, visits: bitwise
        assert torch.equal(a, b)
    if case == "entry":
        assert int(k[2][::3].sum()) == 0


def test_traverse_kernel_has_no_spills(card):
    """The kernels of traverse_bvh.cu as built (K5's two instantiations, the
    cast's and MCL's scoring one, and the fold kernel): registers within
    the 255 a thread allows, and the walk's within the 48 (registers are
    allocated 8 a thread at a time) that keep 10 CTAs of 128 a SM resident;
    no local memory (spills)."""
    from rmcl_tpu_torch.ops.traverse_cuda import kernel_registers

    regs = kernel_registers()
    assert set(regs) == {"K5", "K5 ScoreRC", "fold"}
    for name, (r, local) in regs.items():
        assert 0 < r <= 255 and local == 0, (name, r, local)
    assert regs["K5"][0] <= 48 and regs["K5 ScoreRC"][0] <= 48, regs


def test_cast_rays_on_card_match_cpu(card):
    """100,000 rays: the card casts them in one launch, the CPU in chunks of
    30,000 through the plain version; hit and prim ids are equal, t
    agrees."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.raycast import cast_rays

    m = _exact_mesh("building")
    cpu = torch.device("cpu")
    o, d = _scattered_rays(m, cpu, n=100000, seed=17)
    g = cast_rays(build_bvh(m, device=card), o.to(card), d.to(card), t_max=8.0)
    c = cast_rays(build_bvh(m, device=cpu), o, d, t_max=8.0, chunk_size=30000)
    assert torch.equal(g.hit.cpu(), c.hit) and bool(c.hit.float().mean() > 0.5)
    assert torch.equal(g.prim_id.cpu(), c.prim_id)
    torch.testing.assert_close(g.t.cpu(), c.t, rtol=T_TOL, atol=T_TOL)


def _tie_queries(mesh, dev, n=500, seed=11):
    """Queries on mesh vertices and on edge midpoints: several triangles
    then lie at the same least distance."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices.astype(np.float32)
    f = mesh.faces[rng.integers(0, mesh.faces.shape[0], n)]
    mid = (v[f[:, 0]] + v[f[:, 1]]) * np.float32(0.5)
    return torch.from_numpy(np.concatenate([v[rng.integers(0, v.shape[0], n)], mid])).to(dev)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("mesh,max_dist", [
    ("room", 3.0e38),
    ("room", 0.25),
    ("sphere", 1.0),
    ("building", 0.5),
])
def test_closest_bvh_kernel_matches_plain_version(card, mesh, max_dist, split):
    """Each split P the wrapper can take, on scattered queries and on
    vertex and edge-midpoint queries (equal-distance ties): the kernel
    equals the plain version at the same P bitwise, and its winners are
    the serial walk's but at the float near-ties tests/
    test_torch_closest_point.py characterises."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh, closest_bvh_reference

    m = _exact_mesh(mesh)
    bvh = build_bvh(m, device=card)
    q = torch.cat([_points_in(m, card, 3000, 9, 0.1), _tie_queries(m, card)]).contiguous()
    md = torch.tensor(max_dist, dtype=torch.float32, device=card)
    max_d2 = (md * md).expand(q.shape[0]).contiguous()
    before = closest_bvh.launches
    k = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True, split=split)
    p = closest_bvh_reference(bvh.nodes, bvh.root_link, q, max_d2, visits=True, split=split)
    torch.cuda.synchronize()
    assert closest_bvh.launches == before + 1
    assert (p[2] >= 0).float().mean() > 0.2
    for a, b in zip(k, p):  # best_d2, point, slot, visits: bitwise
        assert torch.equal(a, b)
    serial = closest_bvh_reference(bvh.nodes, bvh.root_link, q, max_d2, split=1)
    off = k[2] != serial[2]
    assert off.float().mean() <= 0.005
    torch.testing.assert_close(k[0][off].sqrt(), serial[0][off].sqrt(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh,B,Rq,max_dist,groups", [
    ("room", 8, 128, 3.0e38, 1),
    ("room", 8, 128, 3.0e38, 8),  # one triangle a lane
    ("room", 8, 100, 3.0e38, 8),
    ("sphere", 32, 128, 0.5, 1),
    ("sphere", 32, 128, 0.5, 4),
    ("sphere", 64, 100, 1.0, 1),  # the last warp of each block is partly idle
    ("sphere", 64, 100, 1.0, 2),
    ("sphere", 64, 100, 1.0, 8),  # partial lane groups at the block's end
    ("building", 64, 128, 0.5, 1),
    ("building", 64, 128, 0.5, 2),
    ("building", 64, 128, 0.5, 4),
    ("building", 64, 128, 0.5, 8),
    ("sphere", 512, 128, 2.0, 1),  # the largest bin MeshMap builds
    ("sphere", 512, 128, 2.0, 8),
])
def test_closest_bins_kernel_matches_plain_version(card, mesh, B, Rq, max_dist, groups):
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bins_reference
    from rmcl_tpu_torch.ops.closest_point import _max_d2, binned_inputs

    m = _exact_mesh(mesh)
    bins = build_bins(m, bin_size=B, bins_per_super=8, device=card)
    q = _points_in(m, card, 3000, 9, 0.1)
    inputs = binned_inputs(bins, q, _max_d2(max_dist, q.shape[:1], card, cap=1.7e19), Rq,
                           c_super=8, c_bin=64)[:5]
    before = closest_bins.launches
    k = closest_bins(bins.tri, *inputs, groups=groups)
    p = closest_bins_reference(bins.tri, *inputs)
    torch.cuda.synchronize()
    assert closest_bins.launches == before + 1
    assert (p[1] >= 0).float().mean() > 0.05  # some queries lie within max_dist
    for a, b in zip(k, p):  # best_key, best_bin: bitwise
        assert torch.equal(a, b)


def test_closest_kernels_take_the_documented_splits(card):
    """The wrappers' own choice (PERF.md): K6 walks one scan's 14,400
    queries with P = 8 and 1M queries with P = 1 (the visits show which
    walk ran); K6b takes G = 8 at 113 blocks of 128 and G = 2 at 7,813.
    The rules count the card's own resident threads: an H100's 132 x 2048."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.closest_cuda import bins_groups, closest_bvh, fill_threads

    assert fill_threads(card) == 132 * 2048
    m = _exact_mesh("building")
    bvh = build_bvh(m, device=card)
    for n, P in ((14400, 8), (1 << 20, 1)):
        q = _points_in(m, card, n, 13, 0.1)
        max_d2 = torch.full((n,), 0.25, device=card)
        auto = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True)
        forced = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True, split=P)
        other = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True, split=9 - P)
        assert torch.equal(auto[3], forced[3]) and not torch.equal(auto[3], other[3])
    assert bins_groups(113, 128, 64, card) == 8
    assert bins_groups(7813, 128, 64, card) == 2


def test_closest_points_on_card_match_cpu_above_chunk_size(card):
    """100,000 queries, above closest_points' CPU chunk of 65,536: the card
    walks them in one launch at P = walk_split(100,000) = 2, the CPU in two
    chunks at the same P (a chunk alone would take P = 4, and on these
    queries the walks at P = 2 and 4 part at a near-tie), so the winners,
    points, normals and squared distances are bitwise equal; each device
    then takes its own square root, which may round apart."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh_reference, walk_split
    from rmcl_tpu_torch.ops.closest_point import closest_points

    m = _exact_mesh("room")
    cpu = torch.device("cpu")
    q = torch.cat([_points_in(m, cpu, 98000, 9, 0.1), _tie_queries(m, cpu, n=1000)]).contiguous()
    assert (walk_split(q.shape[0], card), walk_split(65536, card)) == (2, 4)
    g, c = (closest_points(build_bvh(m, device=dev), q.to(dev), max_dist=0.5)
            for dev in (card, cpu))
    for f in ("point", "normal", "prim_id", "found"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f))
    # the squared distance from the (equal) points, with the walks' arithmetic
    found = c.found
    e = q[found] - c.point[found]
    d2 = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
    assert torch.equal(c.dist[found], d2.sqrt())
    assert torch.equal(g.dist[found.to(card)], d2.to(card).sqrt())
    bvh = build_bvh(m, device=cpu)
    md = torch.full((q.shape[0],), 0.25)
    a, b = (closest_bvh_reference(bvh.nodes, bvh.root_link, q, md, split=P)[2] for P in (2, 4))
    assert bool((a != b).any())


def test_exact_kernels_refuse_misaligned_nodes(card):
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    bvh = build_bvh(_exact_mesh("room"), device=card)
    flat = torch.empty(bvh.nodes.numel() + 1, device=card)
    nodes = flat[1:].view(bvh.nodes.shape)
    nodes.copy_(bvh.nodes)
    o, d, t_min, t_max = _vlp16_rays((0.5, -0.3, 1.0), card)
    with pytest.raises(ValueError, match="16-byte"):
        traverse_rays(nodes, bvh.root_link, o, d, t_min, t_max)


def test_exact_paths_on_card_match_cpu(card):
    """cast_rays, closest_points (exact, binned, seeded) and CP/RC
    corrections on a BVH: the card's results equal the CPU's (the kernels
    and the plain versions round alike), one launch of each kernel a call."""
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.ops import closest_cuda, traverse_cuda
    from rmcl_tpu_torch.ops.closest_point import closest_points_seeded
    from rmcl_tpu_torch.ops.raycast import cast_rays

    mesh = MESHES["room"]()
    true_pose = [0.5, -0.3, 1.0, 0.0, 0.0, 0.3]
    start = [0.5, -0.3, 1.2, 0.0, 0.0, 0.35]
    model = SphericalModel.create(width=180, height=8, phi_min=-0.4, phi_max=0.3,
                                  range_max=30.0)
    out = []
    for dev in (card, torch.device("cpu")):
        mm = MeshMap.from_mesh(mesh, bin_size=32, device=dev)
        o, d = _scattered_rays(mesh, dev)
        counts0 = (traverse_cuda.traverse_rays.launches, closest_cuda.closest_bvh.launches,
                   closest_cuda.closest_bins.launches)
        hits = cast_rays(mm.bvh, o, d)
        cp = closest_points_seeded(mm.bvh, mm.bins, o, max_dist=0.5, c_super=8, c_bin=64)
        truth = simulate(mm.bvh, model, Transform.from_pose_tuple(true_pose, device=dev))
        poses = []
        for bvh, corr in ((mm.bvh, "RC"), (mm.bvh, "CP"), (mm.bins, "CP")):
            sensor = tp.MICPSensorData(
                model=model, points=truth.point, mask=truth.hit,
                tsb=Transform.identity(device=dev),
                config=tp.MICPSensorConfig.create(max_dist=0.5, corr_type=corr))
            tom = Transform.from_pose_tuple(start, device=dev)
            progress = torch.zeros((), device=dev)
            for _ in range(3):
                tom, stats = tp.correct_once(bvh, [sensor], tom, Transform.identity(device=dev),
                                             progress)
                progress = stats.convergence_progress
            poses.append(tom)
        counts = (traverse_cuda.traverse_rays.launches - counts0[0],
                  closest_cuda.closest_bvh.launches - counts0[1],
                  closest_cuda.closest_bins.launches - counts0[2])
        # card: cast 1 + simulate 1 + 3 RC corrections; seeded 1 + 3 CP on the
        # BVH; seeded 1 + 3 CP on the bins. CPU: none
        assert counts == ((5, 4, 4) if dev.type == "cuda" else (0, 0, 0))
        out.append((hits, cp, poses))
    (g_hits, g_cp, g_poses), (c_hits, c_cp, c_poses) = out
    assert torch.equal(g_hits.hit.cpu(), c_hits.hit)
    torch.testing.assert_close(g_hits.t.cpu(), c_hits.t, rtol=T_TOL, atol=T_TOL)
    assert torch.equal(g_hits.prim_id.cpu(), c_hits.prim_id)
    assert torch.equal(g_cp.found.cpu(), c_cp.found)
    torch.testing.assert_close(g_cp.dist.cpu(), c_cp.dist, rtol=T_TOL, atol=T_TOL)
    for g, c in zip(g_poses, c_poses):
        torch.testing.assert_close(g.trans.cpu(), c.trans, rtol=0.0, atol=POSE_TOL)


# --- the MCL slice: the seeded engine and the sensor update ---


def _mcl_world(dev):
    """The small building (4,136 faces): its BVH and bins of 8 (16 a super,
    4 a mid) on ``dev``, and a scan at a pose in its rooms."""
    from rmcl_tpu_torch.bvh.builder import build_bvh

    mesh = _exact_mesh("building")
    bvh = build_bvh(mesh, device=dev)
    bins = build_bins(mesh, bin_size=8, bins_per_super=16, bins_per_mid=4, device=dev)
    model = SphericalModel.create(width=180, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    hits = simulate(bvh, model, Transform.from_pose_tuple([3.1, 2.9, 1.5, 0, 0, 0.3],
                                                          device=dev))
    return bvh, bins, hits.point, hits.hit


def _mcl_cloud(dev, n=2000, seed=4):
    from rmcl_tpu_torch.mcl.particles import ParticleCloud

    rng = np.random.default_rng(seed)
    xyz = np.float32([3.1, 2.9, 1.5]) + rng.normal(scale=[0.5, 0.5, 0.05], size=(n, 3))
    eul = np.zeros((n, 3), np.float32)
    eul[:, 2] = 0.3 + rng.normal(scale=0.2, size=n)
    poses = Transform.from_xyz_euler(torch.from_numpy(xyz.astype(np.float32)).to(dev),
                                     torch.from_numpy(eul).to(dev))
    return ParticleCloud.create(n, device=dev).with_poses(poses)


def test_cast_rays_seeded_on_card_matches_cpu(card):
    """The seeded engine on the card (K3 with the lossless flags, K1 in
    count order, K5 on the uncertified rays) against the CPU's plain
    versions: hits and prim ids equal, t within T_TOL."""
    from rmcl_tpu_torch.ops.cull_cuda import cull_rays
    from rmcl_tpu_torch.ops.raycast import cast_rays_seeded
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    cpu = torch.device("cpu")
    g_bvh, g_bins, *_ = _mcl_world(card)
    c_bvh, c_bins, *_ = _mcl_world(cpu)
    o, d = _scattered_rays(_exact_mesh("building"), cpu, n=20000, seed=3)
    launches = (cull_rays.launches, intersect_bins.launches, traverse_rays.launches)
    g = cast_rays_seeded(g_bvh, g_bins, o.to(card), d.to(card), t_max=12.0, c_mid=8)
    c = cast_rays_seeded(c_bvh, c_bins, o, d, t_max=12.0, c_mid=8)
    assert (cull_rays.launches, intersect_bins.launches, traverse_rays.launches) == tuple(
        x + 1 for x in launches)
    assert float(c.hit.float().mean()) > 0.5
    assert torch.equal(g.hit.cpu(), c.hit) and torch.equal(g.prim_id.cpu(), c.prim_id)
    torch.testing.assert_close(g.t.cpu(), c.t, rtol=T_TOL, atol=T_TOL)


@pytest.mark.parametrize("engine", ["bvh", "seeded", "binned"])
def test_sensor_update_on_card_matches_cpu(card, engine):
    """One sensor update on one injected beam set, on the card and on the
    CPU: the likelihoods agree within 1e-5 relative (the fold's sums run in
    another order on the card)."""
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig, sample_beams, sensor_update

    cpu = torch.device("cpu")
    out = {}
    for dev in (card, cpu):
        bvh, bins, points, mask = _mcl_world(dev)
        beams = sample_beams(torch.Generator().manual_seed(6), points.cpu(), mask.cpu(), 48)
        beams = tuple(x.to(dev) for x in beams)
        accel = {"bvh": bvh, "binned": bins, "seeded": (bvh, bins)}[engine]
        cfg = SensorUpdateConfig.create(samples=48, engine=engine, dist_sigma=0.4,
                                        layout="particle", c_super=32, c_bin=256, c_mid=16)
        lik = sensor_update(accel, _mcl_cloud(dev), None, None, None,
                            Transform.identity(device=dev), cfg, beams=beams).likelihood
        out[dev.type] = lik
    torch.testing.assert_close(out["cuda"].mean.cpu(), out["cpu"].mean, rtol=1e-5, atol=1e-7)
    assert torch.equal(out["cuda"].n_meas.cpu(), out["cpu"].n_meas)


def _walk_score_inputs(dev, case, n=4096, S=100):
    """walk_score_rc's inputs on ``dev`` for the small building: n particles
    about the scan's pose and S beams drawn from the scan; "edges" lifts
    every tenth particle above the roof, makes a third of the beams real
    misses and measures some at half their surface's distance, with
    range_min 0.9 m and the cap at 2 sigma (every branch of the score)."""
    from rmcl_tpu_torch.mcl.sensor_update import (SensorUpdateConfig, beam_layout,
                                                  cluster_poses, sample_beams, score_beams)

    bvh, _, points, mask = _mcl_world(dev)
    cloud = _mcl_cloud(dev, n=n)
    if case == "edges":
        t = cloud.poses.trans.clone()
        t[::10, 2] += 20.0
        cloud = cloud.with_poses(Transform(rot=cloud.poses.rot, trans=t))
    dirs, ranges, valid = (x.to(dev) for x in sample_beams(
        torch.Generator().manual_seed(6), points.cpu(), mask.cpu(), S))
    kw = dict(samples=S, engine="bvh", dist_sigma=0.4, range_max=30.0)
    if case == "edges":
        ranges, valid = ranges.clone(), valid.clone()
        valid[0::6] = False
        ranges[1::6] = 45.0
        ranges[2::6] = 0.05
        ranges[3::6] *= 0.5
        kw.update(range_min=0.9, range_cap_sigmas=2.0, real_miss_sim_miss_error=0.25)
    cfg = SensorUpdateConfig.create(**kw)
    layout = beam_layout(cfg, (dirs, ranges, valid))
    tsm, _ = cluster_poses(cloud, Transform.identity(device=dev), cfg)
    args = (bvh.nodes, bvh.root_link, torch.cat([tsm.rot, tsm.trans], dim=-1),
            score_beams(layout))
    return args, dict(range_min=cfg.range_min, hit_miss=cfg.real_hit_sim_miss_error,
                      miss_hit=cfg.real_miss_sim_hit_error,
                      miss_miss=cfg.real_miss_sim_miss_error, dist_sigma=cfg.dist_sigma)


@pytest.mark.parametrize("case", ["scan", "edges"])
def test_walk_score_kernel_matches_plain_version(card, case):
    """MCL's scored walk (K5's ScoreRC instantiation and the fold kernel) on
    4,096 particles x 100 beams of the building against its plain version
    on the CPU: one K5 and one fold launch; the per-ray evals within 1e-5
    relative but on at most 1e-4 of the rays (a near-tie's other winner, or
    a direction the card's and the CPU's cross products round a bit apart);
    the folds within 1e-6 relative at p75."""
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, walk_score_rc

    args, kw = _walk_score_inputs(card, case)
    before = (traverse_rays.launches, walk_score_rc.fold_launches)
    k_mean, k_var, k_ev = walk_score_rc(*args, evals=True, **kw)
    torch.cuda.synchronize()
    assert (traverse_rays.launches, walk_score_rc.fold_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    p_mean, p_var, p_ev = walk_score_rc(*(x.cpu() for x in args), evals=True, **kw)
    assert (traverse_rays.launches, walk_score_rc.fold_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    rel = lambda a, b: (a.cpu().double() - b.double()).abs() / b.double().abs().clamp(
        min=1e-30)
    off = rel(k_ev, p_ev) > 1e-5
    assert int(off.sum()) <= 1e-4 * off.numel(), int(off.sum())
    assert float(torch.quantile(rel(k_mean, p_mean), 0.75)) <= 1e-6
    assert float(torch.quantile(rel(k_var, p_var), 0.75)) <= 1e-6
    assert bool((p_ev > 1e-3).float().mean() > 0.3)  # most beams score a near surface


def test_walk_score_runs_once_an_update(card):
    """A sensor update on the exact walk with RC: one K5 launch (counted in
    traverse_rays.launches, as the benchmark's trace check reads it), one
    fold launch and one count of ``rmcl.mcl.walk_score``; the node's
    likelihoods within 1e-5 of the CPU's."""
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig, sample_beams, sensor_update
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, walk_score_rc
    from rmcl_tpu_torch.utils import timing

    cfg = SensorUpdateConfig.create(samples=100, engine="bvh", dist_sigma=0.4)
    lik = {}
    timing.set_tracing(True)
    try:
        for dev in (card, torch.device("cpu")):
            bvh, _, points, mask = _mcl_world(dev)
            beams = tuple(x.to(dev) for x in sample_beams(
                torch.Generator().manual_seed(2), points.cpu(), mask.cpu(), 100))
            cloud = _mcl_cloud(dev, n=3000)
            before = (traverse_rays.launches, walk_score_rc.fold_launches)
            for _ in range(2):
                lik[dev.type] = sensor_update(bvh, cloud, None, None, None,
                                              Transform.identity(device=dev), cfg,
                                              beams=beams).likelihood
            if dev.type == "cuda":
                assert (traverse_rays.launches, walk_score_rc.fold_launches) == (
                    before[0] + 2, before[1] + 2)
        assert timing.counters()["rmcl.mcl.walk_score"] == 4  # two a device
    finally:
        timing.set_tracing(False)
    torch.testing.assert_close(lik["cuda"].mean.cpu(), lik["cpu"].mean, rtol=1e-5, atol=1e-7)


def test_traverse_kernel_on_mcl_rays_matches_plain_version(card):
    """K5's cast instantiation (StoreHits) on MCL's rays as phase 10 casts
    them (particles x beams, the beams in angular order) on the building:
    t, slot and visits bitwise its plain version's, as before the walk
    became a template."""
    from rmcl_tpu_torch.mcl.sensor_update import (SensorUpdateConfig, _angular_order,
                                                  beam_layout, cluster_poses, sample_beams,
                                                  update_rays)
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, traverse_rays_reference

    bvh, _, points, mask = _mcl_world(card)
    beams = sample_beams(torch.Generator(device=card).manual_seed(3), points, mask, 100)
    cfg = SensorUpdateConfig.create(samples=100, engine="bvh", dist_sigma=0.4)
    layout = beam_layout(cfg, beams)
    tsm, _ = cluster_poses(_mcl_cloud(card, n=2000), Transform.identity(device=card), cfg)
    o, d, t_max = update_rays(tsm, layout)
    order = _angular_order(layout.dirs)
    rays = (o[:, order].reshape(-1, 3), d[:, order].reshape(-1, 3))
    t_max = t_max[:, order].reshape(-1).contiguous()
    t_min = torch.zeros_like(t_max)
    k = traverse_rays(bvh.nodes, bvh.root_link, *rays, t_min, t_max, visits=True)
    p = traverse_rays_reference(bvh.nodes, bvh.root_link, *rays, t_min, t_max, visits=True)
    assert (p[1] >= 0).float().mean() > 0.5
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_auto_engine_on_card_is_the_exact_walk(card):
    """``MCLNode`` with engine "auto" on a concentrated cloud on the card
    stays on the exact walk (the CPU's gate would flip to binned at the
    first update): no K1 or K3 launch, one K5 a sensor update, and every
    update's likelihoods bitwise those of a node with engine "bvh" that
    the same seed feeds the same draws."""
    import dataclasses

    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.mcl.node import MCLConfig, MCLNode
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig
    from rmcl_tpu_torch.ops.cull_cuda import cull_factored, cull_rays
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    bvh, bins, points, mask = _mcl_world(card)
    mm = MeshMap(mesh=_exact_mesh("building"), bvh=bvh, bins=bins)
    scfg = SensorUpdateConfig.create(samples=48, dist_sigma=0.3, engine="auto", c_super=32,
                                     c_bin=256)
    cov = torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4]))
    pose = Transform.from_pose_tuple([3.1, 2.9, 1.5, 0, 0, 0.3], device=card)
    tsb = Transform.identity(device=card)
    nodes = {}
    for engine in ("auto", "bvh"):
        cfg = MCLConfig(n_particles=2000, seed=3, auto_engine_period=1,
                        sensor=dataclasses.replace(scfg, engine=engine))
        node = MCLNode(mm, cfg)
        node.initial_pose_guess(pose, cov)
        node.motion_update(Transform.identity(device=card), 0.0)
        nodes[engine] = node
    auto, exact = nodes["auto"], nodes["bvh"]
    steps = 3
    before = (intersect_bins.launches, cull_rays.launches, cull_factored.launches,
              traverse_rays.launches)
    for step in range(steps):
        auto.sensor_update(points, mask, tsb)
        assert auto.effective_sensor_config().engine == "bvh"
        assert auto.last_audit is None
        after = (intersect_bins.launches, cull_rays.launches, cull_factored.launches,
                 traverse_rays.launches)
        assert after == before[:3] + (before[3] + 1,)
        exact.sensor_update(points, mask, tsb)
        assert torch.equal(auto.cloud.likelihood.mean, exact.cloud.likelihood.mean)
        assert torch.equal(auto.cloud.likelihood.sigma, exact.cloud.likelihood.sigma)
        before = (after[0], after[1], after[2], traverse_rays.launches)
        stamp = 0.1 * (step + 1)
        for node in (auto, exact):
            node.motion_update(Transform.identity(device=card), stamp)
            assert node.resample()
    assert bool(torch.isfinite(auto.cloud.likelihood.mean).all())


def test_auto_engine_for_cp_on_card_keeps_the_gate(card):
    """``MCLNode`` with engine "auto" and closest points (CP) on the card
    keeps the JAX gate: a concentrated cloud flips to the binned loop at
    the first gated update (one K6b launch, no K6, no budget audit), and
    its likelihoods agree with a node with engine "binned" fed the same
    draws."""
    import dataclasses

    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.mcl.node import MCLConfig, MCLNode
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bvh

    bvh, bins, points, mask = _mcl_world(card)
    mm = MeshMap(mesh=_exact_mesh("building"), bvh=bvh, bins=bins)
    scfg = SensorUpdateConfig.create(samples=48, correspondence_type="CP", dist_sigma=0.3,
                                     engine="auto")
    cov = torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4]))
    pose = Transform.from_pose_tuple([3.1, 2.9, 1.5, 0, 0, 0.3], device=card)
    tsb = Transform.identity(device=card)
    nodes = {}
    for engine in ("auto", "binned"):
        cfg = MCLConfig(n_particles=2000, seed=3, auto_engine_period=1,
                        sensor=dataclasses.replace(scfg, engine=engine))
        node = MCLNode(mm, cfg)
        node.initial_pose_guess(pose, cov)
        node.motion_update(Transform.identity(device=card), 0.0)
        nodes[engine] = node
    auto, binned = nodes["auto"], nodes["binned"]
    before = (closest_bins.launches, closest_bvh.launches)
    auto.sensor_update(points, mask, tsb)
    assert auto.effective_sensor_config().engine == "binned"
    assert auto.last_audit is None
    assert (closest_bins.launches, closest_bvh.launches) == (before[0] + 1, before[1])
    binned.sensor_update(points, mask, tsb)
    assert torch.equal(auto.cloud.likelihood.mean, binned.cloud.likelihood.mean)
    assert bool(torch.isfinite(auto.cloud.likelihood.mean).all())


# --- the closest-point candidate cull (K7) and the MICP node ---

def _cp_blocks(mesh, dev, B, S, n, max_dist, Rq=128, seed=9):
    """Query blocks (cluster order, the last partly padding) of n points in
    the mesh's box, and the bins they are culled against."""
    from rmcl_tpu_torch.ops.closest_point import _max_d2
    from rmcl_tpu_torch.ops.order import cluster_order

    bins = build_bins(mesh, bin_size=B, bins_per_super=S, device=dev)
    q = _points_in(mesh, dev, n, seed, 0.1)
    q = q[cluster_order(q, None)[0].long()]
    md = _max_d2(max_dist, q.shape[:1], dev, cap=1.7e19)
    pad = (-n) % Rq
    qb = torch.cat([q, q.new_zeros((pad, 3))]).reshape(-1, Rq, 3).contiguous()
    d2b = torch.cat([md, md.new_zeros((pad,))]).reshape(-1, Rq).contiguous()
    return bins, qb, d2b


def _k7_exact_budgets(bins, qb, d2b, blk):
    """Budgets (cs, cb) at which block blk's levels pass exactly what they
    keep: cs its supers within reach, then cb its bins within reach of
    those."""
    from rmcl_tpu_torch.ops import closest_point

    qlo, qhi = qb[blk].amin(dim=0), qb[blk].amax(dim=0)
    d2 = closest_point._box_box_d2(qlo, qhi, bins.super_aabb[:, :3], bins.super_aabb[:, 3:])
    cs = int((d2 <= d2b[blk].amax()).sum())
    every = closest_point._cp_candidates(bins, qb[blk:blk + 1], d2b[blk:blk + 1].amax(dim=1), cs,
                                         cs * bins.bins_per_super)
    return cs, int(every[1][0])


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("mesh,B,S,max_dist,cs,cb,case", [
    ("room", 8, 8, 3.0e38, 24, 96, "packed"),  # every box within reach
    ("room", 8, 8, 0.25, 24, 96, "float"),  # the float keys of large maps (rule forced)
    ("building", 16, 16, 0.5, 24, 96, "packed"),
    ("building", 16, 16, 0.5, 3, 20, "packed"),  # saturating budgets: the select at both levels
    ("building", 16, 16, 0.5, 3, 20, "float"),
    ("building", 8, 64, 1.0, 24, 96, "zero_bound"),  # blocks with max_d2 = 0
    ("sphere", 16, 16, 0.5, 39, 624, "packed"),  # phase 9's widest list shape
    ("sphere", 16, 16, 2.0, 8, 128, "float"),
    ("building", 16, 16, 0.5, 3, 20, "streamed"),  # no stage: every pass recomputes its tests
    ("building", 16, 16, 0.5, 3, 20, "streamed float"),
    ("building", 16, 16, 0.5, None, None, "exact"),  # a block passes exactly cs, then cb
    ("sphere128", 1, 64, 3.0e38, 300, 2000, "packed"),  # cs x S = 19,200 past the old cap
    ("sphere128", 1, 64, 3.0e38, 300, 2000, "float"),
    ("sphere128", 1, 1, 3.0e38, 96, 96, "packed"),  # n_super = 32,512 past the old cap
])
def test_cp_candidates_kernel_matches_plain_version(card, monkeypatch, mesh, B, S, max_dist, cs,
                                                    cb, case, width):
    """K7 bitwise its plain version (lists, counts, bounds), 3,000 queries:
    23 blocks of 128, the last partly padding; at both CTA widths, through
    the stage and streamed, with levels wider than 16,384 keys."""
    from rmcl_tpu_torch.ops import closest_cuda, closest_point
    from rmcl_tpu_torch.ops.closest_cuda import cp_candidates

    if "float" in case:
        monkeypatch.setattr(closest_point, "_PACKED_ID_BITS", 0)
    if "streamed" in case:
        monkeypatch.setattr(closest_cuda, "_K7_STAGE_MAX", 0)
    monkeypatch.setattr(closest_cuda, "_K7_WIDE_KEYS", 0 if width == "wide" else 1 << 30)
    m = make_sphere(128, 128, radius=5.0) if mesh == "sphere128" else _exact_mesh(mesh)
    bins, qb, d2b = _cp_blocks(m, card, B, S, 3000, max_dist)
    if case == "zero_bound":
        d2b[::3] = 0.0  # whole blocks that reach nothing but their own box
        d2b[1, :64] = 0.0  # and half of a block
    if case == "exact":
        cs, cb = _k7_exact_budgets(bins, qb, d2b, 11)
    cs, cb = min(cs, bins.n_super), min(cb, bins.n_bins, min(cs, bins.n_super) * S)
    threads = closest_cuda.cp_launch_plan(qb.shape[0], bins.n_super, S, cs, cb,
                                          closest_cuda.fill_threads(card))[0]
    assert threads == (512 if width == "wide" else 128)
    before = cp_candidates.launches
    k = cp_candidates(bins, qb, d2b, cs, cb)
    p = closest_point._cp_candidates(bins, qb, torch.amax(d2b, dim=1), cs, cb)
    torch.cuda.synchronize()
    assert cp_candidates.launches == before + 1  # the plain version is not counted
    assert float(p[1].float().mean()) > 1  # the lists are not trivial
    if cs == 3:
        assert bool((p[1] == cb).any())  # the budget truncates somewhere
    if case == "exact":
        assert int(p[1][11]) == cb and bool((p[1] < cb).any())
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("budgets", ["whole", "supers_cut", "bins_cut", "both_cut"])
def test_cp_candidates_sat_on_card_matches_plain_version(card, monkeypatch, budgets, width):
    """K7's per-block ``sat`` bitwise its plain version's, at budgets that
    cut no block (the widest block's need exactly), one short of the widest
    need of supers, of bins, and of both; the flags then mark exactly the
    blocks whose need passes a budget (the last block partly padding)."""
    from rmcl_tpu_torch.ops import closest_cuda, closest_point
    from rmcl_tpu_torch.ops.closest_cuda import cp_candidates
    from rmcl_tpu_torch.utils.tune import cp_block_need

    monkeypatch.setattr(closest_cuda, "_K7_WIDE_KEYS", 0 if width == "wide" else 1 << 30)
    bins, qb, d2b = _cp_blocks(_exact_mesh("building"), card, 16, 16, 3000, 0.5)
    need_s, need_b = cp_block_need(bins, qb, d2b)
    cs, cb = int(need_s.max()), int(need_b.max())
    cs -= budgets in ("supers_cut", "both_cut")
    cb -= budgets in ("bins_cut", "both_cut")
    cs, cb = closest_point.cp_budgets(bins, cs, cb)
    k = cp_candidates(bins, qb, d2b, cs, cb)
    p = closest_point._cp_candidates(bins, qb, torch.amax(d2b, dim=1), cs, cb)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if budgets == "whole":
        assert not bool(k[3].any())
    else:
        assert bool(k[3].any()) and not bool(k[3].all())
    assert torch.equal(k[3], (need_s > cs) | (need_b > cb))


def test_cp_candidates_kernel_has_no_spills(card):
    from rmcl_tpu_torch.ops.closest_cuda import kernel_registers

    regs = kernel_registers()
    for name in ("K7", "K7 wide"):  # 128 and 512 threads a CTA
        assert 0 < regs[name][0] <= 255 and regs[name][1] == 0


def test_cp_candidates_refuses_what_it_cannot_hold(card):
    from rmcl_tpu_torch.ops.closest_cuda import cp_candidates
    from rmcl_tpu_torch.ops.closest_point import _cp_candidates

    bins, qb, d2b = _cp_blocks(_exact_mesh("building"), card, 8, 8, 300, 1.0)
    cs = bins.n_super
    with pytest.raises(ValueError, match="budgets"):
        cp_candidates(bins, qb, d2b, cs + 1, 8)
    with pytest.raises(ValueError, match="budgets"):
        cp_candidates(bins, qb, d2b, cs, cs * 8 + 1)
    with pytest.raises(ValueError, match="contiguous"):
        cp_candidates(bins, qb.transpose(0, 1).contiguous().transpose(0, 1), d2b, cs, 8)
    with pytest.raises(ValueError, match="is on"):
        cp_candidates(bins, qb.cpu(), d2b, cs, 8)
    # only a kept list past a CTA's shared memory is refused, whatever the
    # levels' widths (sphere128, B 1: 32,512 supers of one bin, or 508 of 64)
    sph = make_sphere(128, 128, radius=5.0)
    wide, qw, dw = _cp_blocks(sph, card, 1, 64, 300, 3.0e38)
    with pytest.raises(ValueError, match="cb=30000"):
        cp_candidates(wide, qw, dw, 500, 30000)
    k = cp_candidates(wide, qw, dw, 500, 28000)
    many, qm, dm = _cp_blocks(sph, card, 1, 1, 300, 3.0e38)
    k1 = cp_candidates(many, qm, dm, 4096, 8)
    torch.cuda.synchronize()
    assert many.n_super > 16384 and bool((k[1] == 28000).all()) and bool((k1[1] == 8).all())
    for got, (b, q, d, cs, cb) in ((k, (wide, qw, dw, 500, 28000)), (k1, (many, qm, dm, 4096, 8))):
        want = _cp_candidates(b, q, torch.amax(d, dim=1), cs, cb)
        assert all(torch.equal(x, y) for x, y in zip(got, want))  # the lists held bitwise


def test_closest_points_binned_on_card_matches_cpu(card, monkeypatch):
    """The binned query on the card: one K7 launch a query and no torch
    candidate cull; the winners equal the CPU's, distances within 1e-6
    relative (each device takes its own square root)."""
    from rmcl_tpu_torch.ops import closest_point
    from rmcl_tpu_torch.ops.closest_cuda import cp_candidates

    m = _exact_mesh("building")
    q = _points_in(m, torch.device("cpu"), 20000, 4, 0.1)
    cpu_out = closest_point.closest_points_binned(
        build_bins(m, bin_size=16, bins_per_super=16, device="cpu"), q, max_dist=0.5)

    def no_plain(*_args):
        raise AssertionError("the torch candidate cull ran on the card")

    monkeypatch.setattr(closest_point, "_cp_candidates", no_plain)
    before = cp_candidates.launches
    out = closest_point.closest_points_binned(
        build_bins(m, bin_size=16, bins_per_super=16, device=card), q.to(card), max_dist=0.5)
    torch.cuda.synchronize()
    assert cp_candidates.launches == before + 1
    for f in ("prim_id", "found"):
        assert torch.equal(getattr(out, f).cpu(), getattr(cpu_out, f))
    assert 0.05 < float(cpu_out.found.float().mean()) < 1.0
    torch.testing.assert_close(out.dist.cpu(), cpu_out.dist, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out.point.cpu(), cpu_out.point, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("engine,corr", [("binned", "RC"), ("binned", "CP"), ("bvh", "CP")])
def test_node_step_on_card_matches_cpu(card, engine, corr):
    """MICPLocalization on the card and on the CPU, fed the same scans: Tom
    after every step within POSE_TOL (the reductions run in another order
    on the card); the card's node built the kernels at construction and its
    corrections launch them."""
    from rmcl_tpu_torch.config.tree import ParamTree
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.io import msgs
    from rmcl_tpu_torch.io.conversions import model_to_scan_info
    from rmcl_tpu_torch.micp.node import MICPLocalization
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bvh, cp_candidates

    mesh = MESHES["room"]()
    cpu = torch.device("cpu")
    model = SphericalModel.create(width=180, height=8, phi_min=-0.4, phi_max=0.3,
                                  range_max=30.0)
    cpu_map = MeshMap.from_mesh(mesh, bin_size=32, bins_per_super=8, device=cpu)
    scans = []
    for k in range(4):
        true = [0.5 + 0.02 * k, -0.3, 1.0, 0.0, 0.0, 0.3 + 0.01 * k]
        hits = simulate(cpu_map.bvh, model, Transform.from_pose_tuple(true, device=cpu))
        ranges = torch.where(hits.hit, hits.t, 0.0).numpy()
        scans.append((0.1 * k, true, ranges, hits.hit.numpy()))
    config = {"engine": engine, "initial_pose_guess": [0.5, -0.3, 1.2, 0.0, 0.0, 0.35],
              "sensors": {"lidar": {"correspondences": {"type": corr, "max_dist": 0.5}}}}
    trails = {}
    launches = {}
    for dev in (card, cpu):
        node = MICPLocalization(MeshMap.from_mesh(mesh, bin_size=32, bins_per_super=8,
                                                  device=dev), ParamTree(config))
        before = {k: f.launches for k, f in (("K7", cp_candidates), ("K6b", closest_bins),
                                             ("K6", closest_bvh), ("K1", intersect_bins))}
        trail = []
        for stamp, true, ranges, mask in scans:
            node.on_odometry(Transform.from_pose_tuple(true, device=cpu), stamp=stamp)
            node.on_scan("lidar", msgs.ScanStamped(msgs.Header(stamp), model_to_scan_info(model),
                                                   msgs.RangeData(ranges=ranges, mask=mask)))
            node.step()
            trail.append(node.tom)
        trails[dev.type] = trail
        launches[dev.type] = {k: f.launches - before[k] for k, f in (
            ("K7", cp_candidates), ("K6b", closest_bins), ("K6", closest_bvh),
            ("K1", intersect_bins))}
    for g, c in zip(trails["cuda"], trails["cpu"]):
        torch.testing.assert_close(g.trans.cpu(), c.trans, rtol=0.0, atol=POSE_TOL)
    want = {("binned", "RC"): "K1", ("binned", "CP"): "K7", ("bvh", "CP"): "K6"}[(engine, corr)]
    assert launches["cuda"][want] == len(scans) and launches["cpu"][want] == 0
    if want == "K7":
        assert launches["cuda"]["K6b"] == len(scans)


# --- the differentiable cast, scene graphs and the TLAS ---


def _scene_launches():
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh
    from rmcl_tpu_torch.ops.cull_cuda import cull_rays
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    return {"K1": intersect_bins, "K3": cull_rays, "K5": traverse_rays, "K6": closest_bvh}


def _count(fn):
    """(result of fn(), the launches it made of K1, K3, K5 and K6)."""
    wrappers = _scene_launches()
    before = {k: f.launches for k, f in wrappers.items()}
    out = fn()
    return out, {k: f.launches - before[k] for k, f in wrappers.items()}


@pytest.mark.parametrize("engine", ["bvh", "bins"])
def test_cast_rays_diff_on_card_matches_cpu(card, engine):
    """cast_rays_diff on the card against the CPU's plain run: the winners
    equal (K5 bitwise its plain version; K1 on K3's lists), t and the
    vertex gradient within T_TOL (the card's rsqrt and the vertex
    gradient's scatter-add of atomics round apart from the CPU's), and the
    kernels launched, one cast each."""
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.diff import cast_rays_diff

    mesh = make_sphere(48, 48, radius=2.0)
    kw = dict(block_size=128, sort_blocks=True, c_super=64, c_bin=1024) if engine == "bins" else {}
    rng = np.random.default_rng(3)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-0.5, 0.5, (4096, 3)).astype(np.float32)
    out = {}
    for dev in (card, torch.device("cpu")):
        struct = (build_bvh(mesh, device=dev) if engine == "bvh"
                  else build_bins(mesh, bin_size=32, bins_per_super=8, device=dev))
        verts = torch.from_numpy(mesh.vertices.copy()).to(dev).requires_grad_(True)
        orig = torch.from_numpy(o).to(dev).requires_grad_(True)
        faces, dirs = torch.from_numpy(mesh.faces).to(dev), torch.from_numpy(d).to(dev)
        h, launches = _count(lambda: cast_rays_diff(struct, verts, faces, orig, dirs, **kw))
        torch.where(h.hit, h.t, 0.0).sum().backward()
        out[dev.type] = (h, verts.grad, orig.grad, launches)
    (g, gv, go, gl), (c, cv, co, cl) = out["cuda"], out["cpu"]
    want = {"K5": 1} if engine == "bvh" else {"K1": 1, "K3": 1}
    assert {k: v for k, v in gl.items() if v} == want and not any(cl.values())
    assert torch.equal(g.hit.cpu(), c.hit) and float(c.hit.float().mean()) > 0.99
    assert torch.equal(g.prim_id.cpu(), c.prim_id)
    torch.testing.assert_close(g.t.detach().cpu(), c.t.detach(), rtol=T_TOL, atol=T_TOL)
    torch.testing.assert_close(gv.cpu(), cv, rtol=T_TOL, atol=T_TOL)
    torch.testing.assert_close(go.cpu(), co, rtol=T_TOL, atol=T_TOL)


def _mixed_scene(dev):
    """``tests/test_tlas.py``'s scene in the port: two boxes (one at scale
    2) and a ball."""
    from rmcl_tpu_torch.geom.mesh import make_box
    from rmcl_tpu_torch.geom.scene import SceneGraph

    sg = SceneGraph()
    sg.add_geometry("box", make_box((1.0, 1.0, 1.0)))
    sg.add_geometry("ball", make_sphere(24, 24, radius=1.0))
    pose = lambda p: Transform.from_pose_tuple(p, device=dev)
    sg.add_instance("box", pose([4.0, 0, 0, 0, 0, 0.3]))
    sg.add_instance("box", pose([-4.0, 1.0, 0, 0, 0, 0]), scale=2.0)
    sg.add_instance("ball", pose([0.0, 5.0, 0.5, 0, 0, 0]))
    return sg


def _fan_rays(dev, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_tlas_on_card_matches_cpu(card):
    """cast_rays_tlas on the mixed scene (its scale-2 box included) on the
    card against the CPU's plain run: hits and ids equal, t and normals
    within T_TOL; one K3 and one K1 launch per instance, in count order; and
    against the flattened scene's exact cast (K5) on the card."""
    from rmcl_tpu_torch.geom.tlas import build_tlas, cast_rays_tlas
    from rmcl_tpu_torch.ops.raycast import cast_rays

    out = {}
    for dev in (card, torch.device("cpu")):
        tlas = build_tlas(_mixed_scene(dev), bin_size=16, bins_per_super=8, device=dev)
        o, d = _fan_rays(dev)
        out[dev.type] = _count(lambda: cast_rays_tlas(tlas, o, d, block_size=32,
                                                      sort_blocks=True, c_super=64, c_bin=256))
    (g, gl), (c, cl) = out["cuda"], out["cpu"]
    assert gl["K1"] == gl["K3"] == 3 and not any(cl.values())
    assert torch.equal(g.hit.cpu(), c.hit) and set(c.inst_id[c.hit].tolist()) == {0, 1, 2}
    assert torch.equal(g.inst_id.cpu(), c.inst_id) and torch.equal(g.prim_id.cpu(), c.prim_id)
    torch.testing.assert_close(g.t.cpu(), c.t, rtol=T_TOL, atol=T_TOL)
    torch.testing.assert_close(g.normal.cpu(), c.normal, rtol=0.0, atol=T_TOL)
    acc = _mixed_scene(card).build(bin_size=16, bins_per_super=8, device=card)
    o, d = _fan_rays(card)
    f = cast_rays(acc.bvh, o, d)
    assert torch.equal(f.hit, g.hit) and torch.equal(f.inst_id, g.inst_id)
    torch.testing.assert_close(f.t[f.hit], g.t[f.hit], rtol=T_TOL, atol=T_TOL)


def test_tlas_pose_gradients_through_the_kernels_match_cpu(card):
    """Gradients of the sum of hit t with respect to every instance's
    quaternion, translation and scale, requested through the kernel path
    (K3 + K1 on the card, with the chained t_max carrying grad), against the
    CPU's plain run within T_TOL."""
    from rmcl_tpu_torch.geom.tlas import build_tlas, cast_rays_tlas

    grads = {}
    for dev in (card, torch.device("cpu")):
        tlas = build_tlas(_mixed_scene(dev), bin_size=16, bins_per_super=8, device=dev)
        o, d = _fan_rays(dev, n=1024, seed=2)
        args = [x.clone().requires_grad_(True)
                for x in (tlas.poses.rot, tlas.poses.trans, tlas.scales)]
        (h, launches) = _count(lambda: cast_rays_tlas(
            tlas, o, d, poses=Transform(rot=args[0], trans=args[1]), scales=args[2],
            block_size=32))
        torch.where(h.hit, h.t, 0.0).sum().backward()
        assert launches["K1"] == (3 if dev.type == "cuda" else 0)
        grads[dev.type] = [a.grad for a in args]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        torch.testing.assert_close(g.cpu(), c, rtol=T_TOL, atol=T_TOL)


def test_closest_points_tlas_on_card_matches_cpu(card):
    """closest_points_tlas on the card (one K6 launch per instance, bounded
    by the best distance so far) against the CPU's plain run."""
    from rmcl_tpu_torch.geom.tlas import build_tlas, closest_points_tlas

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-6, 6, size=(4096, 3)).astype(np.float32))
    out = {}
    for dev in (card, torch.device("cpu")):
        tlas = build_tlas(_mixed_scene(dev), bin_size=16, bins_per_super=8, device=dev)
        out[dev.type] = _count(lambda: closest_points_tlas(tlas, q.to(dev), max_dist=4.0))
    ((g, gi), gl), ((c, ci), cl) = out["cuda"], out["cpu"]
    assert gl["K6"] == 3 and not any(cl.values())
    assert torch.equal(g.found.cpu(), c.found) and torch.equal(gi.cpu(), ci)
    assert torch.equal(g.prim_id.cpu(), c.prim_id)
    torch.testing.assert_close(g.dist.cpu(), c.dist, rtol=T_TOL, atol=T_TOL)
    torch.testing.assert_close(g.point.cpu(), c.point, rtol=0.0, atol=T_TOL)


def test_refine_instance_pose_on_card_matches_cpu(card):
    """refine_instance_pose on the card (its local BVH built there, one K5
    launch a step) against the CPU: the losses and the refined centre."""
    from rmcl_tpu_torch.geom.scene import SceneGraph, refine_instance_pose
    from rmcl_tpu_torch.ops.raycast import cast_rays

    rng = np.random.default_rng(0)
    d = np.stack([np.ones(256), rng.uniform(-0.2, 0.2, 256), rng.uniform(-0.2, 0.2, 256)], -1)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    res = {}
    for dev in (card, torch.device("cpu")):
        scenes = []
        for p in ([4.0, 0.15, -0.1, 0, 0, 0], [4.0, 0.0, 0.0, 0, 0, 0]):
            sg = SceneGraph()
            sg.add_geometry("ball", make_sphere(32, 32, radius=1.0))
            sg.add_instance("ball", Transform.from_pose_tuple(p, device=dev))
            scenes.append(sg.build(bin_size=16, bins_per_super=8, device=dev))
        o = torch.zeros((256, 3), device=dev)
        meas = cast_rays(scenes[0].bvh, o, d.to(dev)).t
        (delta, losses), launches = _count(
            lambda: refine_instance_pose(scenes[1], 0, o, d.to(dev), meas, steps=8))
        assert launches["K5"] == (8 if dev.type == "cuda" else 0)
        res[dev.type] = (losses, (delta @ scenes[1].scene.instances[0].pose).trans)
    (gl, gc), (cl, cc) = res["cuda"], res["cpu"]
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-2, atol=0.0)
    torch.testing.assert_close(gc.cpu(), cc, rtol=0.0, atol=2e-5)
    torch.testing.assert_close(gc.cpu(), torch.tensor([4.0, 0.15, -0.1]), rtol=0.0, atol=0.02)


# -- multi-device on one card (rmcl_tpu_torch.parallel) --


def _sharded_correction_inputs(dev):
    """A room, its bins and one 256 x 8 scan at a known pose, the start
    pose 0.1 m off: the inputs of test_torch_sharding.py's correction."""
    from rmcl_tpu_torch.geom.map import MeshMap

    mmap = MeshMap.from_mesh(make_room_scene(n_pillars=3, seed=4), device=dev)
    model = SphericalModel.create(width=256, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    true = Transform.from_pose_tuple([0.4, -0.2, 1.0, 0, 0, 0.3], device=dev)
    hits = simulate(mmap.bvh, model, true)
    sensor = tp.MICPSensorData(model=model, points=hits.point, mask=hits.hit,
                               tsb=Transform.identity(device=dev),
                               config=tp.MICPSensorConfig.create(max_dist=2.0))
    tom = true @ Transform.from_pose_tuple([0.08, -0.05, 0.04, 0, 0, 0.04], device=dev)
    return mmap, sensor, tom


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
@pytest.mark.parametrize("accel", ["bins", "bvh"])
def test_sharded_correction_on_card_matches_unsharded(card, world, backend, accel):
    """sharded_correct_once on ranks that share the card (NCCL at world size
    1, gloo at 2) against the unsharded correction on the card: the pose
    within POSE_TOL, K + 1 all-reduces, and each rank's kernels (K3 + K1 on
    the bins, K5 on the BVH) launched once."""
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel.mesh import launch

    mmap, sensor, tom = _sharded_correction_inputs(card)
    struct = mmap.bins if accel == "bins" else mmap.bvh
    tbo = Transform.identity(device=card)
    ref, ref_stats = tp.correct_once(struct, [sensor], tom, tbo, 0.0)  # builds the kernels
    jobs = [("c", ((world,), ("rays",)), pg.correct_job, pg.to_host(dict(
        accel=struct, sensors=[sensor], tom=tom, tbo=tbo, config=tp.MICPConfig())))]
    runs = launch(pg.run_jobs, world, backend, ("cuda", jobs), timeout=300.0)
    want = {"K5": 1} if accel == "bvh" else {"K1": 1, "K3r": 1}
    for r in runs:
        pose = r["c"]["poses"][-1]
        np.testing.assert_allclose(pose[:4], ref.rot.cpu().numpy(), atol=POSE_TOL)
        np.testing.assert_allclose(pose[4:], ref.trans.cpu().numpy(), atol=POSE_TOL)
        np.testing.assert_allclose(float(r["c"]["valid_matches"]),
                                   float(ref_stats.valid_matches), rtol=1e-4)
        assert r["c"]["counts"] == [{"all_reduce": 6, "all_gather": 0, "permute": 0}]
        assert {k: v for k, v in r["c"]["launches"][0].items() if v} == want


def test_sharded_backward_on_card_matches_cpu(card):
    """sharded_range_value_and_grad on 2 gloo ranks sharing the card against
    the unsharded loss and gradients on the CPU (test_sharding.py:478's
    tolerances), one all-reduce an evaluation, K3 + K1 on each rank."""
    from rmcl_tpu_torch.ops.diff import cast_rays_diff
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel.mesh import launch

    mesh = make_sphere(48, 48, radius=5.0)
    rng = np.random.default_rng(0)
    trans = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pose_id = np.repeat(np.arange(4, dtype=np.int32), 256)
    cpu_bins = build_bins(mesh, bin_size=64, bins_per_super=16, device="cpu")
    # the ranks load the kernels this cast builds
    trb.cast_rays_binned(build_bins(mesh, bin_size=64, bins_per_super=16, device=card),
                         torch.zeros((128, 3), device=card), torch.from_numpy(d[:128]).to(card))
    jobs = []
    for wrt in ("pose", "verts"):
        jobs.append((wrt, ((2,), ("rays",)), pg.backward_job, dict(
            bins=pg.to_host(cpu_bins), verts=mesh.vertices.astype(np.float32),
            faces=mesh.faces.astype(np.int32), trans=trans, dirs=d, pose_id=pose_id,
            wrt=wrt)))
    runs = launch(pg.run_jobs, 2, "gloo", ("cuda", jobs), timeout=300.0)
    for wrt in ("pose", "verts"):
        t = torch.from_numpy(trans).requires_grad_(wrt == "pose")
        v = torch.from_numpy(mesh.vertices.astype(np.float32)).requires_grad_(wrt == "verts")
        h = cast_rays_diff(cpu_bins, v, torch.from_numpy(mesh.faces), t[torch.from_numpy(
            pose_id).long()], torch.from_numpy(d))
        loss = torch.where(h.hit, h.t, 0.0).sum()
        (grad,) = torch.autograd.grad(loss, [t if wrt == "pose" else v])
        for r in runs:
            np.testing.assert_allclose(float(r[wrt]["loss"]), float(loss.detach()), rtol=1e-5)
            np.testing.assert_allclose(r[wrt]["grad"], grad.numpy(), rtol=2e-4, atol=1e-5)
            assert r[wrt]["counts"] == {"all_reduce": 1, "all_gather": 0, "permute": 0}
            assert r[wrt]["launches"]["K1"] == 1 and r[wrt]["launches"]["K3r"] == 1


@pytest.mark.parametrize("forwarded", [False, True])
def test_scene_sharded_cast_on_card_matches_unsharded(card, forwarded):
    """The scene-sharded casts on 2 gloo ranks sharing the card (a
    ("scene",) mesh of 2) against the unsharded cast on the card: hits
    equal, t and normals within 1e-5 (test_scene_shard.py's bars)."""
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel import scene_shard as tss
    from rmcl_tpu_torch.parallel.mesh import launch

    room = make_room_scene(n_pillars=6)
    bins = build_bins(room, bin_size=16, bins_per_super=8, device=card)
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, 3, size=(1024, 3)).astype(np.float32)
    o[:, 2] = np.abs(o[:, 2]) * 0.4 + 0.2
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = trb.cast_rays_binned(bins, torch.from_numpy(o).to(card), torch.from_numpy(d).to(card),
                               block_size=64)
    jobs = [("s", ((2,), ("scene",)), pg.scene_job, dict(
        sbins=pg.to_host(tss.partition_bins(bins, 2)), orig=o, dirs=d, forwarded=forwarded,
        cast_kw=dict(block_size=64)))]
    runs = launch(pg.run_jobs, 2, "gloo", ("cuda", jobs), timeout=300.0)
    hit = ref.hit.cpu().numpy()
    for r in runs:
        h = r["s"]
        np.testing.assert_array_equal(h["hit"], hit)
        np.testing.assert_allclose(h["t"][hit], ref.t.cpu().numpy()[hit], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h["normal"][hit], ref.normal.cpu().numpy()[hit], atol=1e-5)
        assert h["counts"]["all_reduce"] == (3 if forwarded else 2)
        assert h["launches"]["K1"] >= 1 and h["launches"]["K3r"] >= 1
