"""The batch corrector's epilogue (``rmcl_tpu_torch/ops/epilogue_cuda.py``:
the kernel ``csrc/batch_epilogue.cu`` and its plain version
``batch_epilogue_reference``) and its wiring in ``micp/batch.py``.

On the CPU: the slot map is what the sweep's un-permutation makes of the
slot numbers, the cast's "winner" payload resolves to the "plane" payload's
hits, the wrapper's checks refuse what the kernel does not take and CPU
tensors get the plain version, the CPU correction is bitwise its own steps
(the winner cast, then the plain version) and within the rounding of
float32 sums of the correction as it ran before the plain epilogue, and its
spans nest as on the card. On the card (marked ``cuda``, skipped without
one): the kernel against its plain version on the same CUDA tensors, at a
small size and at the benchmark's (1,000 poses x VLP-16 on 998,284 faces),
and the corrector's correction against the plane payload's float32 path.
The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_epilogue.py --noconftest -o addopts= -m cuda -q
"""

import collections
import functools
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.geom.mesh import make_sphere
from rmcl_tpu_torch.math.gaussian import CrossStatistics
from rmcl_tpu_torch.math.stats import umeyama_transform
from rmcl_tpu_torch.micp.batch import BatchCorrector
from rmcl_tpu_torch.ops import epilogue_cuda as ec
from rmcl_tpu_torch.ops.raycast_binned import FactoredWinners, cast_rays_binned_factored
from rmcl_tpu_torch.ops.raycast_cuda import plane_of
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.utils import timing

torch.set_num_threads(2)

# 11 poses in tiles of 4, 45 azimuths in tiles of 8: every axis ragged; the
# range (19 m, inside a 20 m sphere, poses up to 4 m off its centre) leaves
# misses
MODEL = SphericalModel.create(width=45, height=8, range_max=19.0)
POSES = 11
# the plain epilogue's float64 sums against the float32 ones the corrector
# took before it (~1,000 points ~20 m away): positions and rotations round
# apart
TRANS_TOL = 2e-5
ROT_TOL = 1e-6
# the kernel against its plain version on the card: the same float32 terms
# (the kernel is built with --fmad=false) and float64 sums in other orders,
# rounded to float32 increments; sound runs read 0 m and 8.9e-16 rad with
# equal pairs, and float32 sums would read ~5e-6 m and ~1e-7 rad
CARD_TRANS_TOL = 1e-9
CARD_ROT_TOL = 1e-9


@pytest.fixture(autouse=True)
def tracing_off():
    timing.set_tracing(True)
    timing.set_tracing(False)
    yield
    timing.set_tracing(False)


def _sphere_bins(device):
    return build_bins(make_sphere(30, 30, radius=20.0), bin_size=32, bins_per_super=8,
                      supers_per_hyper=8, device=device)


@functools.lru_cache(maxsize=None)
def _truth():
    return np.random.default_rng(3).uniform(-4, 4, size=(POSES, 3)).astype(np.float32)


def _case(device="cpu", **kw):
    """A corrector on the small sphere, its dataset (each pose's scan at
    the truth, a few points dropped) and a start 0.2 m off in z."""
    kw = dict(dict(poses_per_tile=4, sub_blocks=8, c_super=8, c_bin=16, c_hyper=4), **kw)
    bc = BatchCorrector(_sphere_bins(device), MODEL, _truth(), **kw)
    truth = torch.from_numpy(_truth()).to(device)
    points, _, hit = bc.cast(truth)
    mask = hit & (torch.arange(MODEL.n_rays, device=device) % 17 != 3)[None]
    start = truth + torch.tensor([0.0, 0.0, 0.2], device=device)
    return bc, (points - truth[:, None], mask), start


def _annotations(prof):
    """(name, parent span's name) of every ``rmcl.*`` range in a profile."""
    out = []
    for e in prof.events():
        if e.name.startswith("rmcl."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("rmcl."):
                p = p.cpu_parent
            out.append((e.name, p.name if p is not None else None))
    return out


def _rot_gap(a, b):
    """Largest angle (rad) between unit quaternions a, b (N, 4): twice the
    arcsine of the vector part of conj(a) b (arccos of their dot product
    loses the small angles)."""
    a, b = a.double(), b.double()
    vec = a[:, :1] * b[:, 1:] - b[:, :1] * a[:, 1:] - torch.linalg.cross(a[:, 1:], b[:, 1:])
    return float((2 * torch.asin(torch.clamp(torch.linalg.vector_norm(vec, dim=-1),
                                             max=1.0))).max())


# -- CPU: the slot map, the winner payload, the checks ----------------------------


@pytest.mark.parametrize("n, width, height, pt, at, et", [
    (37, 90, 16, 16, 8, 1),  # poses and widths not whole tiles
    (1000, 900, 16, 16, 8, 1),  # the benchmark's sweep: 63 x 113 x 16 blocks
    (5, 13, 7, 4, 3, 2),  # elevations in ragged tiles too
    (3, 5, 2, 16, 8, 4),  # tiles wider than every axis
])
def test_slot_map_is_the_unpermuted_slot_numbers(n, width, height, pt, at, et):
    """The corrector's slot map sends each canonical (pose, direction) to a
    slot of its own among the sweep's real ones, and that slot's ray in
    K4's block layout (ray g * P + p of its block) is the pose's origin
    along the direction: padded slots appear nowhere."""
    origins = np.random.default_rng(n).uniform(-5, 5, size=(n, 3))
    model = SphericalModel.create(width=width, height=height, range_max=19.0)
    bc = BatchCorrector(_sphere_bins("cpu"), model, origins, poses_per_tile=pt, az_tile=at,
                        el_tile=et)
    sweep = bc.sweep
    _, got = bc._epilogue_tables()
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, width * height)
    assert got.is_contiguous()
    assert int(got.min()) >= 0 and int(got.max()) < sweep.n_rays
    assert int(torch.unique(got).numel()) == n * width * height
    # each pose and direction stands for its own number: the slot's block
    # rays must carry back the pair's own
    ids = torch.arange(max(n, model.n_rays), dtype=torch.float32)[:, None].expand(-1, 3)
    o_blk, d_blk = sweep.factored_rays(ids[:n], ids[:model.n_rays])
    P, G = o_blk.shape[1], d_blk.shape[1]
    s = got.long()
    blk, r = s // (P * G), s % (P * G)
    assert torch.equal(o_blk[blk, r % P, 0], ids[:n, 0, None].expand(n, model.n_rays))
    assert torch.equal(d_blk[blk, r // P, 0], ids[None, :model.n_rays, 0].expand(n, -1))


def test_winner_payload_resolves_to_the_plane_payload():
    """The same cast with payload "winner" gives "plane"'s hits, and each
    hit's winner row gives "plane"'s t, normal and point by the payload's
    own formulas; the other modes are unchanged by the new one."""
    bc, _, start = _case()
    o_blk, d_blk = bc.sweep.factored_rays(start, bc.dirs)
    kw = dict(sort_blocks=True, **bc.cull_kw)
    plane = cast_rays_binned_factored(bc.bins, o_blk, d_blk, payload="plane", **kw)
    won = cast_rays_binned_factored(bc.bins, o_blk, d_blk, payload="winner", **kw)
    assert isinstance(won, FactoredWinners)
    assert won.t.shape == plane.t.shape and won.ref.dtype == torch.int32
    assert won.t.is_contiguous() and won.ref.is_contiguous()
    hit = won.hit
    assert torch.equal(hit, plane.hit) and bool(hit.any()) and not bool(hit.all())
    # the winner's row in the plane table, or its triangle's nine floats
    r = won.ref[hit].long()
    B = bc.bins.bin_size
    ngx, ngy, ngz, c0 = ec.winner_planes(bc.bins.tri)[r].unbind(-1)
    want = plane_of(*bc.bins.tri[r // B, :9, r % B].unbind(-1))
    assert all(torch.equal(a, b) for a, b in zip((ngx, ngy, ngz, c0), want))
    n_blk, P, G = o_blk.shape[0], o_blk.shape[1], d_blk.shape[1]
    o = o_blk[:, None].expand(n_blk, G, P, 3).reshape(n_blk, G * P, 3)[hit]
    d = d_blk[:, :, None].expand(n_blk, G, P, 3).reshape(n_blk, G * P, 3)[hit]
    denom = ngx * d[:, 0] + ngy * d[:, 1] + ngz * d[:, 2]
    t = (c0 - (ngx * o[:, 0] + ngy * o[:, 1] + ngz * o[:, 2])) / denom
    inv_len = torch.rsqrt(ngx * ngx + ngy * ngy + ngz * ngz)
    normal = torch.stack([ngx, ngy, ngz], -1) * inv_len[:, None]
    normal = normal * torch.where(denom > 0, -1.0, 1.0)[:, None]
    assert torch.equal(t, plane.t[hit])
    assert torch.equal(normal, plane.normal[hit])
    assert torch.equal(o + t[:, None] * d, plane.point[hit])
    # misses carry K4's raw t, at or past the gate
    assert bool((won.t[~hit] >= won.t_max[:, None].expand_as(won.t)[~hit]).all())


def _args(bc, data, trans, candidates=None):
    """The epilogue's inputs at positions ``trans``, by the corrector's own
    steps: the winner cast (through ``candidates`` where given) and the
    tables."""
    o_blk, d_blk = bc.sweep.factored_rays(trans, bc.dirs)
    won = cast_rays_binned_factored(bc.bins, o_blk, d_blk, candidates=candidates,
                                    sort_blocks=True, payload="winner", **bc.cull_kw)
    planes, slots = bc._epilogue_tables()
    return [won.t, won.ref, planes, trans, bc.dirs, *data, slots]


def _plain(bc, args):
    return ec.batch_epilogue_reference(*args, bc.max_dist, bc.cull_kw["t_max"])


def _same(a, b):
    """Two (increment, pairs) results bitwise equal."""
    return (torch.equal(a[0].rot, b[0].rot) and torch.equal(a[0].trans, b[0].trans)
            and torch.equal(a[1], b[1]))


def _broken(args, case):
    """``args`` with one thing the kernel does not take."""
    a = list(args)
    idx = {"t_best": 0, "ref": 1, "planes": 2, "trans": 3, "dirs": 4, "data_points": 5,
           "data_mask": 6, "slots": 7}
    name, what = case.split(":")
    i = idx[name]
    x = a[i]
    if what == "dtype":
        a[i] = x.double() if x.is_floating_point() else (
            x.to(torch.uint8) if x.dtype == torch.bool else x.long())
    elif what == "shape":
        a[i] = x[..., :-1].contiguous()
    elif what == "layout":
        a[i] = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif what == "device":
        a[i] = x.to("meta")
    elif what == "offset":  # a view one float in: not 16-byte aligned
        a[i] = x.reshape(-1)[1:1 + x.numel() - 4].reshape(-1, 4)
    return a


BROKEN = ["trans:dtype", "dirs:dtype", "data_points:dtype", "data_mask:dtype", "slots:dtype",
          "t_best:dtype", "ref:dtype", "planes:dtype",
          "trans:shape", "dirs:shape", "data_points:shape", "data_mask:shape", "slots:shape",
          "ref:shape", "planes:shape",
          "data_points:layout", "data_mask:layout", "slots:layout", "t_best:layout",
          "ref:layout", "planes:layout",
          "data_points:device", "slots:device", "t_best:device", "planes:device", "planes:offset"]


@pytest.fixture(scope="module")
def kernel_args():
    bc, data, start = _case()
    return _args(bc, data, start)


def test_wrapper_checks_pass_the_card_paths_own_inputs(kernel_args):
    ec.check_epilogue_args(*kernel_args)


@pytest.mark.parametrize("case", BROKEN)
def test_wrapper_refuses_what_the_kernel_does_not_take(kernel_args, case):
    with pytest.raises((TypeError, ValueError)):
        ec.check_epilogue_args(*_broken(kernel_args, case))


def test_wrapper_refuses_tensors_on_other_devices(kernel_args):
    """Tensors the checks pass, on a device with neither the kernel nor the
    plain version: refused, nothing launched."""
    before = ec.batch_epilogue.launches
    meta = [x.to("meta") for x in kernel_args]
    ec.check_epilogue_args(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ec.batch_epilogue(*meta, 2.0, 130.0)
    assert ec.batch_epilogue.launches == before


def test_wrapper_sends_cpu_tensors_to_the_plain_version(kernel_args):
    """CPU tensors get the plain version's result bitwise, as views of one
    (N, 8) tensor; the kernel's launch count does not move."""
    before = ec.batch_epilogue.launches
    got = ec.batch_epilogue(*kernel_args, 2.0, 130.0)
    want = ec.batch_epilogue_reference(*kernel_args, 2.0, 130.0)
    assert _same(got, want) and float(got[1].min()) > 0
    assert got[0].rot.untyped_storage().data_ptr() == got[1].untyped_storage().data_ptr()
    assert ec.batch_epilogue.launches == before


# -- CPU: the corrector's one path ---------------------------------------------------


def _parent_correct(bc, data_points, data_mask, trans, candidates=None):
    """The correction as the corrector ran it on the CPU before its plain
    epilogue, written out: the payload cast, its un-permutation, the
    pairs, the statistics in float32 and the batched Umeyama solves."""
    o_blk, d_blk = bc.sweep.factored_rays(trans, bc.dirs)
    hits = cast_rays_binned_factored(bc.bins, o_blk, d_blk, candidates=candidates,
                                     sort_blocks=True, payload=bc.payload, **bc.cull_kw)
    n = bc.sweep.n_rays
    packed = torch.cat([hits.normal.reshape(n, 3), hits.t.reshape(n, 1),
                        hits.hit.reshape(n, 1).to(torch.float32)], dim=1)
    up = bc.sweep.unpermute(packed)
    sim_p, sim_n, sim_hit = trans[:, None, :] + up[..., 3:4] * bc.dirs[None], up[..., 0:3], \
        up[..., 4] > 0.5
    d_map = data_points + trans[:, None, :]
    signed = torch.sum(sim_n * (d_map - sim_p), dim=-1)
    ok = data_mask & sim_hit & (torch.abs(signed) <= bc.max_dist)
    proj = d_map - signed[..., None] * sim_n
    stats = CrossStatistics.from_masked_points(d_map, proj, ok)
    return umeyama_transform(stats), stats.n_meas


def _near_parent(got, n_got, want, n_want, trans):
    assert torch.equal(n_got, n_want) and float(n_want.min()) > 0
    np.testing.assert_allclose(got.apply(trans).numpy(), want.apply(trans).numpy(), rtol=0,
                               atol=TRANS_TOL)
    assert _rot_gap(got.rot, want.rot) < ROT_TOL


@pytest.mark.parametrize("payload", ["plane", "index"])
def test_cpu_correction_is_the_torch_path_bitwise(payload):
    """The CPU correction is its own steps in torch ops, bitwise: the winner
    cast, then the plain epilogue. Through kept lists and a fresh cull;
    each step within the rounding of float32 sums of the correction before
    the plain epilogue (``_parent_correct``, through ``payload``'s cast),
    with the same pairs."""
    bc, data, start = _case(payload=payload)
    trans = start
    for _ in range(3):
        step = bc.step(*data, trans)
        want = _plain(bc, _args(bc, data, trans, bc._lists))
        assert _same((step.delta, step.n_meas), want)
        assert torch.equal(step.trans, want[0].apply(trans))
        _near_parent(step.delta, step.n_meas, *_parent_correct(bc, *data, trans, bc._lists),
                     trans)
        trans = step.trans
    fresh = bc.correct(*data, trans)  # no lists: a fresh cull
    assert _same(fresh, _plain(bc, _args(bc, data, trans)))
    _near_parent(*fresh, *_parent_correct(bc, *data, trans), trans)


def test_card_path_wiring_gives_the_torch_paths_pairs():
    """The corrector's one path, on the CPU: its spans nest as on the card,
    its inputs pass the wrapper's checks, nothing launches, and it pairs
    what ``_parent_correct`` pairs."""
    bc, data, start = _case()
    lists = bc.candidates(start)[0]
    before = ec.batch_epilogue.launches
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, n_got = bc.correct(*data, start, lists)
    timing.set_tracing(False)
    assert collections.Counter(_annotations(prof)) == {
        ("rmcl.batch.correspond", None): 1,
        ("rmcl.cast.rays", "rmcl.batch.correspond"): 1,
        ("rmcl.cast.intersect", "rmcl.batch.correspond"): 1,
        ("rmcl.cast.payload", "rmcl.batch.correspond"): 1,
        ("rmcl.batch.epilogue", None): 1,
    }
    assert ec.batch_epilogue.launches == before
    ec.check_epilogue_args(*_args(bc, data, start, lists))
    _near_parent(got, n_got, *_parent_correct(bc, *data, start, lists), start)


# -- on the card: the kernel against its plain version ------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _card_gaps(bc, data, trans, lists):
    """The kernel against its plain version on the same CUDA tensors, one
    winner cast's: (position gap m, rotation gap rad, largest pair gap, the
    kernel's increment and pairs)."""
    args = _args(bc, data, trans, lists)
    got, n_got = ec.batch_epilogue(*args, bc.max_dist, bc.cull_kw["t_max"])
    want, n_want = _plain(bc, args)
    torch.cuda.synchronize()
    gap_t = float(torch.linalg.vector_norm(got.apply(trans) - want.apply(trans), dim=-1).max())
    return gap_t, _rot_gap(got.rot, want.rot), float((n_got - n_want).abs().max()), got, n_got


@pytest.mark.cuda
def test_kernel_matches_the_torch_path_on_the_card(card):
    bc, data, start = _case(card)
    lists = bc.candidates(start)[0]
    before = ec.batch_epilogue.launches
    gap_t, gap_r, gap_n, got, n_got = _card_gaps(bc, data, start, lists)
    assert ec.batch_epilogue.launches - before == 1
    assert gap_t < CARD_TRANS_TOL and gap_r < CARD_ROT_TOL and gap_n == 0
    assert float(n_got.min()) > 0
    assert _same(bc.correct(*data, start, lists), (got, n_got))  # the corrector's launch


@pytest.mark.cuda
def test_card_correction_is_near_the_plane_payload_path(card):
    """The corrector's correction on the card against the independent
    float32 path (``_parent_correct``: the plane payload un-permuted, no
    slot map or plane table), through kept lists and a fresh cull."""
    bc, data, start = _case(card)
    lists = bc.candidates(start)[0]
    for cand in (lists, None):
        got, n_got = bc.correct(*data, start, cand)
        want, n_want = _parent_correct(bc, *data, start, cand)
        assert torch.equal(n_got, n_want) and float(n_want.min()) > 0
        gap_t = float(torch.linalg.vector_norm(got.apply(start) - want.apply(start), dim=-1).max())
        assert gap_t < TRANS_TOL and _rot_gap(got.rot, want.rot) < ROT_TOL


@pytest.mark.cuda
def test_a_pose_without_points_gets_the_identity(card):
    bc, (points, mask), start = _case(card)
    mask = mask.clone()
    mask[4] = False
    got, n = bc.correct(points, mask, start)
    torch.cuda.synchronize()
    assert float(n[4]) == 0.0 and float(n[torch.arange(POSES, device=card) != 4].min()) > 0
    assert got.rot[4].tolist() == [1.0, 0.0, 0.0, 0.0] and got.trans[4].tolist() == [0.0] * 3


@pytest.mark.cuda
def test_one_launch_a_step_and_no_host_sync(card):
    bc, data, start = _case(card)
    bc.step(*data, start)  # culls, builds the maps and the kernel
    args = _args(bc, data, start)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ec.batch_epilogue(*args, bc.max_dist, bc.cull_kw["t_max"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    before = ec.batch_epilogue.launches
    trans = start
    for _ in range(3):
        trans = bc.step(*data, trans).trans
    assert ec.batch_epilogue.launches - before == 3
    regs, local, _ = ec.kernel_registers()["epilogue"]
    assert local == 0, f"the epilogue kernel spills {local} local bytes a thread ({regs} registers)"


@pytest.mark.cuda
def test_kernel_matches_the_torch_path_at_the_benchmarks_size(card):
    """1,000 poses x VLP-16 on the 998,284-face sphere, the benchmark cell's
    configuration, from the truth + 0.2 m in z: three closed-loop steps."""
    bins = build_bins(make_sphere(707, 707, radius=50.0), bin_size=64, bins_per_super=16,
                      supers_per_hyper=16, device=card)
    truth_np = np.random.default_rng(0).uniform(-5, 5, size=(1000, 3)).astype(np.float32)
    bc = BatchCorrector(bins, SphericalModel.vlp16(), truth_np, max_dist=2.0, origin_margin=0.03,
                        c_super=24, c_bin=64, c_hyper=20, sub_blocks=128, block_chunk=512)
    truth = torch.from_numpy(truth_np).to(card)
    points, _, hit = bc.cast(truth)
    data = (points - truth[:, None], hit)
    trans = truth + torch.tensor([0.0, 0.0, 0.2], device=card)
    for _ in range(3):
        step = bc.step(*data, trans)
        gap_t, gap_r, gap_n, got, _ = _card_gaps(bc, data, trans, bc._lists)
        assert torch.equal(got.rot, step.delta.rot) and int(step.truncated) == 0
        assert gap_t < CARD_TRANS_TOL and gap_r < CARD_ROT_TOL and gap_n == 0, (
            gap_t, gap_r, gap_n)
        assert float(step.n_meas.min()) > 0.99 * 14_400
        trans = step.trans
    err = torch.linalg.vector_norm(trans - truth, dim=-1)
    assert float(err.median()) < 0.2 and not math.isnan(float(err.max()))
