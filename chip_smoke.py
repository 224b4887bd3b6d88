#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):

1. device: the card's name and power limit (nvidia-smi) and the float32
   matmul flags — the normal equations must not run in TF32;
2. build: the port's CUDA kernel, compiled by nvcc from
   ``rmcl_tpu_torch/csrc``;
3. kernel vs plain version: the candidate-bin intersection kernel against
   its plain PyTorch version on the same CUDA tensors, for 14,400 VLP-16
   rays on the room scene and on the ~1M-face sphere, with timings;
4. main path: MICP-L on a ~480k-face building map — ten ``correct_once``
   calls from +0.2 m z / 0.05 rad yaw back to the true pose, counting the
   kernel's launches; the kernel is then held against its plain version
   on the main path's own inputs and timed beside its bound, and the cast
   is repeated with no candidate budget to measure the hits the default
   budgets cost;
5. reference-size cast: 1000 poses x VLP-16 (14.4M rays) against the
   ~1M-face sphere, with the split between the cull and the kernel; the
   default 128-ray blocks are measured too (hits, truncated blocks).

Prints one JSON line per kernel (``{"kernels": [...]}``) and, last,
``{"ok": true, "device": {...}}``. Without a card it exits nonzero before
printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import rmcl_tpu_torch  # noqa: F401  (outside a checkout of the repo: fail before any output)

# sizes of the run
BUILDING_SUBDIV = 45  # make_building_scene: ~480k faces (BASELINE.json config 2 class)
SPHERE_LAT_LON = 707  # make_sphere(707, 707): ~1M faces (the reference benchmark's sphere)
N_POSES = 1000  # the reference benchmark's pose count
N_CORRECTIONS = 10
# phase 5 blocks: a 128-ray block of a VLP-16 row spans 51 degrees of azimuth,
# whose footprint on the 50 m sphere needs ~200 bins — over the c_bin = 96
# budget in every block, in the JAX package as in the port (both truncate:
# scripts/torch_budget_probe.py), so half the rays miss. 32-ray blocks need
# at most 29 candidates and saturate nowhere. The phase measures both.
DEFAULT_BLOCK_SIZE = 128
CAST_BLOCK_SIZE = 32
CAST_BLOCK_CHUNK = 4096  # blocks per cull chunk in phase 5 (bounds memory, not results)
TIMING_REPS = 5

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s; float32 outside the
# tensor cores is 67e12 flop/s counting a fused multiply-add as two, which is
# 33.5e12 separate adds or multiplies a second. The kernel is built with
# --fmad=false, so each of its adds and multiplies is one instruction.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_INSTR_PER_S = 33.5e12
# float instructions per (ray, triangle) pair in the kernel's Moller-Trumbore:
# 9 (d x e2) + 5 det + 1 reciprocal + 3 (o - v0) + 6 u + 9 (tv x e1) + 6 v
# + 6 t + 2 (u + v, 1 + eps - .) = 47, the reciprocal counted as one (an IEEE
# division takes several, so the bound stays a floor)
OPS_PER_PAIR = 47

# tolerances kernel vs plain version: built with --fmad=false the two round
# alike and agree bitwise; 1e-5 relative leaves room for the rounding of a
# near-tie only
T_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps=TIMING_REPS):
    """Median milliseconds of fn() over reps runs, by CUDA events (after
    one warm-up run)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_bound(inputs, t_best, B):
    """Least time the card could take for the kernel's work on these inputs:
    the larger of bytes over the HBM rate and float instructions over the
    float32 instruction rate. The work counts the candidates each block must visit — those with
    tnear <= the block's final worst t_best, within its count — and the
    pairs of its live rays with their triangles."""
    ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear = inputs
    cb = cand_bin.shape[1]
    slot = torch.arange(cb, device=ob.device)[None, :]
    worst = t_best.amax(dim=1, keepdim=True)
    visit = (slot < cand_count[:, None]) & (cand_tnear <= worst)
    visits = visit.sum(dim=1).to(torch.float64)
    live = (t_max_b > t_min_b).sum(dim=1).to(torch.float64)
    n_rays = ob.shape[0] * ob.shape[1]
    bytes_moved = (float(visits.sum()) * (9 * B * 4 + 8)  # triangles + id/tnear
                   + n_rays * 8 * 4  # rays in: o, d, t_min, t_max
                   + n_rays * 8  # out: t_best, ref
                   + cand_count.numel() * 4)
    ops = float((visits * live).sum()) * B * OPS_PER_PAIR
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_INSTR_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            float(visits.sum()))


def check_agreement(name, tri, inputs, kt, kref, pt, pref):
    """Fail unless the kernel (kt, kref) agrees with the plain version (pt,
    pref): t_best within T_RTOL on every ray, and the same winner except at
    a near-tie, where the plain version's t for the triangle the kernel
    chose is within T_RTOL of its own t_best. Returns (max_abs_err, winner
    mismatches)."""
    from rmcl_tpu_torch.ops.raycast_cuda import winner_t

    ob, db, t_min_b = inputs[:3]
    tol = T_RTOL * pt.double().abs()
    diff = (kt.double() - pt.double()).abs()
    mis = kref != pref
    tie_t = winner_t(tri, ob[mis], db[mis], t_min_b[mis], kref[mis])
    bad_t = int((diff > tol).sum())
    bad_ref = int(((tie_t.double() - pt[mis].double()).abs() > tol[mis]).sum())
    if bad_t or bad_ref:
        fail(f"{name}: kernel and plain version disagree "
             f"({bad_t} t, {bad_ref} winners outside tolerance)")
    return (float(diff.max()) if diff.numel() else 0.0), int(mis.sum())


def compare_kernel(name, tri, inputs):
    """Kernel vs plain version on the same CUDA tensors; returns a dict of
    the comparison and the timings."""
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference

    launches = intersect_bins.launches
    kt, kref = intersect_bins(tri, *inputs)
    pt, pref = intersect_bins_reference(tri, *inputs)
    torch.cuda.synchronize()
    if intersect_bins.launches != launches + 1:
        fail(f"{name}: the kernel did not launch")
    max_abs_err, ref_mismatch = check_agreement(name, tri, inputs, kt, kref, pt, pref)
    out = dict(max_abs_err=max_abs_err, ref_mismatch=ref_mismatch,
               hit_frac=float((kref >= 0).float().mean()))
    out["ms"] = cuda_ms(lambda: intersect_bins(tri, *inputs))
    out["plain_ms"] = cuda_ms(lambda: intersect_bins_reference(tri, *inputs))
    out["bound_ms"], out["bound_by"], out["visits"] = kernel_bound(
        inputs, kt, tri.shape[2])
    return out


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    tf32 = dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}, {json.dumps(tf32)}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls would run in TF32")
    return smi


def phase_build():
    from rmcl_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library("intersect_bins")
    log(f"phase 2 build: intersect_bins in {time.perf_counter() - t0:.2f} s")


def vlp16_rays(origin):
    from rmcl_tpu_torch.sensors.models import SphericalModel

    model = SphericalModel.vlp16()
    o, d = model.rays("cuda")
    return o + torch.tensor(origin, dtype=torch.float32, device="cuda"), d, model


def phase_kernel_vs_plain(sphere_bins):
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.mesh import make_room_scene
    from rmcl_tpu_torch.ops.raycast_binned import _build_candidates, _pad_rays, _resolve_budgets

    room = build_bins(make_room_scene(n_pillars=4, seed=3), bin_size=32, bins_per_super=8)
    results = {}
    for name, bins, origin in (("room", room, (0.5, -0.3, 1.0)),
                               ("sphere_1M", sphere_bins, (1.0, -2.0, 0.5))):
        o, d, model = vlp16_rays(origin)
        n = o.shape[0]
        blocks = _pad_rays(o, d, torch.full((n,), model.range.min, device="cuda"),
                           torch.full((n,), model.range.max, device="cuda"), 128)
        inputs = blocks + _build_candidates(bins, *blocks, *_resolve_budgets(bins, 24, 96))
        r = compare_kernel(f"phase 3 {name}", bins.tri, inputs)
        log(f"phase 3 kernel vs plain [{name}, {bins.n_bins * bins.bin_size} tris, {n} rays]: "
            f"max_abs_err {r['max_abs_err']:.3g}, ref mismatches {r['ref_mismatch']}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results[name] = r
    return results


def phase_main_path():
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.pipeline import (MICPConfig, MICPSensorConfig,
                                              MICPSensorData, correct_once)
    from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _kernel_inputs, cast_rays_binned
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    t0 = time.perf_counter()
    mesh = make_building_scene(subdiv=BUILDING_SUBDIV)
    bmap = MeshMap.from_mesh(mesh)
    torch.cuda.synchronize()
    log(f"phase 4 map: building {mesh.n_faces} faces, {bmap.bins.n_bins} bins of "
        f"{bmap.bins.bin_size}, built in {time.perf_counter() - t0:.2f} s")

    model = SphericalModel.vlp16()
    true_pose = Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3])
    hits = simulate(bmap.bins, model, true_pose)
    sensor = MICPSensorData(model=model, points=hits.point, mask=hits.hit,
                            tsb=Transform.identity(),
                            config=MICPSensorConfig.create(max_dist=2.0))
    tbo = Transform.identity()
    config = MICPConfig()
    # warm-up correction (not counted): first-call allocations
    correct_once(bmap.bins, [sensor], true_pose, tbo, 0.0, config)
    torch.cuda.synchronize()

    tom = Transform.from_pose_tuple([9.0, 3.0, 1.7, 0.0, 0.0, 0.35])
    progress = torch.zeros((), device="cuda")
    times = []
    intersect_bins.launches = 0
    for _ in range(N_CORRECTIONS):
        t = time.perf_counter()
        tom, stats = correct_once(bmap.bins, [sensor], tom, tbo, progress, config)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        progress = stats.convergence_progress
    launches = intersect_bins.launches
    err_t = float(torch.linalg.vector_norm(tom.trans - true_pose.trans))
    dq = float(abs(torch.dot(tom.rot, true_pose.rot)))
    log(f"phase 4 main path: {N_CORRECTIONS} corrections x {model.n_rays} rays, "
        f"median {statistics.median(times):.3f} ms/correction (min {min(times):.3f}), "
        f"final |dt| {err_t:.2e} m, |<q, q_true>| {dq:.8f}, "
        f"matches {float(stats.valid_matches):.0f}/{float(stats.valid_measurements):.0f}, "
        f"progress {float(stats.convergence_progress):.4f}, kernel launches {launches}")
    if not err_t < 0.01:
        fail(f"main path did not converge: translation error {err_t} m")
    if launches < 1:
        fail("the main path never launched the intersection kernel")
    if not bool(torch.isfinite(tom.rot).all() & torch.isfinite(tom.trans).all()):
        fail("non-finite pose")

    # the kernel on the main path's own inputs: the last correction's cast
    tsm = tom @ tbo
    o_s, d_s = model.rays("cuda")
    o, d, t_min_r, t_max_r, _ = _flat_rays(tsm.apply(o_s), tsm.rotate(d_s),
                                           model.range.min, model.range.max)
    inputs, sat = _kernel_inputs(bmap.bins, o, d, t_min_r, t_max_r, 128, config.c_super,
                                 config.c_bin, 256, 4)
    cull_ms = cuda_ms(lambda: _kernel_inputs(bmap.bins, o, d, t_min_r, t_max_r, 128,
                                             config.c_super, config.c_bin, 256, 4))
    r = compare_kernel("phase 4 main path", bmap.bins.tri, inputs)
    r.update(launches=launches, launches_per_correction=launches / N_CORRECTIONS,
             cull_ms=cull_ms, correction_ms=statistics.median(times), saturated=int(sat.sum()))
    log(f"phase 4 kernel on the main path's inputs: max_abs_err {r['max_abs_err']:.3g}, "
        f"ref mismatches {r['ref_mismatch']}, kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {r['visits']:.0f} bin visits), "
        f"cull {cull_ms:.3f} ms, {r['launches_per_correction']:.1f} launches/correction, "
        f"{r['saturated']} of {inputs[0].shape[0]} blocks saturated")

    # what the default budgets cost this cast: the same rays with no budget
    # (every super, every bin) truncate nowhere
    bins = bmap.bins
    free = (bins.n_super, bins.n_super * bins.bins_per_super)
    _, free_sat = _kernel_inputs(bins, o, d, t_min_r, t_max_r, 128, *free, 256, 4)
    capped = cast_rays_binned(bins, o, d, t_min_r, t_max_r, c_super=config.c_super,
                              c_bin=config.c_bin)
    full = cast_rays_binned(bins, o, d, t_min_r, t_max_r, c_super=free[0], c_bin=free[1])
    both = capped.hit & full.hit
    r.update(hit_frac=float(capped.hit.float().mean()),
             hit_frac_unbudgeted=float(full.hit.float().mean()),
             false_misses=int((full.hit & ~capped.hit).sum()),
             other_winner=int((capped.prim_id != full.prim_id)[both].sum()))
    log(f"phase 4 budget cost: hits {r['hit_frac']:.6f} at c_super={config.c_super}, "
        f"c_bin={config.c_bin} vs {r['hit_frac_unbudgeted']:.6f} with no budget "
        f"(c_super={free[0]}, c_bin={free[1]}, {int(free_sat.sum())} blocks saturated): "
        f"{r['false_misses']} false misses, {r['other_winner']} other winners of "
        f"{int(both.sum())} rays both hit")
    if free_sat.any():
        fail("phase 4: the unbudgeted cull still truncated a block")
    return r


def phase_reference_cast(sphere_bins):
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform
    from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _kernel_inputs
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    model = SphericalModel.vlp16()
    trans = np.random.default_rng(0).uniform(-5, 5, size=(N_POSES, 3)).astype(np.float32)
    tsm = Transform(rot=Quaternion.identity((N_POSES,), "cuda"),
                    trans=torch.from_numpy(trans).cuda())
    kw = dict(block_size=CAST_BLOCK_SIZE, block_chunk=CAST_BLOCK_CHUNK)
    hits = simulate(sphere_bins, model, tsm, **kw)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    hits = simulate(sphere_bins, model, tsm, **kw)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t) * 1e3
    n = hits.hit.numel()
    hit_frac = float(hits.hit.float().mean())

    # the same cast split into its cull and its kernel
    tsm_b = tsm.expand_dims(-1)
    o_s, d_s = model.rays("cuda")
    o, d, t_min_r, t_max_r, _ = _flat_rays(tsm_b.apply(o_s), tsm_b.rotate(d_s),
                                           model.range.min, model.range.max)

    # the default 128-ray blocks, measured and not required to hit
    inputs, sat = _kernel_inputs(sphere_bins, o, d, t_min_r, t_max_r, DEFAULT_BLOCK_SIZE,
                                 24, 96, CAST_BLOCK_CHUNK, 4)
    _, kref = intersect_bins(sphere_bins.tri, *inputs)
    log(f"phase 5 default {DEFAULT_BLOCK_SIZE}-ray blocks: hits "
        f"{float((kref.reshape(-1)[:n] >= 0).float().mean()):.6f}, {int(sat.sum())} of "
        f"{inputs[0].shape[0]} blocks saturated, {int(inputs[5].sum())} candidates")
    del inputs, sat, kref

    args = (sphere_bins, o, d, t_min_r, t_max_r, CAST_BLOCK_SIZE, 24, 96, CAST_BLOCK_CHUNK, 4)
    inputs, sat = _kernel_inputs(*args)
    cull_ms = cuda_ms(lambda: _kernel_inputs(*args), reps=3)
    launches = intersect_bins.launches
    kt, kref = intersect_bins(sphere_bins.tri, *inputs)
    kernel_ms = cuda_ms(lambda: intersect_bins(sphere_bins.tri, *inputs))
    # the plain version, in slices of blocks that fit the card's memory
    torch.cuda.synchronize()
    t = time.perf_counter()
    parts = [intersect_bins_reference(sphere_bins.tri, *(x[s:s + CAST_BLOCK_CHUNK] for x in inputs))
             for s in range(0, inputs[0].shape[0], CAST_BLOCK_CHUNK)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    pt = torch.cat([p[0] for p in parts])
    pref = torch.cat([p[1] for p in parts])
    if intersect_bins.launches <= launches:
        fail("phase 5: the kernel did not launch")
    max_abs_err, ref_mismatch = check_agreement("phase 5 (14.4M rays)", sphere_bins.tri,
                                                inputs, kt, kref, pt, pref)
    bound_ms, bound_by, visits = kernel_bound(inputs, kt, sphere_bins.bin_size)
    saturated = int(sat.sum())
    log(f"phase 5 reference-size cast: {N_POSES} poses x {model.n_rays} rays = {n} rays on "
        f"{sphere_bins.n_bins * sphere_bins.bin_size} tris: simulate {sim_ms:.2f} ms, "
        f"hits {hit_frac:.6f}; split: cull {cull_ms:.2f} ms + kernel {kernel_ms:.3f} ms "
        f"(plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms {bound_by}, {visits:.0f} bin visits), "
        f"max_abs_err {max_abs_err:.3g}, ref mismatches {ref_mismatch}, "
        f"{saturated} of {inputs[0].shape[0]} blocks of {CAST_BLOCK_SIZE} rays saturated")
    if not hit_frac >= 0.999:
        fail(f"phase 5: only {hit_frac:.6f} of rays hit the sphere")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                cull_ms=cull_ms, simulate_ms=sim_ms, hit_frac=hit_frac)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test drives the port on the card")
    smi = phase_device()
    phase_build()

    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.mesh import make_sphere

    t0 = time.perf_counter()
    sphere = build_bins(make_sphere(SPHERE_LAT_LON, SPHERE_LAT_LON, radius=50.0), bin_size=64)
    torch.cuda.synchronize()
    log(f"sphere map: {sphere.n_bins} bins of {sphere.bin_size}, "
        f"{sphere.tri.numel() * 4 / 1e6:.1f} MB packed, built in {time.perf_counter() - t0:.2f} s")

    phase_kernel_vs_plain(sphere)
    main_r = phase_main_path()
    phase_reference_cast(sphere)

    log(json.dumps({"kernels": [{
        "name": "intersect_bins",
        "route": "cuda",
        "source": "rmcl_tpu_torch/csrc/intersect_bins.cu",
        "replaces": "rmcl_tpu/ops/raycast_pallas.py:35",
        "launches": main_r["launches"],
        "max_abs_err": main_r["max_abs_err"],
        "ms": main_r["ms"],
        "plain_ms": main_r["plain_ms"],
        "bound_ms": main_r["bound_ms"],
        "bound_by": main_r["bound_by"],
        "library_ms": None,
    }]}))
    log(f"card: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
