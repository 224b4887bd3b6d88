#!/usr/bin/env python3
"""K3 (the fused block cull, ``rmcl_tpu_torch/csrc/cull_blocks.cu``) in
variants of its launch constants, at the inputs of ``chip_smoke.py``'s
phases, on one NVIDIA card:

- phase 4: the building map (``make_building_scene(subdiv=45)``), one
  VLP-16 scan from the main path's start pose, 128-ray blocks of 4 cones;
- phase 5: 1000 poses x VLP-16 in the ~1M-face sphere, 32-ray blocks;
- phase 7: the sweep's reuse cull (``rmcl_tpu_torch.bench`` defaults:
  113,904 blocks of 16 poses x 8 directions, 128 cones, the hyper level).

Each variant is the kernel's source with some named constants replaced
(``VARIANTS``), or the wrapper's launch plan set otherwise (``PLANS``),
built by nvcc with the package's flags into ``build/cull_probe/``. For every
variant and phase it prints one JSON line: the fused kernel's and the back
end's time (CUDA events around the wrapper, median of ``REPS``; and the
kernels' device time by ``torch.profiler``, null where the profiler sees
none), and whether the lists equal the plain version's bitwise. Two more
lines: how torch's CUDA ``rsqrt`` and ``sqrt`` round against ``1 / sqrt``
(the kernel's and the plain version's formulation) and against the CPU; and,
at phase 7, the tests, candidates and K4 visits of the lists the bounds give
in their present fixed order against those of the bounds' former order
(``torch.rsqrt``, ``torch.sum``).
Run from the repo root on the card (~2 minutes):

    python -m scripts.torch_cull_probe
"""

import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rmcl_tpu_torch import _build
from rmcl_tpu_torch.ops import cull_cuda as cc

REPS = 10
# name -> {constant: value}; "as built" is the source unchanged
VARIANTS = {
    "as built": {},
    "each cone test twice": {"kTestRepeat": "2"},
    "256-thread CTAs": {},
}
# name -> launch-plan settings of ops/cull_cuda.py for that variant: 256
# threads a CTA at every grid
PLANS = {"256-thread CTAs": {"_K3_BIG_GRID": 1 << 30}}


def build_variant(name, consts):
    src = (_build.CSRC / "cull_blocks.cu").read_text()
    for const, value in consts.items():
        head = f"constexpr int {const} = "
        start = src.index(head) + len(head)
        src = src[:start] + value + src[src.index(";", start):]
    out_dir = _build.BUILD_DIR.parent / "cull_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = out_dir / "".join(c if c.isalnum() else "_" for c in name)
    stem.with_suffix(".cu").write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(_build.CSRC), "-o", str(stem.with_suffix(".so")),
                           str(stem.with_suffix(".cu"))],
                          check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(stem.with_suffix(".so"))).rmcl_cull
    fn.argtypes = [ctypes.POINTER(cc._CullArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # registers and spills of each build (csrc/cull_blocks.cu's kBuilds)
    ptxas = [line.replace("ptxas info    :", "").strip() for line in proc.stderr.splitlines()
             if "registers" in line or "spill" in line]
    return fn, ptxas


def events_ms(fn):
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn):
    """Mean device time of the cull kernel's launches in REPS calls of fn,
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "cull_kernel" in e.key]
    total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                for e in events)
    count = sum(e.count for e in events)
    return total / 1e3 / count if count and total else None


def rounding():
    """Share of float32 inputs on which torch's CUDA rsqrt differs from
    1 / sqrt, and on which CUDA and CPU differ, for sums of squares of
    unit-length vectors (near 1) and a wide range."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    near = 1.0 + (torch.rand(1 << 22, device="cuda", generator=gen) - 0.5) * 1e-5
    wide = torch.rand(1 << 22, device="cuda", generator=gen) * 100.0 + 1e-6
    out = {}
    for name, x in (("near_1", near), ("wide", wide)):
        r, q = torch.rsqrt(x), 1.0 / torch.sqrt(x)
        xc = x.cpu()
        out[name] = dict(
            rsqrt_ne_inv_sqrt=float((r != q).float().mean()),
            cuda_rsqrt_ne_cpu=float((r.cpu() != torch.rsqrt(xc)).float().mean()),
            cuda_sqrt_ne_cpu=float((torch.sqrt(x).cpu() != torch.sqrt(xc)).float().mean()),
            cuda_inv_sqrt_ne_cpu=float((q.cpu() != 1.0 / torch.sqrt(xc)).float().mean()))
    return out


def former_block_bounds(ob, db, t_min_b, t_max_b):
    """The bounds in their former order (torch.rsqrt, torch.sum)."""
    big = cc._BIG
    live = (t_max_b > t_min_b)[..., None]
    any_live = torch.any(live[..., 0], dim=1)
    o_lo = torch.where(any_live[:, None], torch.amin(torch.where(live, ob, big), dim=1), 0.0)
    o_hi = torch.where(any_live[:, None], torch.amax(torch.where(live, ob, -big), dim=1), 0.0)
    dn = db * torch.rsqrt(torch.clamp(torch.sum(db * db, -1, keepdim=True), min=1e-30))
    dsum = torch.sum(torch.where(live, dn, 0.0), dim=1)
    a = dsum * torch.rsqrt(torch.clamp(torch.sum(dsum * dsum, -1, keepdim=True), min=1e-30))
    ca = torch.amin(torch.where(live[..., 0], torch.sum(dn * a[:, None, :], -1), 1.0), dim=1)
    ca = torch.clamp(ca, 0.05, 1.0)
    tan_th = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0)) / ca
    nrm = torch.sqrt(torch.clamp(torch.sum(db * db, -1), min=1e-30))
    n_hi = torch.amax(torch.where(live[..., 0], nrm, 1e-30), dim=1)
    t_hi = torch.amax(torch.where(live[..., 0], t_max_b * nrm, 0.0), dim=1)
    return 0.5 * (o_lo + o_hi), 0.5 * (o_hi - o_lo), a, tan_th, t_hi, n_hi, ~any_live


def visits(case):
    """Phase 7's tests, mean candidates and K4 visits (chip_smoke's
    count) of the lists from the bounds in the fixed order and in the
    former order."""
    from chip_smoke import factored_bound
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored

    _, _, _, args, back = case
    bins, o_p, d_p, alive, t_min, t_max, R, cs, cb, ch, margin, _ = args
    fixed = cc._block_bounds
    out = {}
    for name, bounds in (("fixed order", fixed), ("former order", former_block_bounds)):
        cc._block_bounds = bounds
        cones = cc._cull_args(bins, cc._factored_bounds(o_p, d_p, alive, t_min, t_max, R, margin,
                                                        0.0), R, cs, cb, ch)
        cc._block_bounds = fixed
        cand, count, tnear, _ = cc.cull_blocks(*cones)
        inputs = (bins.tri, o_p, d_p, alive, t_min, t_max, cand, count, tnear)
        kt, _ = intersect_factored(*inputs)
        out[name] = dict(tests=float(cc.cull_tests(*cones[:2], *cones[3:6], *cones[6:10])
                                     .double().sum()),
                         mean_candidates=float(count.float().mean()),
                         k4_visits=factored_bound(inputs, kt, False)[2])
    return out


def phase_inputs():
    """(name, fused wrapper, plain version, fused args, back-end args)."""
    from chip_smoke import BUILDING_SUBDIV, CAST_BLOCK_SIZE, N_POSES, SPHERE_LAT_LON
    from rmcl_tpu_torch.bench import SweepBench, settings_from_env
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import make_building_scene, make_sphere
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform
    from rmcl_tpu_torch.ops.raycast_binned import (_flat_rays, _hyper_budget, _pad_factored_blocks,
                                                   _pad_rays, _resolve_budgets)
    from rmcl_tpu_torch.sensors.models import SphericalModel

    model = SphericalModel.vlp16()
    o_s, d_s = model.rays("cuda")
    cases = []

    def dense(name, bins, tsm, Rb):
        blocks = _pad_rays(*_flat_rays(tsm.apply(o_s), tsm.rotate(d_s), model.range.min,
                                       model.range.max)[:4], Rb)
        cs, cb, _ = _resolve_budgets(bins, 24, 96)
        back = cc._cull_args(bins, lambda r: cc._subblock_bounds(*blocks, r), 4, cs, cb, 0)
        cases.append((name, cc.cull_rays, cc.cull_rays_reference, (bins, *blocks, 4, cs, cb, 0),
                      back))

    bmap = MeshMap.from_mesh(make_building_scene(subdiv=BUILDING_SUBDIV))
    dense("phase 4", bmap.bins, Transform.from_pose_tuple([9.0, 3.0, 1.7, 0.0, 0.0, 0.35]), 128)
    sphere = build_bins(make_sphere(SPHERE_LAT_LON, SPHERE_LAT_LON, radius=50.0), bin_size=64)
    trans = np.random.default_rng(0).uniform(-5, 5, size=(N_POSES, 3)).astype(np.float32)
    tsm = Transform(rot=Quaternion.identity((N_POSES,), "cuda"),
                    trans=torch.from_numpy(trans).cuda()).expand_dims(-1)
    dense("phase 5", sphere, tsm, CAST_BLOCK_SIZE)

    cfg, _ = settings_from_env({})
    bench = SweepBench(**cfg, device="cuda")
    est0 = bench.trans_true + torch.tensor([0.0, 0.0, 0.2], device="cuda")
    o_p, d_p, alive, *_ = _pad_factored_blocks(*bench.sweep.factored_rays(est0, bench.dirs),
                                               None, cfg["block_chunk"])
    bins = bench.bins
    R = cfg["sub_blocks"]
    cs, cb, _ = _resolve_budgets(bins, cfg["c_super"], cfg["c_bin"])
    ch = _hyper_budget(bins, cfg["c_hyper"])
    args = (bins, o_p, d_p, alive, 0.0, 3.0e38, R, cs, cb, ch, bench.margin, 0.0)
    raw = cc._factored_bounds(o_p, d_p, alive, 0.0, 3.0e38, R, bench.margin, 0.0)
    cases.append(("phase 7", cc.cull_factored, cc.cull_factored_reference, args,
                  cc._cull_args(bins, raw, R, cs, cb, ch)))
    return cases


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_cull_probe needs an NVIDIA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        kernels = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS, VARIANTS.values())))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card, rounding=rounding())), flush=True)
    cases = phase_inputs()
    print(json.dumps(dict(card=card, phase="phase 7", lists=visits(cases[-1]))), flush=True)
    plain = {name: fn_p(*args) for name, _, fn_p, args, _ in cases}
    for variant, (kernel, ptxas) in kernels.items():
        print(json.dumps(dict(variant=variant, ptxas=ptxas)), flush=True)
        cc._kernel = lambda kernel=kernel: kernel
        saved = {k: getattr(cc, k) for k in PLANS.get(variant, {})}
        for k, v in PLANS.get(variant, {}).items():
            setattr(cc, k, v)
        for name, fn, _, args, back in cases:
            out = fn(*args)
            bitwise = all(torch.equal(a, b) for a, b in zip(out, plain[name]))
            print(json.dumps(dict(
                variant=variant, phase=name, card=card, bitwise=bitwise,
                fused_ms=events_ms(lambda: fn(*args)),
                fused_device_ms=device_ms(lambda: fn(*args)),
                back_end_ms=events_ms(lambda: cc.cull_blocks(*back)),
                back_end_device_ms=device_ms(lambda: cc.cull_blocks(*back)))), flush=True)
        for k, v in saved.items():
            setattr(cc, k, v)


if __name__ == "__main__":
    main()
