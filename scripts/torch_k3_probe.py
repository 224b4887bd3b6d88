#!/usr/bin/env python3
"""K3 (the block cull, ``rmcl_tpu_torch/csrc/cull_blocks.cu``) at the
shapes of ``chip_smoke.py``'s phases, on one NVIDIA card, timed and split
by stage, beside an older checkout's K3 on the same inputs.

Shapes (each built as its phase builds it, the budgets the phase's audit
settled on in the runs of ``PERF.md``):

- phase 4: the building (``make_building_scene(subdiv=45)``), one VLP-16
  scan, 128-ray blocks of 4 cones, c_super 24, c_bin 96;
- phase 5: 1000 poses x VLP-16 in the ~1M-face sphere, 32-ray blocks;
- phase 6: ``TrackedCorrector``'s factored blocks of that scan (margins
  0.05 m, 0.01 rad);
- phase 7: the sweep's reuse cull (the bench's defaults, 128 cones);
- phase 11a: MCL's update rays, 262,144 particles x 100 beams (204,800
  blocks of 8 cones), the hyper level: c_hyper 8, c_super 48, c_bin 288;
- phase 11b: 65,536 particles, the mid level: 12, 192, 384, 3,072;
- phase 14a: the JAX backward benchmark's rays (100 poses x VLP-16 of 900
  columns in the sphere, bins 64/16/16), c_hyper 160, 192, 512;
- phase 14b: the flattened scene graph, 100 VLP-16 poses, 3,072, 12,288;
- past the old cap: phase 8's blocks of the building at 16 faces a bin,
  476 supers of 64 at c_super 300, c_bin 4,000 (19,200 keys at level 1),
  and 30,409 supers of one bin at 96, 96 (30,409 keys at level 0).

For each it prints one JSON line: K3's time (CUDA events around ``inner``
launches, the median of ``reps`` rounds; each kernel's least and greatest
round as its spread) and, with ``--parent DIR`` (an older checkout
unpacked under the git-ignored ``build/``), the older K3's
on the same inputs in turn (``null`` where it refuses the shape); the lists
of K3 against its plain version on the first blocks (bitwise) and against
the older kernel's (blocks that differ: the older cull drops flat bins);
the bound (``chip_smoke.full_cull_bound`` / ``fused_bound``) and the
share; the launch plan; and the split of each kernel's time between its
stages, from copies of both sources with ``clock64()`` laps at the stage
boundaries, read by thread 0 after each barrier and summed over blocks
(bounds; box tests with their compaction; selection: the radix select
and the kept keys' compaction, or streamed passes; sort; decoding and
output), as shares of the cycles times the kernel's time; and the time of
a variant that sorts every kept list of ``RADIX_MIN`` keys or more by a
CTA radix sort instead of the bitonic network. Run from the repo
root on the card (~4 minutes; ~6 with a parent):

    python -m scripts.torch_k3_probe [--parent build/parent] [--only NAME ...]
"""

import argparse
import ctypes
import functools
import json
import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from rmcl_tpu_torch import _build
from rmcl_tpu_torch.ops import cull_cuda as cc

OUT_DIR = _build.BUILD_DIR.parent / "k3_probe"
PLAIN_BLOCKS = 512
STAGES = ("bounds", "tests", "select", "sort", "output")

# the laps: static shared cycle counters of thread 0, added into one global
# array per stage at the kernel's end
LAPS = r'''
__device__ unsigned long long g_probe_cycles[5];
__device__ __forceinline__ long long& probe_t() { __shared__ long long t; return t; }
__device__ __forceinline__ long long* probe_acc() { __shared__ long long a[5]; return a; }
__device__ __forceinline__ void probe_start() {
  if (threadIdx.x == 0) {
    probe_t() = clock64();
    for (int k = 0; k < 5; ++k) probe_acc()[k] = 0;
  }
}
__device__ __forceinline__ void probe_lap(int k) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    probe_acc()[k] += now - probe_t();
    probe_t() = now;
  }
}
__device__ __forceinline__ void probe_flush() {
  if (threadIdx.x == 0)
    for (int k = 0; k < 5; ++k) atomicAdd(&g_probe_cycles[k], (unsigned long long)probe_acc()[k]);
}
extern "C" int rmcl_probe_cycles(unsigned long long* out, int reset) {
  cudaMemcpyFromSymbol(out, g_probe_cycles, sizeof(g_probe_cycles));
  if (reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
  }
  return (int)cudaGetLastError();
}
'''


# a CTA radix sort of the kept keys, for the variant that sorts lists of
# RADIX_MIN keys or more with it instead of the bitonic network: LSD, 4-bit
# digits over the keys' live bits, each thread a contiguous run of keys with
# its digit counts in a column of shared memory, one block scan a pass (a
# stable scatter in key order) into a buffer of key_slots keys past the
# kernel's shared memory
RADIX_MIN = 256
RADIX = r'''
__device__ __forceinline__ u64*& radix_tmp() { __shared__ u64* p; return p; }

// exclusive prefix sums of a[0 .. 16 T), 16 consecutive entries a thread
template <int T>
__device__ void scan16(unsigned* a) {
  __shared__ unsigned wsum[T / 32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  unsigned v[16], s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += (v[j] = a[tid * 16 + j]);
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const unsigned x = lane < T / 32 ? wsum[lane] : 0u;
    unsigned ix = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, ix, off);
      if (lane >= off) ix += y;
    }
    if (lane < T / 32) wsum[lane] = ix - x;
  }
  __syncthreads();
  unsigned base = wsum[w] + incl - s;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    a[tid * 16 + j] = base;
    base += v[j];
  }
  __syncthreads();
}

template <int T>
__device__ void radix_sort(u64* keys, int c, int bits) {
  __shared__ unsigned cnt[16 * T];
  u64 *src = keys, *dst = radix_tmp();
  const int per = (c + T - 1) / T;
  const int lo = min((int)threadIdx.x * per, c), hi = min(lo + per, c);
  for (int shift = 0; shift < bits; shift += 4) {
#pragma unroll
    for (int d = 0; d < 16; ++d) cnt[d * T + threadIdx.x] = 0;
    for (int i = lo; i < hi; ++i) ++cnt[(int)((src[i] >> shift) & 15) * T + threadIdx.x];
    __syncthreads();
    scan16<T>(cnt);
    for (int i = lo; i < hi; ++i) {
      const u64 k = src[i];
      dst[cnt[(int)((k >> shift) & 15) * T + threadIdx.x]++] = k;
    }
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
  }
  if (src != keys) {
    for (int i = threadIdx.x; i < c; i += T) keys[i] = src[i];
    __syncthreads();
  }
}

template <int T, int MaxN, int Spread>
__device__ void sort_any(u64* keys, int c, int bits) {
  if (c >= RADIX_MIN_KEYS)
    radix_sort<T>(keys, c, bits);
  else
    sort_kept<T, MaxN, Spread>(keys, c);
}

'''


def radix_variant(src_dir, out_dir):
    """Copies of cull_blocks.cu and its header in out_dir whose levels sort
    kept lists of RADIX_MIN keys or more by the CTA radix sort."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (src_dir / "cull_blocks.cu").read_text()
    head = (src_dir / "key_sort.cuh").read_text()
    head = _sub(head, r"(// A level of n items:)",
                RADIX.replace("RADIX_MIN_KEYS", str(RADIX_MIN)).replace("\\", "\\\\")
                + r"\1", 1)
    head = _sub(head, r"sort_kept<T, MaxN, Spread>\(stage, m\);", "sort_any<T, MaxN, Spread>(stage, m, bits);", 1)
    head = _sub(head, r"sort_kept<T, MaxN, Spread>\(region, m < keep \? m : keep\);",
                "sort_any<T, MaxN, Spread>(region, m < keep ? m : keep, bits);", 1)
    src = _sub(src, r"(  int\* s_mid = s_sup \+ A\.cs;[^\n]*\n)",
               r"\1  if (threadIdx.x == 0)\n    radix_tmp() = reinterpret_cast<u64*>(((size_t)(s_mid + "
               r"(A.cm > 0 ? A.cm : 1)) + 7) & ~(size_t)7);\n", 1)
    src = _sub(src, r"const size_t smem = A\.smem_bytes;",
               "const size_t smem = A.smem_bytes + 8 + (size_t)A.key_slots * 8;", 1)
    (out_dir / "cull_blocks.cu").write_text(src)
    (out_dir / "key_sort.cuh").write_text(head)
    return out_dir


def _sub(src, pattern, repl, count=0):
    """re.sub that must match (a source the laps no longer fit fails loudly)."""
    out, n = re.subn(pattern, repl, src, count=count)
    if not n:
        raise SystemExit(f"torch_k3_probe: no match for {pattern!r} in the kernel's source")
    return out


def stamped(src_dir, out_dir):
    """Copies of cull_blocks.cu and its header with the laps, in out_dir;
    the older source (a full sort of every passing key, sort_keys) and the
    present one (key_sort.cuh's cull_level) each get theirs."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (src_dir / "cull_blocks.cu").read_text()
    head = (src_dir / "key_sort.cuh").read_text()
    head = head.replace("#pragma once", "#pragma once\n" + LAPS, 1)
    src = _sub(src, r"(  const int blk = blockIdx\.x;\n)", r"  probe_start();\n\1", 1)
    if "sort_keys(s_keys, m);" in src:  # the older kernel
        src = _sub(src, r"(  // this lane's sub-block cones)", r"  probe_lap(0);\n\1", 1)
        src = _sub(src, r"(\n\s*)(test_level<)", r"\1probe_lap(4);\1\2")
        src = _sub(src, r"(m = take_count\(&s_count\);)", r"\1 probe_lap(1);")
        src = _sub(src, r"(sort_keys\(s_keys, m\);)", r"\1 probe_lap(3);")
    else:
        src = _sub(src, r"(  const int L = sh\.L;)", r"  probe_lap(0);\n\1", 1)
        head = _sub(head, r"(  const bool direct = n <= keep;)", r"  probe_lap(4);\n\1", 1)
        head = _sub(head, r"(  const int m = gather<T>\(each, kSentinel, stage, cap, s\);)",
                    r"\1\n  probe_lap(1);", 1)
        head = _sub(head, r"(    sort_kept<T, MaxN, Spread>\(stage, m\);)", r"\1\n    probe_lap(3);", 1)
        head = _sub(head, r"(  sort_kept<T, MaxN, Spread>\(region, m < keep \? m : keep\);)",
                    r"  probe_lap(2);\n\1\n  probe_lap(3);", 1)
    src = _sub(src, r"(\n  if \(tid == 0\) \{\n    A\.cand_count\[blk\])",
               r"\n  probe_lap(4);\n  probe_flush();\1", 1)
    (out_dir / "cull_blocks.cu").write_text(src)
    (out_dir / "key_sort.cuh").write_text(head)
    for extra in src_dir.glob("*.cuh"):
        if extra.name != "key_sort.cuh":
            shutil.copy(extra, out_dir / extra.name)
    return out_dir


def build(src_dir, tag):
    """cull_blocks.cu of ``src_dir`` compiled with the port's flags (and
    -Xptxas -v); returns (library, ptxas lines on registers and spills)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / ("".join(c if c.isalnum() else "_" for c in tag) + ".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(src_dir), "-o", str(so), str(src_dir / "cull_blocks.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {tag}:\n{proc.stdout}{proc.stderr}")
    ptxas = [line.split(":", 1)[-1].strip() for line in proc.stderr.splitlines()
             if "registers" in line or "spill" in line]
    return ctypes.CDLL(str(so)), ptxas


class ParentArgs(ctypes.Structure):
    """The older entry's struct: no launch plan (its kernel sizes its key
    region by the widest level); the plan's fields trail it, unread."""
    _fields_ = ([(n, ctypes.c_void_p) for n in cc._PTRS]
                + [(n, ctypes.c_int) for n in cc._INTS
                   if n not in ("threads", "key_slots", "smem_bytes", "stream")]
                + [(n, ctypes.c_uint) for n in cc._UINTS] + [(n, ctypes.c_int) for n in cc._FLAGS]
                + [(n, ctypes.c_float) for n in cc._FLOATS]
                + [("threads", ctypes.c_int), ("key_slots", ctypes.c_int),
                   ("smem_bytes", ctypes.c_int), ("stream", ctypes.c_int)])


def entry(lib, struct):
    fn = lib.rmcl_cull
    fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, struct, call):
    """``call()`` (a K3 wrapper on fixed arguments) through library entry
    ``fn`` and argument struct ``struct``; the error's text where the entry
    refuses."""
    def run():
        kernel, args = cc._kernel, cc._CullArgs
        cc._kernel, cc._CullArgs = (lambda: fn), struct
        try:
            return call()
        finally:
            cc._kernel, cc._CullArgs = kernel, args
    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return repr(exc)
    return run


def interleaved_runs(shapes, reps, inner):
    """Milliseconds a launch of each shape (name -> launch function) in each
    of ``reps`` rounds that time every shape in turn, each by CUDA events
    around ``inner`` launches back to back."""
    for launch in shapes.values():
        launch()
    times = {k: [] for k in shapes}
    for _ in range(reps):
        for k, launch in shapes.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(inner):
                launch()
            ev[1].record()
            ev[1].synchronize()
            times[k].append(ev[0].elapsed_time(ev[1]) / inner)
    return times


def split_ms(lib, run, ms):
    """The stage split of ``run`` (a launcher through a stamped build):
    cycles summed over blocks per stage, as shares of ``ms``."""
    read = lib.rmcl_probe_cycles
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 5)()
    run()
    torch.cuda.synchronize()
    read(buf, 1)
    run()
    torch.cuda.synchronize()
    read(buf, 1)
    cycles = np.array(list(buf), np.float64)
    return {k: float(ms * c / cycles.sum()) for k, c in zip(STAGES, cycles)}


@functools.lru_cache(maxsize=None)
def _building():
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    return make_building_scene(subdiv=chip_smoke.BUILDING_SUBDIV)


@functools.lru_cache(maxsize=None)
def _sphere_mesh():
    from rmcl_tpu_torch.geom.mesh import make_sphere
    return make_sphere(chip_smoke.SPHERE_LAT_LON, chip_smoke.SPHERE_LAT_LON, radius=50.0)


def _scan(pose):
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.sensors.models import SphericalModel

    model = SphericalModel.vlp16()
    o_s, d_s = model.rays("cuda")
    tsm = Transform.from_pose_tuple(pose)
    return tsm.apply(o_s), tsm.rotate(d_s), model.range.min, model.range.max


def _dense(bins, o, d, t_min, t_max, Rb, R, cs, cb, ch=0, cm=0):
    """(cull_rays, its arguments, its plain version) of rays in Rb-ray
    blocks of R cones at budgets (cs, cb, ch, cm) as the engine resolves
    them."""
    from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _pad_rays, _resolve_budgets

    cs, cb, cm = _resolve_budgets(bins, cs, cb, cm)
    blocks = tuple(x.contiguous() for x in _pad_rays(*_flat_rays(o, d, t_min, t_max)[:4], Rb))
    return cc.cull_rays, (bins, *blocks, R, cs, cb, min(ch, bins.n_hyper), cm), \
        cc.cull_rays_reference


def case_phase4():
    from rmcl_tpu_torch.geom.map import MeshMap
    return _dense(MeshMap.from_mesh(_building()).bins, *_scan([9.0, 3.0, 1.7, 0.0, 0.0, 0.35]),
                  128, 4, 24, 96)


def case_phase6():
    """The tracked corrector's factored blocks of phase 4's scan: one pose,
    128 directions a block, margins 0.05 m and 0.01 rad."""
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.ops.raycast_binned import _pad_factored_blocks, _resolve_budgets

    bins = MeshMap.from_mesh(_building()).bins
    o, d, t_min, t_max = _scan([9.0, 3.0, 1.7, 0.0, 0.0, 0.35])
    d = torch.cat([d, d[-1:].expand((-d.shape[0]) % 128, 3)])  # the layout's padding
    d_f = d.reshape(-1, 128, 3).contiguous()
    o_f = o[:1].expand(d_f.shape[0], 1, 3).contiguous()
    o_p, d_p, alive, *_ = _pad_factored_blocks(o_f, d_f, None, 512)
    cs, cb, _ = _resolve_budgets(bins, 24, 96)
    return cc.cull_factored, (bins, o_p, d_p, alive, t_min, t_max, 4, cs, cb, 0, 0.05, 0.01), \
        cc.cull_factored_reference


def case_past_cap(S, cs, cb):
    from rmcl_tpu_torch.bvh.bins import build_bins
    bins = build_bins(_building(), bin_size=chip_smoke.K7_WIDE_BIN_SIZE, bins_per_super=S)
    return _dense(bins, *_scan([9.0, 3.0, 1.5, 0.0, 0.0, 0.3]), 128, 4, cs, cb)


def case_phase5():
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform
    from rmcl_tpu_torch.sensors.models import SphericalModel

    model = SphericalModel.vlp16()
    o_s, d_s = model.rays("cuda")
    trans = np.random.default_rng(0).uniform(-5, 5, size=(chip_smoke.N_POSES, 3))
    tsm = Transform(rot=Quaternion.identity((chip_smoke.N_POSES,), "cuda"),
                    trans=torch.from_numpy(trans.astype(np.float32)).cuda()).expand_dims(-1)
    return _dense(build_bins(_sphere_mesh(), bin_size=64), tsm.apply(o_s), tsm.rotate(d_s),
                  model.range.min, model.range.max, chip_smoke.CAST_BLOCK_SIZE, 4, 24, 96)


def case_phase14a():
    """The backward benchmark's rays in the sphere, bins 64/16/16, at the
    budgets its audit reaches (c_hyper 160, c_super 192, c_bin 512)."""
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.sensors.models import SphericalModel

    bins = build_bins(_sphere_mesh(), bin_size=64, bins_per_super=16, supers_per_hyper=16)
    _, dirs = SphericalModel.vlp16(width=900).rays("cuda")
    t0 = torch.from_numpy(np.random.default_rng(0).uniform(-5, 5, (chip_smoke.BW_POSES, 3))
                          .astype(np.float32)).cuda()
    nd = dirs.shape[0]
    return _dense(bins, t0[:, None].expand(-1, nd, 3).reshape(-1, 3),
                  dirs[None].expand(t0.shape[0], nd, 3).reshape(-1, 3), 0.0, 3.0e38, 128, 4, 192,
                  512, ch=160)


def case_phase7():
    from rmcl_tpu_torch.bench import SweepBench, settings_from_env
    from rmcl_tpu_torch.ops.raycast_binned import (_hyper_budget, _pad_factored_blocks,
                                                   _resolve_budgets)

    cfg, _ = settings_from_env({})
    bench = SweepBench(**cfg, device="cuda")
    est0 = bench.trans_true + torch.tensor([0.0, 0.0, 0.2], device="cuda")
    o_p, d_p, alive, *_ = _pad_factored_blocks(*bench.sweep.factored_rays(est0, bench.dirs),
                                               None, cfg["block_chunk"])
    cs, cb, _ = _resolve_budgets(bench.bins, cfg["c_super"], cfg["c_bin"])
    ch = _hyper_budget(bench.bins, cfg["c_hyper"])
    return cc.cull_factored, (bench.bins, o_p, d_p, alive, 0.0, 3.0e38, cfg["sub_blocks"], cs,
                              cb, ch, bench.margin, 0.0), cc.cull_factored_reference


@functools.lru_cache(maxsize=None)
def _mcl_rays():
    """Phase 11's map and one chunk's update rays (262,144 particles x 100
    beams, beam-major)."""
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.sensor_update import probe_update_rays, sample_beams

    mmap, _, truth, points, mask, scfg = chip_smoke.mcl_world()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cloud = chip_smoke.mcl_cloud(truth, chip_smoke.MCL_CHUNK, gen)
    beams = sample_beams(gen, points, mask, chip_smoke.MCL_BEAMS)
    o, d, t = probe_update_rays(cloud, None, None, None, Transform.identity(), scfg, beams=beams)
    return mmap.bins, scfg, o, d, t


def case_phase11a():
    bins, scfg, o, d, t = _mcl_rays()
    return _dense(bins, o, d, 0.0, t, scfg.block_size, scfg.sub_blocks, scfg.c_super, scfg.c_bin,
                  ch=scfg.c_hyper)


def case_phase11b():
    """The first 65,536 particles of each beam, at phase 11b's mid-level
    budgets (c_hyper 12, c_super 192, c_mid 384, c_bin 3,072)."""
    bins, scfg, o, d, t = _mcl_rays()
    n = chip_smoke.MCL_SLICE * chip_smoke.MCL_BEAMS
    sl = lambda x: x.reshape(chip_smoke.MCL_BEAMS, -1, *x.shape[1:])[:, :chip_smoke.MCL_SLICE] \
        .reshape(n, *x.shape[1:])
    return _dense(bins, sl(o), sl(d), 0.0, sl(t), scfg.block_size, scfg.sub_blocks, 192, 3072,
                  ch=12, cm=384)


def case_phase14b():
    """The flattened scene graph's bins, 100 VLP-16 poses, at the budgets
    its audit reaches (c_super 3,072, c_bin 12,288)."""
    from rmcl_tpu_torch.sensors.models import SphericalModel

    model = SphericalModel.vlp16()
    acc = chip_smoke.phase14_scene(_building()).build(**chip_smoke.SCENE_BIN)
    o, d = chip_smoke.scene_rays(model, chip_smoke.BW_POSES, chip_smoke.SCENE_SEED)
    return _dense(acc.bins, o, d, model.range.min, model.range.max, 128, 4, 3072, 12288)


# the shapes past the old cap last: an older kernel that refuses them may
# leave its error for its next launch's check
CASES = [("phase 4", case_phase4), ("phase 6", case_phase6), ("phase 5", case_phase5),
         ("phase 14a", case_phase14a), ("phase 7", case_phase7), ("phase 11a", case_phase11a),
         ("phase 11b", case_phase11b), ("phase 14b", case_phase14b)] + [
    (f"past the cap: S {S}, cs {cs}, cb {cb}", functools.partial(case_past_cap, S, cs, cb))
    for S, cs, cb in chip_smoke.K7_WIDE_LEVELS]


def bound(fn, args):
    """chip_smoke's bound of one launch on every block of ``args``."""
    if fn is cc.cull_rays:
        bins, *blocks, R, cs, cb, ch, cm = args
        return chip_smoke.full_cull_bound(bins, tuple(blocks), R, cs, cb, ch, cm)
    bins, o_p, d_p, alive, t_min, t_max, R, cs, cb, ch, om, dm = args
    back = cc._cull_args(bins, cc._factored_bounds(o_p, d_p, alive, t_min, t_max, R, om, dm),
                         R, cs, cb, ch)
    tests = float(cc.cull_tests(*back[:2], *back[3:10]).double().sum())
    return chip_smoke.fused_bound(fn, args, back, tests) + (tests,)


def head(fn, args, k):
    """The wrapper's arguments on the first k blocks."""
    n = 4 if fn is cc.cull_rays else 3
    return (args[0], *(x[:k].contiguous() for x in args[1:1 + n]), *args[1 + n:])


def plan_of(fn, args):
    bins = args[0]
    if fn is cc.cull_rays:
        ob, R, cs, cb, ch, cm = args[1], *args[5:]
        Cb, n_rays = ob.shape[0], ob.shape[1]
    else:
        o_p, d_p, R, cs, cb, ch = args[1], args[2], *args[6:10]
        cm, Cb = 0, o_p.shape[0]
        n_rays = d_p.shape[1] if d_p.shape[1] % R == 0 else o_p.shape[1] * d_p.shape[1]
    return cc.cull_launch_plan(Cb, R, n_rays, bins.n_super, bins.bins_per_super, cs, cb, ch,
                               bins.n_hyper if ch else 0, bins.supers_per_hyper, cm,
                               bins.bins_per_mid)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose K3 to time too")
    ap.add_argument("--only", nargs="*", help="case names (prefixes) to run")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--quick", action="store_true",
                    help="K3 and the parent timed, K3's split; no radix variant, no parent "
                         "split, no bound")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_probe needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    sources = {"K3": _build.CSRC, "K3 stamped": stamped(_build.CSRC, OUT_DIR / "stamped")}
    if not args.quick:
        sources["K3 radix sort"] = radix_variant(_build.CSRC, OUT_DIR / "radix")
    if args.parent:
        parent = Path(args.parent) / "rmcl_tpu_torch" / "csrc"
        sources["parent"] = parent
        if not args.quick:
            sources["parent stamped"] = stamped(parent, OUT_DIR / "parent_stamped")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources.values(), sources)))
    for tag, (_, ptxas) in libs.items():
        print(json.dumps({"build": tag, "card": card, "ptxas": ptxas}), flush=True)
    structs = {"K3": cc._CullArgs, "K3 stamped": cc._CullArgs, "K3 radix sort": cc._CullArgs,
               "parent": ParentArgs, "parent stamped": ParentArgs}

    failed = []
    for name, make in CASES:
        if args.only and not any(name.startswith(p) for p in args.only):
            continue
        try:
            probe(name, make, libs, structs, card, args.reps, args.quick)
        except Exception as exc:  # report and go on with the other shapes
            failed.append(name)
            print(json.dumps({"case": name, "card": card, "error": repr(exc)}), flush=True)
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"torch_k3_probe: failed on {failed}")


def probe(name, make, libs, structs, card, reps, quick=False):
    """One shape: K3 against its plain version, timed beside the parent's
    and the radix-sort variant, its bound and its stage split."""
    fn, fargs, plain = make()
    call = lambda fn=fn, fargs=fargs: fn(*fargs)
    runs = {tag: launcher(entry(lib, structs[tag]), structs[tag], call)
            for tag, (lib, _) in libs.items()}
    refused = {tag: r for tag, r in runs.items() if isinstance(r, str)}
    runs = {tag: r for tag, r in runs.items() if tag not in refused}
    if "K3" in refused:
        raise RuntimeError(f"{name}: K3 refused the shape: {refused['K3']}")
    want = [x.clone() for x in runs["K3"]()]
    k = min(PLAIN_BLOCKS, want[0].shape[0])
    got = plain(*head(fn, fargs, k))
    bitwise = all(torch.equal(a[:k], b) for a, b in zip(want, got))
    if not bitwise:
        raise RuntimeError(f"{name}: K3 differs from its plain version")
    if not all(torch.equal(a, b) for a, b in zip(runs["K3 stamped"](), want)):
        raise RuntimeError(f"{name}: the stamped K3 differs from K3")
    radix = runs.get("K3 radix sort")
    if radix and not all(torch.equal(a, b) for a, b in zip(radix(), want)):
        raise RuntimeError(f"{name}: the radix-sort variant differs from K3")
    timed = {t: runs[t] for t in ("parent", "K3", "K3 radix sort") if runs.get(t)}
    runs_ms = interleaved_runs(timed, reps, 3)
    ms = {k: statistics.median(v) for k, v in runs_ms.items()}
    out = {"case": name, "card": card, "blocks": want[0].shape[0],
           "cones": fargs[6] if fn is cc.cull_factored else fargs[5], "ms": ms["K3"],
           "parent_ms": ms.get("parent"), "radix_sort_ms": ms.get("K3 radix sort"),
           "spread_ms": {k: [min(v), max(v)] for k, v in runs_ms.items()},
           "plan": plan_of(fn, fargs),
           "refused": refused, "bitwise_plain_blocks": k, "saturated": int(want[3].sum()),
           "mean_count": float(want[1].float().mean()), "max_count": int(want[1].max())}
    if runs.get("parent"):
        old = runs["parent"]()
        same = (old[0] == want[0]).all(1) & (old[1] == want[1]) & (old[3] == want[3])
        out["blocks_unlike_parent"] = int((~same).sum())
        out["parent_mean_count"] = float(old[1].float().mean())
    if not quick:
        out["bound_ms"], out["bound_by"], out["tests"] = bound(fn, fargs)
        out["share"] = out["bound_ms"] / out["ms"]
    out["split_ms"] = split_ms(libs["K3 stamped"][0], runs["K3 stamped"], ms["K3"])
    if runs.get("parent stamped"):
        out["parent_split_ms"] = split_ms(libs["parent stamped"][0], runs["parent stamped"],
                                          ms["parent"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
