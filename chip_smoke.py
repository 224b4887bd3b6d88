#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card, and check them.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):

1. device: the card's name and power limit (nvidia-smi) and the float32
   matmul flags — the normal equations must not run in TF32;
2. build: the port's CUDA kernels, compiled by nvcc from
   ``rmcl_tpu_torch/csrc`` in parallel (K1 candidate-bin intersection and
   its dir_groups form K2g, K3 block cull with its bounds, K4 factored pair
   loop, K5 BVH traversal, K6 closest point over the BVH, K6b closest point
   over candidate bins, K7 the closest-point candidate cull, MICP-L's
   Gauss-Newton loop, the batch corrector's epilogue), and beside
   them the native host library (the kd bin order, the SAH BVH) by g++;
   every map below is binned in the native order, or the run fails;
3. K1 vs plain version: the intersection kernel against its plain PyTorch
   version on the same CUDA tensors, for 14,400 VLP-16 rays on the room
   scene (128-ray blocks, and 100-ray blocks whose last warp is partly
   idle) and on the ~1M-face sphere, with timings;
4. main path: MICP-L on a ~480k-face building map — ten ``correct_once``
   calls from +0.2 m z / 0.05 rad yaw back to the true pose, counting the
   K1 and K3 launches (one K3 launch a cull); both kernels are then held
   against their plain versions on the main path's own inputs and timed
   beside their bounds, and the cast is repeated with no candidate budget
   to measure the hits the default budgets cost; the Gauss-Newton kernel
   launches once a correction (phase 16 checks and times it);
5. reference-size cast: 1000 poses x VLP-16 (14.4M rays) against the
   ~1M-face sphere through the dense engine, with the split between the
   cull (K3, held against its plain version) and K1; the default 128-ray
   blocks are measured too;
6. tracking: ``TrackedCorrector`` on phase 4's map, sensor and start pose,
   ten steps with candidate reuse (K3 on re-culls, K4 every step); K3 and
   K4 held against their plain versions on the last step's inputs, K4 in
   its tracking layout (one pose) and in its paired layout (one origin per
   direction);
7. the pose sweep at full width (``rmcl_tpu_torch.bench``: 1000 poses x
   VLP-16 on the ~1M-face sphere, 16-pose x 8-direction factored blocks,
   hypers -> supers -> bins, one reuse cull per 16-step chain): the
   dataset's hits, ms per correction over three chains, ten iterated
   corrections from +0.2 m z, and K3/K4 against their plain versions with
   timings and bounds; the batch corrector's epilogue kernel (one launch a
   correction) against its plain version on one correction's winners, timed
   by the trace beside its bound and the plain version;
8. MICP-L on the exact engine and with closest-point correspondences:
   phase 4's map (now with its BVH) and start pose, the exact engine's scan
   at the true pose, ten
   ``correct_once`` each with CP correspondences on the bins (K7 + K6b), RC
   on the BVH (K5) and CP on the BVH (K6), each held to the JAX package's
   final error and to one launch a correction; K5, K6, K6b and K7 against
   their plain versions on the last corrections' inputs (bitwise, K6 at the
   split P its wrapper takes, and also against the serial walk), the lanes
   each launch takes (K6's P, K6b's G), the registers of the closest-point
   and exact engines' kernels (none may spill), the divisions K6b's pairs
   run, K7 timed by the profiler's device trace beside its bound and the
   device time of an empty launch at its grid (the floor under a bound
   below a microsecond), K7 on levels wider than 16,384 keys (phase 4's
   building at 16 faces a bin: cs x S = 19,200, and 30,409 supers), and
   the exact engine's hits against the unbudgeted dense engine's;
9. the exact engine at the reference benchmark's size: the ~1M-face
   sphere's BVH, phase 5's 14.4M rays through ``cast_rays`` (K5; t against
   the dense cast), the noisy hit points' closest points through both
   engines (K7 + K6b, K6; they must agree), ``occluded`` on 1000 particle
   moves, each kernel against its plain version on a 262,144-ray or -query
   slice (K7 on the first 2,048 query blocks), and the binned query split
   by CUDA events into its steps (the Morton order, the candidate cull K7,
   K6b, the winners and un-permute);
10. MCL's sensor-update cast at the reference's size: 1,048,576 particles
   uniform over phase 4's building floor x 100 beams sampled from phase
   4's scan (104,857,600 rays, t_max = range + 12 m) through ``cast_rays``
   (one K5 launch), K5 against its plain version on a 262,144-ray slice,
   timed on every ray with the beams in sampled and in angular order;
11. MCL on the card at the JAX MCL benchmark's workload (the building with
   doors at mid-wall, bins of 64 in supers of 16 and hypers of 16, one
   VLP-16 scan at the truth): (a) the full cycle on 1,048,576 particles x
   100 beams — motion update, a global cluster order, one beam sample,
   four 262,144-particle binned sensor updates (K3 with the hyper level, K1
   in candidate-count order), gladiator resampling, statistics — after the
   budget audit, a warm cycle and three timed ones, the estimate within
   0.1 m of the truth, the same cycle per engine at 1M and at 50,000
   particles (the exact one must be faster at both), the stages of one
   more cycle by events, K1 and K3 against their plain versions on a slice
   and timed on a whole chunk; (b)
   one sensor update per engine on a 65,536-particle slice with one beam
   set (bvh, seeded, binned particle-major, binned beam-major with and
   without the mid level): seeded = bvh, binned = bvh on certified
   particles, mid level = two levels, K3 with the mid level bitwise its
   plain version, K5's refine launch in the seeded pass, and a CP update
   per engine (K6, K6b), timed warm; (c) ``MCLNode`` at 100,000
   particles, ten steps of +0.2 m, with engine "auto", which on the card
   takes the exact walk for every RC cloud (one K5 launch a step and no
   other kernel, no budget audit), and with engine "binned" (the budget
   audit, then K3r and K1 on every step), each ending below 0.25 m;
12. the MICP-L node and the command-line tools at full width: phase 4's
   building written as OBJ under the git-ignored ``build/``, a 20-scan
   VLP-16 message log along a 2 m arc with odometry drifting 0.01 m and
   0.004 rad a scan, replayed by ``python -m
   rmcl_tpu_torch.tools.micp_localization`` (its ``main``) three times: RC
   on the bins (engine auto: K3 + K1), CP on the bins (K7 + K6b) and RC on
   the BVH (K5); each run's last pose within 0.02 m of the truth, its
   kernels launched, the budget audit's adoption printed (binned runs) and
   its ms per correction; K7 against its plain version on the CP run's
   last query blocks; then ``map_segmentation`` and ``rmcl_localization``
   on the log's first scans at a small size;
13. K2g and the SAH BVH: (a) the library's dense cast
   (``cast_rays_binned(dir_groups=8, sort_blocks=True)``, the JAX bench's
   c_bin) at full width, on phase 7's sweep rays materialised at its base
   estimate (``TiledSweep.rays``: 113,904 blocks of 8 directions x 16
   poses, 1000 poses x VLP-16 on the ~1M-face sphere): one K3r and one K2g
   launch, its hits against the same cast through K1; on the inputs and
   launch order that cast's cull handed K2g: K2g and K1 by the device
   trace, K2g bitwise its plain version on the first 512 blocks in launch
   order (and through casts at G = 1 and G = 4), and against K1 (hits
   equal, t within 1e-4, other winners only at near-ties); (b) ``build_bvh_sah`` on phase 4's building: build time,
   slots, K5's visits against the LBVH's, K5 bitwise its plain version,
   hits against the LBVH's;
14. the differentiable cast, scene graphs and the map formats: (a) the JAX
   backward benchmark's workload (scripts/bench_backward.py, not cut:
   100 poses x VLP-16 of 900 columns, 1,440,000 rays, on the ~1M-face
   sphere in bins of 64, supers of 16, hypers of 16) through
   ``ops.diff.cast_rays_diff``: the forward loss (sum of hit t) and its
   gradients with respect to the 100 translations and to the vertices,
   timed (K3 + K1 in count order), t against ``cast_rays_binned``'s own,
   central differences on the 5 largest-gradient coordinates of each, the
   vertex program on the sphere's BVH (K5) against the binned one, K1 and
   K3 against their plain versions on the cast's inputs; (b) a scene graph:
   phase 4's building, 8 balls and 16 boxes (half scaled) placed in its
   rooms, 100 VLP-16 poses on its floor: the budgets audited until no
   block saturates, ``cast_rays_tlas`` (K3 + K1 an instance, chained
   t_max) and the flattened binned cast against the flattened exact cast
   (K5), ``closest_points_tlas`` (K6 an instance) against the flattened
   BVH's, the gradient with respect to a ball's and a scaled box's 6 pose
   parameters against central differences, ``refine_instance_pose`` (K5)
   recovering a ball misplaced by (0, 0.15, -0.1) m, each call timed
   against its flattened counterpart, K5 and K6 against their plain
   versions; (c) the building written as binary PLY and as GLB, read back
   by ``load_mesh`` and ``MeshMap.from_file`` (PLY bitwise, GLB equal in
   value), and the MICP-L CLI on the PLY map over phase 12's first 3 scans
   against phase 12's OBJ run;
15. multi-device (``rmcl_tpu_torch.parallel``) on ranks that share the
   card, spawned after the kernels are built: NCCL at world size 1, gloo at
   2 and 4 (NCCL refuses two ranks on one GPU): (a) the JAX scaling
   benchmark's workload (scripts/bench_scaling.py, not cut: a 3600 x 64
   scan, 230,400 rays, on the ~1M-face sphere) corrected from +0.05 m z by
   ``sharded_correct_once`` on the bins (K3 + K1) and on the BVH (K5), and
   phase 8's CP-on-bins correction (K7 + K6b), each against the unsharded
   correction (pose within 1e-4, matches within 1e-5 relative), with K + 1
   = 6 all-reduces and one launch a kernel on every rank, timed; (b) on 4
   ranks, phase 11a's 1,048,576 particles x 100 beams: the binned and
   bvh sensor updates against the unsharded ones (no collective), the
   tournament on the doubling schedule (one permute), the dynamic
   residual resampler (one all-gather, shares summing to the target), the
   likelihood statistics and a sharded checkpoint (bitwise), each rank's
   peak memory; (c) phase 14a's sharded backward (1,440,000 rays, one
   all-reduce) against the unsharded loss and gradients; (d) on 4 ranks,
   phase 4's building in 4 shards on a ("scene",) mesh and in 2 on a
   ("rays", "scene") 2 x 2 mesh, phase 14b's 1,440,000 rays at budgets no
   block of any shard saturates: both scene-sharded casts against the
   unsharded cast (no ray may differ; any that does is named), every ray's
   exact winner's bin in its block's list (unsharded and each shard's), the
   election's collectives counted. A failed rank fails the run;
16. MICP-L's Gauss-Newton kernel (``ops/solve_cuda.py::p2l_gauss_newton``,
   run right after phase 4 on its map and scan): correspondences from
   phase 4's start pose, at the node's shape (14,400 pairs) and on three
   copies of them (43,200 pairs), the kernel against its plain version
   (the pipeline's torch loop, ``micp/pipeline.py::_correct_torch``)
   (pose within 1e-5 m and 1e-6 rad, matches within one, the covariance
   trace and the progress within 1e-5 relative; two launches bitwise),
   timed by the profiler's device trace beside its bound, the call by
   events, the wrapper's host time, the plain version's time, its
   registers (no spill) and its shared memory.

K3 is checked in its fused form (bounds and cull in one launch:
``cull_rays``, ``cull_factored``) and, on the plain version's cones, as
the back end alone (``cull_blocks``); each phase times the cull end to end
beside both and prints both bounds.

Prints one JSON line per kernel (``{"kernels": [...]}``, with each
kernel's roofline share, bound_ms / ms) and, last,
``{"ok": true, "device": {...}}``. Without a card it exits nonzero before
printing any result.
"""

import contextlib
import json
import math
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

import rmcl_tpu_torch  # noqa: F401  (outside a checkout of the repo: fail before any output)
from rmcl_tpu_torch.utils.tune import cp_block_need, cp_budget_need  # noqa: E402

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
CAST_BLOCK_CHUNK = 4096  # blocks per slice of K1's plain version in phase 5 (memory)
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
# K3: float instructions per cone-box test (_cone_box_test): 12 box offsets,
# 9 gap/separation maxima, 2 x 6 for the norms (square root as one), 20 for
# the first slab pass (it feeds only tf: 3 radii, 12 slab ends, 3 maxima, 2
# minima), 25 for the second (the same, plus 3 minima and 2 maxima for tn),
# 3 for the refined radius, 8 for the entry max(tn, d_near), the min with
# d_far, d_near x cos(theta_max) and its max with tn, canonical tn and three
# compares, 1 for the min over cones: 90. Of these, the box offsets, the
# maxima and the norms (33) read only the origin box: a block whose cones
# share origin boxes needs them once a box for each distinct origin box.
OPS_PER_TEST = 90
OPS_PER_GAP = 33
# K3's bounds (the fused kernel's front end). Per ray of a bounds pass: |d|^2
# 5, its clamp, square root and reciprocal 3, the unit direction 3, the live
# compare 1, the reach t_max * |d| 1, the direction sums 3 (a tree over n
# rays takes n - 1 adds a component), origin minima and maxima 6, the maxima
# of |d| and of the reach 2, the cosine to the axis 5 and its minimum 1: 30.
# Per cone: the axis (|s|^2 5, clamp, root, reciprocal 3, scale 3) 11, origin
# centre and half extent 12, the margin 3, the cosine clamp 2, tan 5, the
# widened tan 5, the scene's centre and half extent 12, the offset 3, three
# norms 18 and their two adds, two cone records (per axis: |a| compare,
# reciprocal, a^2, 1 - a^2, clamp, root; and t_hi * tan) 38 and their
# cos(theta_max) (tan^2, + 1, root, reciprocal) 8, one cone-box test
# against the scene box 90, the axial cap (scale, add, min) 3, the length
# cap (tan^2, + 1, root, clamp, two scales, add, min) 8: 220. Per factored
# origin: its minimum and maximum per axis, 6.
OPS_PER_BOUND_RAY = 30
OPS_PER_CONE = 220
OPS_PER_ORIGIN = 6
# K4: float instructions per pair (t, u, v: 5; u + v and 1 + eps - it: 2;
# four compares), per (triangle, direction) term (Nd, Bu, Bv: 15; the gate
# and the reciprocal: 2), per (triangle, pose) term (No, Au, Av: 18) and per
# triangle (the rows ng, |ng|^2, 1/|ng|^2, m1, m2, c0, cu, cv: 55); the
# packed-key integer operations are not counted, so the bound stays a floor
OPS_PER_BW_PAIR = 11
OPS_PER_BW_DIR = 17
OPS_PER_BW_POSE = 18
OPS_PER_BW_TRI = 55
# K2g: float instructions per pair (u, v, t: three dot products of 3
# products and 2 adds, and a subtraction each, 18; u + v, 1 + eps - it, two
# minima and two compares, 6), per (triangle, group) term (d x e2 9, det 5,
# the gate and the reciprocal 2, d x e1 9, the premultiplied rows 9, cu, cv,
# ct 15) and per triangle (e1 x e2 9: it does not depend on the direction,
# so the function needs it once a visit however many groups share it; the
# kernel forms it per entry)
OPS_PER_GROUP_PAIR = 24
OPS_PER_GROUP_TERM = 49
OPS_PER_GROUP_TRI = 9

# the Gauss-Newton kernel (csrc/p2l_gauss_newton.cu), float instructions a
# pair: the lift (two poses applied, 33 each, and a normal rotated, 30) and
# the centroid's sums, 8: 104; an iteration (T applied 33, the residual 8,
# the gate 2, (d' - c) x n 12, J 6, r g 1, A's 21 sums and b's 6 at a
# product, a weight and an add each, 81): 143; the statistics' two passes
# (the residual and gate again 43 each, the projection 6 each, the sums 13,
# the trace's 15): 126. Bytes: the pairs read once (three float32 triples,
# mask, found) and the 12 floats written.
OPS_PER_GN_LIFT = 104
OPS_PER_GN_ITER = 143
OPS_PER_GN_STATS = 126
GN_BYTES_PER_PAIR = 38
GN_OUT_BYTES = 48
# kernel vs plain version: the same float32 arithmetic a pair, the sums in
# another order and another 6 x 6 elimination
GN_POSE_TOL_M, GN_POSE_TOL_RAD, GN_REL_TOL = 1e-5, 1e-6, 1e-5
# the kernel's stack frame: sinf's and cosf's reduction of a huge argument
# (seven words; ptxas reports 0 bytes of spills), never reached at a solve's
# angles
GN_STACK_BYTES = 32
# the batch corrector's epilogue kernel (phase 7): a hit pair's float32
# instructions (the denominator and t 13 with the division, the normal 16
# with the square root and the division, the hit point 6, the measured point
# 3, the signed distance 8, the gate 4, the projection 6: 56) and its
# float64 ones (the relative points 12, the 16 sums 25: 37, counted twice:
# the card's float64 rate is half its float32 one): 130. Bytes: a pair's
# slot, t, row index, measured point and mask (25), the distinct winner
# rows' planes (16 B) once, the positions and directions, the output
OPS_PER_EPI_PAIR = 130
EPI_BYTES_PER_PAIR = 25
# kernel vs its plain version: the same float32 terms (the kernel is built
# with --fmad=false) and float64 sums in other orders, rounded to float32
# increments: sound runs read 0 m and 8.9e-16 rad with equal pairs; float32
# sums would read ~5e-6 m and ~1e-7 rad
EPI_POSE_TOL_M, EPI_POSE_TOL_RAD = 1e-9, 1e-9

# tolerances kernel vs plain version: built with --fmad=false the two round
# alike and agree bitwise; 1e-5 relative leaves room for the rounding of a
# near-tie only
T_RTOL = 1e-5
# K3 lists: equal, or differing only between keys that tie with the list's
# last kept entry to this relative width (a budget cut between equal keys)
TNEAR_RTOL = 1e-6

# phase 6: TrackedCorrector settings of the tracking loop
TRACK_STEPS = 10
# phase 7: the sweep's iterated correction. The bench's one-shot Umeyama
# step on point-to-plane projections contracts a z offset by only ~3% a
# step on the sphere (VLP-16 normals are near horizontal): the JAX package's
# own iteration, on the CPU at the parity test's size (32 poses, 180 x 16
# rays, a 20k-face sphere of 50 m), ends at a median 0.1499 m after ten, the
# port there at 0.1499 m too and at 0.1507 m for 1000 poses x 90 x 16 rays
# (scripts/torch_sweep_probe.py). The port is held to that figure with room
# for the full-size pose sample.
SWEEP_ITERS = 10
SWEEP_ITER_ERR_MAX = 0.155
SWEEP_CHAINS = 3

# phase 8: MICP-L on the exact engine and with closest-point correspondences,
# from phase 4's start pose, max_dist 2.0 m, against the exact engine's scan
# at the true pose. Each variant is held to the JAX package's own final
# translation error after ten corrections at the same inputs, bins in the
# native order (scripts/torch_exact_probe.py on the CPU; the port there ends
# at 4.93e-4, 0 and 1.19e-7 m), with 0.1 mm of room for the card's other
# summation order
EXACT_START = [9.0, 3.0, 1.7, 0.0, 0.0, 0.35]
EXACT_MAX_DIST = 2.0
EXACT_ERR_JAX = {"cp_bins": 5.199227579174012e-04, "rc_bvh": 2.384185791015625e-07,
                 "cp_bvh": 1.1920928955078125e-07}
EXACT_ERR_SLACK = 1e-4
# phase 8 on phase 4's budgeted scan, where the native order's bins leave
# the correction ill-conditioned (the JAX package's corrections wander
# 0.02-0.56 m and do not settle), each package on its own budgeted scan
# (they hit the same rays, points within 1.9e-6 m). The same probe, scan
# "budgeted": JAX's translation after the first correction of each
# variant, its error after every RC correction on the BVH and its final
# CP-on-the-BVH error. The port on the CPU keeps within 2.4e-7 m of JAX's
# RC corrections at every step and ends CP on the BVH at 0; its first
# corrections part from JAX's by 3.0e-4 (CP, bins) and 1.43e-3 m (CP, BVH),
# where 18 of 12,911 closest points tie between two faces and the two
# packages take the other normal: held within twice that. CP on the bins
# runs at budgets that cut no list and is held to JAX's CP on the BVH (the
# JAX figures for CP on the bins come from its cut lists); past its first
# correction it is logged beside JAX's, not held
BUDGETED_TRANS1_JAX = {
    "cp_bins": [8.999881744384766, 3.0009047985076904, 1.5844019651412964],
    "rc_bvh": [9.039022445678711, 2.9736745357513428, 1.3391839265823364],
    "cp_bvh": [9.000081062316895, 2.9988558292388916, 1.5462357997894287]}
BUDGETED_RC_ERRS_JAX = [0.16756369178354433, 0.09614690359826378, 0.08072227295598079,
                        0.17254776512550615, 0.021396346613096518, 0.1133554300443105,
                        0.1747995607088694, 0.029525412137723393, 0.13075853865399356,
                        0.1915354871840449]
BUDGETED_ERR_JAX = {"cp_bins": 0.43690453345209107, "rc_bvh": 0.1915354871840449,
                    "cp_bvh": 2.384185791015625e-07}
BUDGETED_STEP1_TOL = 3e-3
# phase 9: the exact engine at the reference benchmark's size; kernel vs
# plain version on a slice of this many rays or queries
EXACT_SLICE = 262144
QUERY_SEED = 9
QUERY_NOISE = 0.05  # m, N(0, sigma) on each coordinate of a hit point
QUERY_MAX_DIST = 0.5
QUERY_BLOCK_CHUNK = 1024  # query blocks per step of the binned engine's candidate cull
# binned vs exact distances: 1e-5 relative, or 2e-5 m (five float32 spacings
# at the sphere's 50 m radius, where each engine rounds its own point)
QUERY_DIST_RTOL = 1e-5
QUERY_DIST_ATOL = 2e-5
# phase 10: MCL's sensor-update cast at the reference's size (MCL_1M_r05.json:
# 1M particles x 100 beams on the 486,544-face building): particles uniform
# over the building's floor (make_building_scene's 4 x 3 rooms of 6 m) at
# the sensor's height, beams sampled from phase 4's scan, each beam's reach
# capped at its range + range_cap_sigmas x dist_sigma = 6 x 2.0 m
# (rmcl_tpu/mcl/sensor_update.py:115-135)
MCL_PARTICLES = 1 << 20
MCL_BEAMS = 100
MCL_SEED = 10
MCL_FLOOR = (24.0, 18.0)
MCL_Z = 1.5
MCL_RANGE_CAP = 12.0
# phase 11: MCL on the card at the JAX MCL benchmark's workload
# (scripts/bench_mcl_1m.py): the truth, the initial cloud's covariance
# (0.2 m, ~3 deg), four 262,144-particle chunks, a warm cycle and three
# timed ones; the estimate must end within 0.1 m of the truth (the cloud
# starts at 0.2 m spread). 11b: a 65,536-particle slice per engine (and the
# audit's slice in 11a), mid budgets tried in order, the CP updates'
# particles; kernel vs plain version on the first blocks of a launch. 11c:
# MCLNode at MCLConfig's default count, ten steps of +0.2 m in x, held to
# the JAX package's tracking criterion (tests/test_mcl.py: 0.25 m).
MCL_TRUTH = [3.0, 3.0, 1.2, 0.0, 0.0, 0.0]
MCL_COV = [0.04, 0.04, 0.01, 1e-4, 1e-4, 3e-3]
MCL_CHUNK = 262144
MCL_CYCLES = 3
MCL_ERR_MAX = 0.1
MCL_SLICE = 65536
MCL_CP_PARTICLES = 131072
# binned vs exact on certified particles: the share within rtol 1e-4 (a
# beam through a shared edge may hit in one engine only)
MCL_BINNED_CLOSE = 0.99
# seeded vs exact: the share of particles allowed a ray whose winner the
# two engines' triangle tests decide apart
MCL_EDGE_PARTICLES = 0.01
MCL_CHECK_BLOCKS = 512
MCL_NODE_PARTICLES = 100_000
# phase 11a's per-engine cycle at the mcl-50k-tracking cell's count
MCL_SMALL = 50_000
MCL_SMALL_CYCLES = 5
MCL_NODE_STEPS = 10
MCL_NODE_STEP = 0.2
MCL_NODE_ERR_MAX = 0.25
# phase 10b: the kernel's evals against its plain version on the first
# MCL_WS_SLICE particles. Where the winner and the ray agree an eval differs
# by the exp's last bits; a ray whose winner is a near-tie, or whose
# direction the card's and the CPU's cross products round a bit apart, may
# differ more: at most MCL_WS_EVALS_OFF of the rays. The folds (and the
# likelihoods against the composition's) within MCL_WS_FOLD_RTOL at p75.
MCL_WS_SLICE = 4096
MCL_WS_EVAL_RTOL = 1e-5
MCL_WS_EVALS_OFF = 1e-4
MCL_WS_FOLD_RTOL = 1e-6
MCL_WS_QUANTILE_CAP = 1 << 24  # torch.quantile's input limit
# K5: float instructions per ray (three guarded reciprocals, 3 each; the
# entry compare), per internal visit (the slab test: 6 differences, 6
# products, 3 minima and 3 maxima of the pairs, 2 + 2 for t_near and t_far, 3
# compares) and per leaf visit (Moller-Trumbore: 9 + 5 for p and det, 2 for
# its gate, 1 reciprocal, 3 + 6 for u, 9 + 6 for v, 6 for t, 6 for the five
# tests and u + v)
OPS_PER_TRAVERSE_RAY = 10
OPS_PER_SLAB_VISIT = 25
OPS_PER_MT_VISIT = 53
# K5's MCL scoring epilogue (ScoreRC), per ray: the ray from the particle's
# pose and the beam (two cross products of 3 products and 3 fused
# multiply-adds, 3 doublings, 3 products and 6 sums: 24), the score of a hit
# (the plane's denominator 5 and its guard 1, t 9, the compare with
# range_min 1, the point and the measured point 12, their difference 3, the
# products with the normal and their sum 5, the absolute value 1: 37) and the
# Gaussian (z and its square 3, exp 6, the factor 1: 10); the fold, per eval:
# an add in the first pass, a difference, a square and an add in the second
OPS_PER_SCORE_RAY = 71
OPS_PER_FOLD_EVAL = 4
# K6: per internal visit (the clamp 6, differences 3, squares and sums 5, a
# compare) and per leaf visit the operations every triangle needs whatever
# its Voronoi region (ericson.cuh resolves the region first and divides only
# for its own quotients, none at a vertex): ap = q - a 3, bp and cp 6, the
# six dot products 30, va vb vc 9, the vertex tests 6 (Ericson's 54); then
# the offset e = ap - v ab - w ac 12 (ap reused), |e|^2 5, a compare: 72.
# K6b: per pair the same 54 + 12 + 5 (the key's min is integer work): 71;
# per triangle and visit the padding test 12
OPS_PER_BOX_VISIT = 15
OPS_PER_CP_VISIT = 72
OPS_PER_CP_PAIR = 71
OPS_PER_CP_TRI = 12
# K7 (the closest-point candidate cull): float operations per box-box
# distance test (per axis two differences, a max and a clamp; three squares,
# two adds; the compare with the block's bound) and per query for the
# block's box and bound (three minima, three maxima, the bound's maximum)
OPS_PER_BOX_BOX = 18
OPS_PER_BLOCK_QUERY = 7
K7_PLAIN_BLOCKS = 2048  # phase 9: K7 against its plain version on this many blocks
# phase 8: K7 on levels wider than the 16,384 keys its shared memory once
# held, on phase 4's building binned at 16 faces a bin: (bins_per_super,
# cs, cb), the first with 476 supers of 64 (cs x S = 19,200 positions at
# the cb of phase 12's audit), the second with 30,409 supers of one bin
K7_WIDE_BIN_SIZE = 16
K7_WIDE_LEVELS = ((64, 300, 4000), (1, 96, 96))
LOOP_LAUNCHES = 20  # launches between two events where the device trace records none
# phase 12: the node and the tools. A 20-scan VLP-16 log at 10 Hz along a
# 2 m arc (radius 2 m over 1 rad) in phase 4's building, odometry drifting
# 0.01 m along x and 0.004 rad of yaw a scan (the golden MICP track's
# drift, tests/golden/gen_micp_track.py), three corrections a scan; the
# last pose within 2 cm of the truth. The small runs: the first scans,
# MCL at a few thousand particles, held to a sane estimate (finite, within
# the initial cloud's 0.5 m spread of the truth)
NODE_DIR = "build/phase12"
NODE_SCANS = 20
NODE_START = (8.0, 2.5, 1.5)
NODE_RADIUS = 2.0
NODE_DRIFT = (0.01, 0.004)
NODE_STEPS_PER_SCAN = 3
NODE_ERR_MAX = 0.02
SMALL_SCANS = 4
SMALL_PARTICLES = 4096
SMALL_ERR_MAX = 0.5
# phase 13: the library's dense cast (cast_rays_binned with dir_groups) at
# full width with the JAX bench's c_bin, against the same cast through K1:
# a ray through a shared edge may slip past one kernel's test (the sweep
# cell's dataset check sees 0-3 in 345,600; here 108 of 14,579,712 on an
# H100), so a share of hits may differ;
# K2g against its plain version on the first blocks in launch order
DENSE_CHECK_BLOCKS = 512
DENSE_C_BIN = 64
DENSE_HIT_DIFF = 1e-5
# the SAH BVH's hits against the LBVH's: rays that graze an edge may be
# decided apart, as phase 8 allows between the exact and dense engines
SAH_HIT_DIFF = 0.001

# phase 14a: scripts/bench_backward.py's workload (100 poses x VLP-16 of 900
# columns on the ~1M-face sphere, its bins and cast settings), not cut
BW_POSES = 100
BW_CAST = dict(c_super=24, c_bin=64, c_hyper=20, sort_blocks=True, block_size=128,
               dir_groups=0)
BW_REPS = 5  # timed runs of each program (median), after a warm-up
# central differences on a float32 t: eps 1e-3 m; one ray's difference
# carries up to ~2e-3 of rounding (t ~ 50 m has float32 spacings of 3.8e-6),
# so a pose's 14,400 rays sum to ~0.2 of noise: translations within 1% +
# 0.5, vertices (a few rays each) within 1% + 5e-2 (tests/test_raycast_binned.py's
# atol)
FD_EPS = 1e-3
FD_TRANS_TOL = (1e-2, 0.5)
FD_VERT_TOL = (1e-2, 5e-2)
BVH_T_RTOL = 1e-4  # the exact engine's t against the binned engine's
HIT_AGREE = 0.999
# phase 14b: phase 4's building and instances placed in its rooms
SCENE_SEED = 14
SCENE_BALLS = 8
SCENE_BOXES = 16
SCENE_BIN = dict(bin_size=64, bins_per_super=64)
SCENE_BUDGETS = (24, 96)  # the audit starts at the defaults and doubles both
SCENE_AUDIT_ROUNDS = 8
SCENE_T_RTOL = 1e-4  # tests/test_tlas.py's bars: t, normals
SCENE_NORMAL_TOL = 1e-4
# a ray the TLAS (or the flattened bins) and the exact engine decide apart
# must pass within this many float32 roundings of its winner's world
# triangle (spacing at the triangle over its shortest edge: a 0.6 mm edge
# of the ball's pole at 20 m from the origin makes one rounding 3e-3) plus
# the slack of the triangle tests' float32 barycentrics; the normals of
# the same triangle agree within SCENE_NORMAL_TOL plus as many roundings
EDGE_SCALES = 16
EDGE_SLACK = 1e-6
# t of the same triangle in two frames: float32 coordinates up to |o| + t
# from the world's zero round t by ~2^-23 (|o| + t) / |cos| of incidence
GRAZE_ULPS = 4
# the pose gradients: float32 t of ~1,000 rays at 2-10 m, each difference
# off by up to 2.4e-4 (t's spacing over 2 eps); the atol also takes the
# origin's rounding in the instance frame (phase_scene_graph)
SCENE_FD_TOL = (1e-2, 5e-2)
REFINE_OFFSET = (0.0, 0.15, -0.1)  # tests/test_scene.py's misplacement
REFINE_STEPS = 8
REFINE_TOL = 0.02  # tests/test_scene.py's atol on the recovered centre
REFINE_RANGE = 1.5  # m from the sensor to the ball's centre
# phase 14c: map files written here (git-ignored), the CLI on a short log
FORMAT_DIR = "build/phase14"
FORMAT_SCANS = 3


# phase 15: the JAX scaling benchmark's scan (scripts/bench_scaling.py: 3600 x 64
# on the ~1M-face sphere from (1, -2, 0.5)), corrected from +0.05 m z; the
# world sizes and their backends (NCCL refuses two ranks on one card)
P15_SCAN = (3600, 64)
P15_TRUE = [1.0, -2.0, 0.5, 0.0, 0.0, 0.0]
P15_DZ = 0.05
P15_REPS = 10
P15_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
P15_TIMEOUT = 600.0  # s a launch: a rank that hangs fails the run
P15_SEED = 15
P15_CKPT = "build/phase15/checkpoint"


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


def device_ms(fn, kernel, reps=TIMING_REPS, sessions=3):
    """Mean device time in ms of the launches of the kernels whose name
    holds ``kernel`` over reps calls of fn (torch.profiler's CUDA trace,
    after one warm-up call); None when the trace holds no such kernel.
    Unlike cuda_ms, it leaves out the host's time in the wrapper, which a
    grid of ~100 blocks does not hide. From phase 12's first node run on,
    the trace loses some launch records: the profiler's raw device events
    lack them too, and a session that the host's sleep opens and closes
    loses as many (scripts/torch_trace_probe.py). The mean is over the
    launches it holds, and a session that holds none is tried again, up to
    ``sessions`` in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                    for e in events)
        count = sum(e.count for e in events)
        if count and total:
            return total / 1e3 / count
    return None


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


def wrappers():
    """The kernels' wrappers by name: K1 and its dir_groups form K2g, K3
    fused on ray blocks (K3r) and on
    factored blocks (K3f), and its back end alone (K3b); the exact engine's
    traversal (K5) and closest-point walk (K6), the binned closest-point
    loop (K6b) and its candidate cull (K7); MICP-L's Gauss-Newton loop (GN);
    the batch corrector's epilogue (EP)."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bvh, cp_candidates
    from rmcl_tpu_torch.ops.cull_cuda import cull_blocks, cull_factored, cull_rays
    from rmcl_tpu_torch.ops.epilogue_cuda import batch_epilogue
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_factored, intersect_groups
    from rmcl_tpu_torch.ops.solve_cuda import p2l_gauss_newton
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    return {"K1": intersect_bins, "K2g": intersect_groups, "K3r": cull_rays, "K3f": cull_factored, "K3b": cull_blocks,
            "K4": intersect_factored, "K5": traverse_rays, "K6": closest_bvh,
            "K6b": closest_bins, "K7": cp_candidates, "GN": p2l_gauss_newton,
            "EP": batch_epilogue}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in wrappers().items()}


def require_launches(name, counts, kernels, culls=None):
    """Fail unless the path launched each kernel, K3 once a cull (``culls``:
    the path's culls; K3's back end alone never runs on a path)."""
    for k in kernels:
        if counts[k] < 1:
            fail(f"{name}: the path never launched {k}")
    k3 = [k for k in kernels if k.startswith("K3")]
    if culls is not None and sum(counts[k] for k in k3) != culls:
        fail(f"{name}: {culls} culls launched K3 {sum(counts[k] for k in k3)} times")
    if counts["K3b"]:
        fail(f"{name}: the path ran K3's back end on its own")


def bound_of(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cull_bound(args, tests=None):
    """Least time for K3's work on these inputs: the cone-box tests the
    kernel runs (its level-0 boxes, the kept hypers' supers, R tests for
    each mid of a kept super with the mid level, R tests for each bin of a
    kept super or mid) at OPS_PER_TEST each, against reading the cones and
    boxes once and writing the lists. ``tests``: the count, where the
    caller took it in steps."""
    from rmcl_tpu_torch.ops.cull_cuda import cull_tests

    cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs, cb, mid_aabb, M, cm = args
    if tests is None:
        tests = float(cull_tests(cones, fat, bin_aabb, super_aabb, hyper_aabb, S, H, ch, cs,
                                 mid_aabb, M, cm).double().sum())
    Cb = cones.shape[0]
    boxes = (bin_aabb.numel() + super_aabb.numel() + (hyper_aabb.numel() if ch else 0)
             + (mid_aabb.numel() if cm else 0))
    bytes_moved = 4 * (cones.numel() + (fat.numel() if ch else 0) + n_hi.numel() + boxes) \
        + Cb * cb * 8 + Cb * 5
    return bound_of(bytes_moved, tests * OPS_PER_TEST) + (tests,)


def fused_bound(fn, args, back_args, tests):
    """Least time for the fused K3's work on these inputs: the back end's
    tests at OPS_PER_TEST, plus its bounds (OPS_PER_BOUND_RAY per ray of
    each bounds pass, OPS_PER_CONE per cone, OPS_PER_ORIGIN per factored
    origin), against reading the compact inputs and boxes once and writing
    the lists. Factored blocks: a box's OPS_PER_GAP once for each distinct
    origin box among the R cones (one for whole direction groups; for
    expanded sub-blocks of W rays, ray i from origin i % P, P / gcd(W, P)
    of them, one where W >= P), so a test counts the rest of OPS_PER_TEST
    plus that share (the fat cone's tests too, which keeps it a floor)."""
    from rmcl_tpu_torch.ops.cull_cuda import cull_rays

    bins, cb, ch = args[0], back_args[10], back_args[8]
    Cb, R = back_args[0].shape[:2]
    passes = 2 if ch and R > 1 else 1
    if fn is cull_rays:
        ob = args[1]
        rays, origins, in_floats = ob.shape[1], 0, ob.shape[1] * 8
        per_test = OPS_PER_TEST
    else:
        o_c, d_c = args[1], args[2]
        G, P = d_c.shape[1], o_c.shape[1]
        rays = P * G if G % args[6] else G
        origins, in_floats = P, (P + G) * 3 + 1
        W = rays // R
        boxes_of = 1 if G % args[6] == 0 or W >= P else min(R, P // math.gcd(W, P))
        per_test = OPS_PER_TEST - OPS_PER_GAP + OPS_PER_GAP * boxes_of / R
    ops = (tests * per_test + Cb * (passes * rays * OPS_PER_BOUND_RAY + origins * OPS_PER_ORIGIN
                                    + (R + passes - 1) * OPS_PER_CONE))
    boxes = (bins.bin_aabb.numel() + bins.super_aabb.numel()
             + (bins.hyper_aabb.numel() if ch else 0)
             + (bins.mid_aabb.numel() if back_args[13] else 0))
    bytes_moved = 4 * (Cb * in_floats + boxes + 6) + Cb * cb * 8 + Cb * 5
    return bound_of(bytes_moved, ops)


def check_cull(name, fn, plain, args, back_args, e2e=None):
    """The fused K3 (``fn``: cull_rays or cull_factored) against its plain
    version on the same CUDA tensors, and the back end alone
    (``cull_blocks``) on the plain version's cones ``back_args``; fails
    unless every block's lists agree (ties at the budget cut allowed).
    Returns the fused and plain results, and the agreement (``bitwise``:
    all four outputs equal), the timings and both bounds; ``e2e``, the
    path's own cull call, is timed too."""
    from rmcl_tpu_torch.ops.cull_cuda import cull_blocks, cull_disagreements

    launches = fn.launches
    k = fn(*args)
    p = plain(*args)
    back = cull_blocks(*back_args)
    torch.cuda.synchronize()
    if fn.launches != launches + 1:
        fail(f"{name}: K3 did not launch")
    for label, x in (("fused", k), ("back end", back)):
        bad, ties = cull_disagreements(x, p, TNEAR_RTOL)
        if bad:
            fail(f"{name}: K3 ({label}) and its plain version disagree on {bad} blocks")
    bad, ties = cull_disagreements(k, p, TNEAR_RTOL)
    err = (k[2] - p[2]).abs()
    out = dict(ties=ties, bitwise=all(torch.equal(x, y) for x, y in zip(k, p)),
               back_bitwise=all(torch.equal(x, y) for x, y in zip(back, p)),
               max_abs_err=float(err[k[0] >= 0].max()) if bool((k[0] >= 0).any()) else 0.0,
               saturated=int(k[3].sum()), mean_count=float(k[1].float().mean()),
               max_count=int(k[1].max()))
    # kernel times by the profiler's device trace (events around the call
    # where it records none); the calls' own times by events
    out["call_ms"] = cuda_ms(lambda: fn(*args))
    out["back_call_ms"] = cuda_ms(lambda: cull_blocks(*back_args))
    out["ms"] = device_ms(lambda: fn(*args), "cull_kernel") or out["call_ms"]
    out["back_ms"] = device_ms(lambda: cull_blocks(*back_args), "cull_kernel") or out["back_call_ms"]
    out["e2e_ms"] = cuda_ms(e2e, reps=3) if e2e else None
    out["plain_ms"] = cuda_ms(lambda: plain(*args), reps=1)
    out["back_bound_ms"], out["back_bound_by"], out["tests"] = cull_bound(back_args)
    out["bound_ms"], out["bound_by"] = fused_bound(fn, args, back_args, out["tests"])
    return k, p, out


def cull_line(name, r):
    """One log line of check_cull's results."""
    e2e = f"cull {r['e2e_ms']:.4f} ms end to end; " if r["e2e_ms"] is not None else ""
    return (f"{name}: lists agree ({'bitwise' if r['bitwise'] else 'not bitwise'}; "
            f"{r['ties']} tie blocks; back end {'bitwise' if r['back_bitwise'] else 'not bitwise'}); "
            f"{e2e}fused kernel {r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a call (bound "
            f"{r['bound_ms']:.4f} ms {r['bound_by']}, {r['bound_ms'] / r['ms']:.1%}), back end "
            f"{r['back_ms']:.4f} ms on the card, {r['back_call_ms']:.4f} ms a call (bound "
            f"{r['back_bound_ms']:.4f} ms {r['back_bound_by']}, {r['back_bound_ms'] / r['back_ms']:.1%}; "
            f"{r['tests']:.0f} tests), plain {r['plain_ms']:.3f} ms; candidates mean "
            f"{r['mean_count']:.2f}, max {r['max_count']}, {r['saturated']} saturated")


def factored_bound(inputs, t_best, paired):
    """Least time for K4's work on these inputs: per visited candidate (slot
    < count and tnear <= the block's final worst t_best), its pairs,
    (triangle, direction) and (triangle, pose) terms and triangle rows, at
    the float32 instruction rate, against its bytes."""
    tri, o_p, d_p, alive, t_min, t_max, cand, count, tnear = inputs
    B = tri.shape[2]
    G, P = d_p.shape[1], o_p.shape[1]
    P_eff, n_pose = (1, G) if paired else (P, P)
    slot = torch.arange(cand.shape[1], device=cand.device)[None, :]
    worst = t_best.amax(dim=(1, 2))[:, None]
    visits = float(((slot < count[:, None]) & (tnear <= worst)).sum())
    ops = visits * B * (OPS_PER_BW_PAIR * G * P_eff + OPS_PER_BW_DIR * G
                        + OPS_PER_BW_POSE * n_pose + OPS_PER_BW_TRI)
    bytes_moved = visits * (9 * B * 4 + 8) + 4 * (o_p.numel() + d_p.numel() + alive.numel()
                                                  + count.numel()) + t_best.numel() * 8
    return bound_of(bytes_moved, ops) + (visits,)


def check_factored(name, inputs, paired, order=None, time_plain=True):
    """K4 against its plain version on the same CUDA tensors: t_best within
    T_RTOL, and the same winner except at a near-tie, where the plain
    version's t for the kernel's triangle is within T_RTOL of its own."""
    from rmcl_tpu_torch.ops.raycast_cuda import (factored_winner_t, intersect_factored,
                                                 intersect_factored_reference)

    launches = intersect_factored.launches
    kt, kref = intersect_factored(*inputs, paired=paired, order=order)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pt, pref = intersect_factored_reference(*inputs, paired=paired)
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t) * 1e3
    if intersect_factored.launches != launches + 1:
        fail(f"{name}: K4 did not launch")
    o_p, d_p = inputs[1], inputs[2]
    G, P_eff = kt.shape[1], kt.shape[2]
    tol = T_RTOL * pt.double().abs()
    diff = (kt.double() - pt.double()).abs()
    mis = kref != pref
    o_r = (o_p[:, :, None] if paired else o_p[:, None]).expand(-1, G, P_eff, 3)
    d_r = d_p[:, :, None].expand(-1, -1, P_eff, 3)
    tie_t = factored_winner_t(inputs[0], o_r[mis], d_r[mis], inputs[4], kref[mis])
    bad_t = int((diff > tol).sum())
    bad_ref = int(((tie_t.double() - pt[mis].double()).abs() > tol[mis]).sum())
    if bad_t or bad_ref:
        fail(f"{name}: K4 and its plain version disagree ({bad_t} t, {bad_ref} winners)")
    out = dict(max_abs_err=float(diff.max()), ref_mismatch=int(mis.sum()),
               hit_frac=float((kref[inputs[3] > 0] >= 0).float().mean()))
    out["ms"] = cuda_ms(lambda: intersect_factored(*inputs, paired=paired, order=order))
    out["plain_ms"] = (cuda_ms(lambda: intersect_factored_reference(*inputs, paired=paired),
                               reps=1) if time_plain else plain_once_ms)
    out["bound_ms"], out["bound_by"], out["visits"] = factored_bound(inputs, kt, paired)
    return kt, out


def same_cast(name, cast_k, cast_p):
    """The casts through K3's lists and through the plain version's lists
    must give the same hits and t."""
    (kt, kref), (pt, pref) = cast_k, cast_p
    if not torch.equal(kref >= 0, pref >= 0):
        fail(f"{name}: the casts through K3's and the plain lists hit different rays")
    hit = kref >= 0
    if not torch.allclose(kt[hit], pt[hit], rtol=T_RTOL, atol=0.0):
        fail(f"{name}: the casts through K3's and the plain lists give different t")


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
    from concurrent.futures import ThreadPoolExecutor

    from rmcl_tpu_torch import _build

    from rmcl_tpu_torch.bvh import native

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    # one nvcc per source and g++ for the native bin order, all started together
    with ThreadPoolExecutor(len(names) + 1) as pool:
        built = pool.submit(native.load)
        list(pool.map(_build.load_library, names))
        built.result()
    log(f"phase 2 build: {', '.join(names)} (parallel nvcc) and the native host library "
        f"({native.library_path().name}, g++: {bin_order_note()}) in "
        f"{time.perf_counter() - t0:.2f} s")


def bin_order_note():
    """The order every map's bins are built in here: the native kd order
    (``build_bins``' rule where the library builds), or the run fails."""
    from rmcl_tpu_torch.bvh import native

    if not native.available():
        fail(f"the native bin order library is unavailable: {native.unavailable_reason()}")
    return "native kd order"


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
    for name, bins, origin, Rb in (("room", room, (0.5, -0.3, 1.0), 128),
                                   ("room_rb100", room, (0.5, -0.3, 1.0), 100),
                                   ("sphere_1M", sphere_bins, (1.0, -2.0, 0.5), 128)):
        o, d, model = vlp16_rays(origin)
        n = o.shape[0]
        blocks = _pad_rays(o, d, torch.full((n,), model.range.min, device="cuda"),
                           torch.full((n,), model.range.max, device="cuda"), Rb)
        inputs = blocks + _build_candidates(bins, *blocks, *_resolve_budgets(bins, 24, 96)[:2])
        r = compare_kernel(f"phase 3 {name}", bins.tri, inputs)
        log(f"phase 3 kernel vs plain [{name}, {bins.n_bins * bins.bin_size} tris, {n} rays "
            f"in blocks of {Rb}]: "
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
    from rmcl_tpu_torch.ops.cull_cuda import (_cull_args, _subblock_bounds, cull_rays,
                                              cull_rays_reference)
    from rmcl_tpu_torch.ops.raycast_binned import (_flat_rays, _kernel_inputs, _pad_rays,
                                                   _resolve_budgets, cast_rays_binned)
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    t0 = time.perf_counter()
    mesh = make_building_scene(subdiv=BUILDING_SUBDIV)
    bmap = MeshMap.from_mesh(mesh)
    torch.cuda.synchronize()
    log(f"phase 4 map: building {mesh.n_faces} faces, {bmap.bins.n_bins} bins of "
        f"{bmap.bins.bin_size} ({bin_order_note()}), built in {time.perf_counter() - t0:.2f} s")

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
    reset_counts()
    for _ in range(N_CORRECTIONS):
        t = time.perf_counter()
        tom, stats = correct_once(bmap.bins, [sensor], tom, tbo, progress, config)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        progress = stats.convergence_progress
    counts = read_counts()
    launches = counts["K1"]
    err_t = float(torch.linalg.vector_norm(tom.trans - true_pose.trans))
    dq = float(abs(torch.dot(tom.rot, true_pose.rot)))
    log(f"phase 4 main path: {N_CORRECTIONS} corrections x {model.n_rays} rays, "
        f"median {statistics.median(times):.3f} ms/correction (min {min(times):.3f}), "
        f"final |dt| {err_t:.2e} m, |<q, q_true>| {dq:.8f}, "
        f"matches {float(stats.valid_matches):.0f}/{float(stats.valid_measurements):.0f}, "
        f"progress {float(stats.convergence_progress):.4f}, launches K1 {counts['K1']}, "
        f"K3 {counts['K3r']}, K4 {counts['K4']}, GN {counts['GN']}")
    if not err_t < 0.01:
        fail(f"main path did not converge: translation error {err_t} m")
    require_launches("phase 4 main path", counts, ("K1", "K3r", "GN"), culls=N_CORRECTIONS)
    if counts["GN"] != N_CORRECTIONS:
        fail(f"phase 4: {N_CORRECTIONS} corrections launched GN {counts['GN']} times")
    if not bool(torch.isfinite(tom.rot).all() & torch.isfinite(tom.trans).all()):
        fail("non-finite pose")

    # the kernel on the main path's own inputs: the last correction's cast
    tsm = tom @ tbo
    o_s, d_s = model.rays("cuda")
    o, d, t_min_r, t_max_r, _ = _flat_rays(tsm.apply(o_s), tsm.rotate(d_s),
                                           model.range.min, model.range.max)
    cull_in = (bmap.bins, o, d, t_min_r, t_max_r, 128, config.c_super, config.c_bin, 4)
    inputs, sat = _kernel_inputs(*cull_in)
    cull_ms = cuda_ms(lambda: _kernel_inputs(*cull_in))
    r = compare_kernel("phase 4 main path", bmap.bins.tri, inputs)
    r.update(launches=launches, launches_per_correction=launches / N_CORRECTIONS,
             cull_ms=cull_ms, correction_ms=statistics.median(times), saturated=int(sat.sum()))
    log(f"phase 4 kernel on the main path's inputs: max_abs_err {r['max_abs_err']:.3g}, "
        f"ref mismatches {r['ref_mismatch']}, kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {r['visits']:.0f} bin visits), "
        f"cull {cull_ms:.3f} ms, {r['launches_per_correction']:.1f} launches/correction, "
        f"{r['saturated']} of {inputs[0].shape[0]} blocks saturated")

    # K3 on the same cast's inputs, and the cast through both lists
    blocks = _pad_rays(o, d, t_min_r, t_max_r, 128)
    cs, cb, _ = _resolve_budgets(bmap.bins, config.c_super, config.c_bin)
    back_args = _cull_args(bmap.bins, lambda r: _subblock_bounds(*blocks, r), 4, cs, cb, 0)
    k, p, r3 = check_cull("phase 4 K3", cull_rays, cull_rays_reference,
                          (bmap.bins, *blocks, 4, cs, cb, 0), back_args,
                          e2e=lambda: _kernel_inputs(*cull_in))
    same_cast("phase 4", intersect_bins(bmap.bins.tri, *blocks, *k[:3]),
              intersect_bins(bmap.bins.tri, *blocks, *p[:3]))
    r3.update(launches=counts["K3r"])
    log(cull_line("phase 4 K3 on the main path's inputs", r3) + "; the cast through both "
        "lists agrees")
    r["k3"] = r3

    # what the default budgets cost this cast: the same rays with no budget
    # (every super, every bin) truncate nowhere
    bins = bmap.bins
    free = (bins.n_super, bins.n_super * bins.bins_per_super)
    _, free_sat = _kernel_inputs(bins, o, d, t_min_r, t_max_r, 128, *free, 4)
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
    r.update(bmap=bmap, model=model, sensor=sensor, true_pose=true_pose, config=config)
    return r


def gn_bound(n_pairs, iterations):
    """Least time for the Gauss-Newton kernel's work: each pair lifted once,
    K iterations and the statistics' two passes (float instructions), or
    the pairs read once and the output written (bytes)."""
    ops = n_pairs * (OPS_PER_GN_LIFT + iterations * OPS_PER_GN_ITER + OPS_PER_GN_STATS)
    return bound_of(n_pairs * GN_BYTES_PER_PAIR + GN_OUT_BYTES, ops)


def gn_gaps(got, want):
    """(pose m, pose rad, matches, largest relative gap of the covariance
    trace and the progress) between two outputs of the Gauss-Newton loop."""
    got, want = got.double().cpu(), want.double().cpu()
    a, b = got[:4], want[:4]
    vec = a[0] * b[1:] - b[0] * a[1:] - torch.linalg.cross(a[1:], b[1:])
    rel = max(abs(float(got[k] - want[k])) / max(abs(float(want[k])), 1e-30) for k in (10, 11))
    return (float(torch.linalg.vector_norm(got[4:7] - want[4:7])),
            2.0 * math.asin(min(1.0, float(torch.linalg.vector_norm(vec)))),
            abs(float(got[9] - want[9])), rel)


def phase_gauss_newton(main_r):
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.pipeline import STATISTICS, _correct_torch, find_correspondences
    from rmcl_tpu_torch.ops import solve_cuda as sc

    def plain(sensors, corrs, tom, tbo, progress, config):
        t, stats = _correct_torch(sensors, corrs, tom, tbo, progress, config, None, "rays")
        return torch.cat([t.rot, t.trans] + [getattr(stats, name).reshape(1)
                                             for name in STATISTICS])

    bins, sensor, config = main_r["bmap"].bins, main_r["sensor"], main_r["config"]
    tom, tbo = Transform.from_pose_tuple(EXACT_START), Transform.identity()
    corrs = find_correspondences(bins, [sensor], tom @ tbo, c_super=config.c_super,
                                 c_bin=config.c_bin)
    progress = torch.tensor(0.3, device="cuda")
    regs, local, static_smem = sc.kernel_registers()["GN"]
    if local > GN_STACK_BYTES:
        fail(f"phase 16: the Gauss-Newton kernel spills ({local} local bytes a thread)")
    rows = {}
    for name, copies in (("node", 1), ("3x", 3)):
        inputs = ([sensor] * copies, list(corrs) * copies, tom, tbo, progress, config)
        n = copies * int(sensor.points.shape[0])
        chunk = -(-n // sc._CLUSTER)
        launches = sc.p2l_gauss_newton.launches
        got, again = sc.p2l_gauss_newton(*inputs), sc.p2l_gauss_newton(*inputs)
        want = plain(*inputs)
        torch.cuda.synchronize()
        if sc.p2l_gauss_newton.launches - launches != 2:
            fail(f"phase 16 {name}: two calls launched the kernel "
                 f"{sc.p2l_gauss_newton.launches - launches} times")
        if not torch.equal(got, again):
            fail(f"phase 16 {name}: two launches on the same inputs differ")
        gap_m, gap_rad, gap_match, gap_rel = gn_gaps(got, want)
        if not (gap_m <= GN_POSE_TOL_M and gap_rad <= GN_POSE_TOL_RAD and gap_match <= 1
                and gap_rel <= GN_REL_TOL and torch.equal(got[7:9], want[7:9])):
            fail(f"phase 16 {name}: kernel against plain version: {gap_m:.3g} m, "
                 f"{gap_rad:.3g} rad, {gap_match} matches, {gap_rel:.3g} relative")
        ms = device_ms(lambda: sc.p2l_gauss_newton(*inputs), "p2l_gauss_newton_kernel")
        if ms is None:
            fail(f"phase 16 {name}: the trace holds no Gauss-Newton launch")
        t0 = time.perf_counter()
        for _ in range(100):
            sc.p2l_gauss_newton(*inputs)
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        bound_ms, bound_by = gn_bound(n, config.optimization_iterations)
        rows[name] = dict(
            pairs=n, ms=ms, timed_by="device trace",
            call_ms=cuda_ms(lambda: sc.p2l_gauss_newton(*inputs)), host_us=host_us,
            plain_ms=cuda_ms(lambda: plain(*inputs)),
            bound_ms=bound_ms, bound_by=bound_by, launches=1, max_abs_err=gap_m,
            gaps=dict(m=gap_m, rad=gap_rad, matches=gap_match, rel=gap_rel),
            chunk=chunk, static_shared_bytes=static_smem, registers=regs,
            matches=float(got[9]), valid=float(got[8]))
        r = rows[name]
        log(f"phase 16 Gauss-Newton kernel, {name} ({n} pairs, {chunk} a CTA, "
            f"{static_smem} B shared, {regs} registers): kernel {ms:.4f} ms by the trace, call {r['call_ms']:.4f} ms "
            f"by events, wrapper {host_us:.1f} us host, plain {r['plain_ms']:.3f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}), share {bound_ms / ms:.2%}; gaps {gap_m:.3g} m, "
            f"{gap_rad:.3g} rad, {gap_match:.0f} matches, {gap_rel:.3g} relative; two "
            f"launches bitwise")
    return dict(rows["node"], phase16_3x=rows["3x"])


def phase_reference_cast(sphere_bins):
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform
    from rmcl_tpu_torch.ops.cull_cuda import (_cull_args, _subblock_bounds, cull_rays,
                                              cull_rays_reference)
    from rmcl_tpu_torch.ops.raycast_binned import (_flat_rays, _kernel_inputs, _pad_rays,
                                                   _resolve_budgets)
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    model = SphericalModel.vlp16()
    trans = np.random.default_rng(0).uniform(-5, 5, size=(N_POSES, 3)).astype(np.float32)
    tsm = Transform(rot=Quaternion.identity((N_POSES,), "cuda"),
                    trans=torch.from_numpy(trans).cuda())
    kw = dict(block_size=CAST_BLOCK_SIZE)
    hits = simulate(sphere_bins, model, tsm, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    hits = simulate(sphere_bins, model, tsm, **kw)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    require_launches("phase 5 cast", counts, ("K1", "K3r"), culls=1)
    n = hits.hit.numel()
    hit_frac = float(hits.hit.float().mean())

    # the same cast split into its cull and its kernel
    tsm_b = tsm.expand_dims(-1)
    o_s, d_s = model.rays("cuda")
    o, d, t_min_r, t_max_r, _ = _flat_rays(tsm_b.apply(o_s), tsm_b.rotate(d_s),
                                           model.range.min, model.range.max)

    # the default 128-ray blocks, measured and not required to hit
    inputs, sat = _kernel_inputs(sphere_bins, o, d, t_min_r, t_max_r, DEFAULT_BLOCK_SIZE,
                                 24, 96, 4)
    _, kref = intersect_bins(sphere_bins.tri, *inputs)
    log(f"phase 5 default {DEFAULT_BLOCK_SIZE}-ray blocks: hits "
        f"{float((kref.reshape(-1)[:n] >= 0).float().mean()):.6f}, {int(sat.sum())} of "
        f"{inputs[0].shape[0]} blocks saturated, {int(inputs[5].sum())} candidates")
    del inputs, sat, kref

    args = (sphere_bins, o, d, t_min_r, t_max_r, CAST_BLOCK_SIZE, 24, 96, 4)
    inputs, sat = _kernel_inputs(*args)
    cull_ms = cuda_ms(lambda: _kernel_inputs(*args), reps=3)
    # K3 on the cast's own blocks, and the cast through both lists
    blocks = inputs[:4]
    cs, cb, _ = _resolve_budgets(sphere_bins, 24, 96)
    back_args = _cull_args(sphere_bins, lambda r: _subblock_bounds(*blocks, r), 4, cs, cb, 0)
    k, p, r3 = check_cull("phase 5 K3", cull_rays, cull_rays_reference,
                          (sphere_bins, *blocks, 4, cs, cb, 0), back_args)
    r3.update(launches=counts["K3r"], e2e_ms=cull_ms)
    same_cast("phase 5", intersect_bins(sphere_bins.tri, *blocks, *k[:3]),
              intersect_bins(sphere_bins.tri, *blocks, *p[:3]))
    log(cull_line("phase 5 K3 on the cast's inputs", r3) + "; the cast through both lists "
        "agrees")
    del k, p, back_args
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
        f"{saturated} of {inputs[0].shape[0]} blocks of {CAST_BLOCK_SIZE} rays saturated; "
        f"launches in the cast K1 {counts['K1']}, K3 {counts['K3r']}")
    if not hit_frac >= 0.999:
        fail(f"phase 5: only {hit_frac:.6f} of rays hit the sphere")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                cull_ms=cull_ms, simulate_ms=sim_ms, hit_frac=hit_frac, k3=r3)


def phase_tracking(main_r):
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.tracking import TrackedCorrector
    from rmcl_tpu_torch.ops.cull_cuda import (_cull_args, _factored_bounds, cull_factored,
                                              cull_factored_reference)
    from rmcl_tpu_torch.ops.raycast_binned import (_factored_block_candidates,
                                                   _pad_factored_blocks, _resolve_budgets)

    bins, model, sensor = main_r["bmap"].bins, main_r["model"], main_r["sensor"]
    true_pose, config = main_r["true_pose"], main_r["config"]
    tbo = Transform.identity()
    kw = dict(origin_margin=0.05, dir_margin=0.01, group=128, sub_blocks=4, payload="plane")
    tc = TrackedCorrector(bins, model, config, **kw)
    start = Transform.from_pose_tuple([9.0, 3.0, 1.7, 0.0, 0.0, 0.35])
    # warm-up run (not counted): first-call allocations
    state = tc.init(bins, start, tbo, sensor.tsb)
    tc.step(bins, [sensor], state, tbo)
    torch.cuda.synchronize()

    reset_counts()
    state = tc.init(bins, start, tbo, sensor.tsb)
    times = []
    for _ in range(TRACK_STEPS):
        last_tom = state.tom
        t = time.perf_counter()
        state, stats = tc.step(bins, [sensor], state, tbo)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = read_counts()
    err_t = float(torch.linalg.vector_norm(state.tom.trans - true_pose.trans))
    log(f"phase 6 tracking: {TRACK_STEPS} steps x {model.n_rays} rays, median "
        f"{statistics.median(times):.3f} ms/step (min {min(times):.3f}), final |dt| "
        f"{err_t:.2e} m, re-culls {state.n_reculls} (init included), launches K3 "
        f"{counts['K3f']}, K4 {counts['K4']}, K1 {counts['K1']}, GN {counts['GN']}")
    if not err_t < 0.01:
        fail(f"phase 6: tracking did not converge: translation error {err_t} m")
    require_launches("phase 6 tracking", counts, ("K3f", "K4", "GN"), culls=state.n_reculls)
    if counts["GN"] != TRACK_STEPS:
        fail(f"phase 6: {TRACK_STEPS} tracked corrections launched GN {counts['GN']} times")

    # K3 and K4 on the last step's inputs: its blocks, a cull there, and
    # the lists the step cast through
    lay = tc._layouts[0]
    o_blk, d_blk = lay.blocks((last_tom @ tbo) @ sensor.tsb)
    o_p, d_p, alive, *_ = _pad_factored_blocks(o_blk, d_blk, None, 512)
    cs, cb, _ = _resolve_budgets(bins, config.c_super, config.c_bin)
    raw = _factored_bounds(o_p, d_p, alive, lay.t_min, lay.t_max, 4, 0.05, 0.01)
    tsm_last = (last_tom @ tbo) @ sensor.tsb
    k, p, r3 = check_cull("phase 6 K3", cull_factored, cull_factored_reference,
                          (bins, o_p, d_p, alive, lay.t_min, lay.t_max, 4, cs, cb, 0, 0.05, 0.01),
                          _cull_args(bins, raw, 4, cs, cb, 0),
                          e2e=lambda: tc._cull(bins, lay, tsm_last))
    r3.update(launches=counts["K3f"])
    inputs = (bins.tri, o_p, d_p, alive, lay.t_min, lay.t_max) + tuple(
        x.contiguous() for x in state.candidates[0])
    _, r4 = check_factored("phase 6 K4", inputs, paired=False)
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored
    same_cast("phase 6", intersect_factored(*inputs[:6], *k[:3]),
              intersect_factored(*inputs[:6], *p[:3]))
    log(cull_line("phase 6 K3 on the last step's inputs", r3))
    log(f"phase 6 K4: max_abs_err {r4['max_abs_err']:.3g}, ref mismatches "
        f"{r4['ref_mismatch']}, kernel {r4['ms']:.4f} ms, plain {r4['plain_ms']:.3f} ms, bound "
        f"{r4['bound_ms']:.4f} ms ({r4['bound_by']}; {r4['visits']:.0f} bin visits); the cast "
        f"through both lists agrees")

    # K4's paired layout on the same blocks: each direction with its own
    # origin, the block's pose moved 5 cm along the neighbouring ray, culled
    # fresh (the cull bounds the block's origin set)
    o_pair = (o_p + 0.05 * torch.roll(d_p, 1, dims=1)).contiguous()
    pair_c = _factored_block_candidates(bins, o_pair, d_p, alive, lay.t_min, lay.t_max, cs, cb,
                                        0, 4, 0.0, 0.0)
    pair_in = (bins.tri, o_pair, d_p, alive, lay.t_min, lay.t_max) + tuple(
        x.contiguous() for x in pair_c[:3])
    _, r4p = check_factored("phase 6 K4 paired", pair_in, paired=True)
    log(f"phase 6 K4 paired layout ({o_pair.shape[0]} blocks of {o_pair.shape[1]} rays): "
        f"max_abs_err {r4p['max_abs_err']:.3g}, ref mismatches {r4p['ref_mismatch']}, hits "
        f"{r4p['hit_frac']:.6f}; kernel {r4p['ms']:.4f} ms, plain {r4p['plain_ms']:.3f} ms, "
        f"bound {r4p['bound_ms']:.4f} ms ({r4p['bound_by']}; {r4p['visits']:.0f} bin visits)")
    return dict(step_ms=statistics.median(times), err=err_t, reculls=state.n_reculls,
                counts=counts, k3=r3, k4=r4)


def quat_gaps(a, b):
    """Angles (rad) between unit quaternions a, b (N, 4): twice the arcsine
    of the vector part of conj(a) b."""
    a, b = a.double(), b.double()
    vec = a[:, :1] * b[:, 1:] - b[:, :1] * a[:, 1:] - torch.linalg.cross(a[:, 1:], b[:, 1:])
    return 2.0 * torch.asin(torch.clamp(torch.linalg.vector_norm(vec, dim=-1), max=1.0))


def epilogue_bound(won, slots):
    """Least time for the epilogue kernel's work (OPS_PER_EPI_PAIR,
    EPI_BYTES_PER_PAIR): every pair's inputs and the distinct winner rows
    read once, the output written, against the hit pairs' instructions."""
    n, d = slots.shape
    flat = slots.reshape(-1).long()
    hit = won.hit.reshape(-1)[flat]
    rows = int(torch.unique(won.ref.reshape(-1)[flat][hit]).numel())
    bytes_moved = n * d * EPI_BYTES_PER_PAIR + rows * 16 + (n + d) * 12 + n * 32
    return (*bound_of(bytes_moved, int(hit.sum()) * OPS_PER_EPI_PAIR), bytes_moved, rows)


def check_epilogue(name, bc, data_points, data_mask, trans, lists):
    """The batch corrector's epilogue kernel on one correction's winners
    (the cast through ``lists`` at ``trans``): two launches bitwise, against
    its plain version (``batch_epilogue_reference``) on the same CUDA
    tensors, timed by the trace beside its bound, the plain version and the
    corrector's whole correction."""
    from rmcl_tpu_torch.ops import epilogue_cuda as ec
    from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned_factored

    regs, local, smem = ec.kernel_registers()["epilogue"]
    if local:
        fail(f"{name}: the epilogue kernel spills ({local} local bytes a thread)")
    o_blk, d_blk = bc.sweep.factored_rays(trans, bc.dirs)

    def winner_cast():
        return cast_rays_binned_factored(bc.bins, o_blk, d_blk, candidates=lists,
                                         sort_blocks=True, payload="winner", **bc.cull_kw)

    won = winner_cast()
    planes, slots = bc._epilogue_tables()
    args = (won.t, won.ref, planes, trans, bc.dirs, data_points, data_mask, slots, bc.max_dist,
            bc.cull_kw["t_max"])
    launches = ec.batch_epilogue.launches
    (got, n_got), (again, n_again) = ec.batch_epilogue(*args), ec.batch_epilogue(*args)
    want, n_want = ec.batch_epilogue_reference(*args)
    torch.cuda.synchronize()
    if ec.batch_epilogue.launches - launches != 2:
        fail(f"{name}: two calls launched the kernel {ec.batch_epilogue.launches - launches} times")
    if not (torch.equal(got.rot, again.rot) and torch.equal(got.trans, again.trans)
            and torch.equal(n_got, n_again)):
        fail(f"{name}: two launches on the same inputs differ")
    gap_m = float(torch.linalg.vector_norm(got.apply(trans) - want.apply(trans), dim=-1).max())
    gap_rad = float(quat_gaps(got.rot, want.rot).max())
    gap_match = float((n_got - n_want).abs().max())
    if not (gap_m <= EPI_POSE_TOL_M and gap_rad <= EPI_POSE_TOL_RAD and gap_match == 0):
        fail(f"{name}: kernel against its plain version: {gap_m:.3g} m, {gap_rad:.3g} rad, "
             f"{gap_match} matches")
    ms = device_ms(lambda: ec.batch_epilogue(*args), "batch_epilogue_kernel")
    if ms is None:
        fail(f"{name}: the trace holds no epilogue launch")
    bound_ms, bound_by, bytes_moved, rows = epilogue_bound(won, slots)
    r = dict(ms=ms, timed_by="device trace", call_ms=cuda_ms(lambda: ec.batch_epilogue(*args)),
             plain_ms=cuda_ms(lambda: ec.batch_epilogue_reference(*args), reps=5),
             winner_cast_ms=cuda_ms(winner_cast, reps=5),
             correction_ms=cuda_ms(lambda: bc.correct(data_points, data_mask, trans, lists),
                                   reps=5),
             bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, rows=rows,
             max_abs_err=gap_m, gaps=dict(m=gap_m, rad=gap_rad, matches=gap_match),
             registers=regs, static_shared_bytes=smem, pairs=int(n_got.sum()))
    log(f"{name} ({trans.shape[0]} poses x {data_points.shape[1]} rays, {r['pairs']} pairs, "
        f"{rows} winner rows, {regs} registers, {smem} B shared): kernel {ms:.4f} ms by the "
        f"trace, call {r['call_ms']:.4f} ms by events; bound {bound_ms:.4f} ms ({bound_by}, "
        f"{bytes_moved / 1e9:.3f} GB), share {bound_ms / ms:.2%}; the plain version "
        f"{r['plain_ms']:.3f} ms; the winner cast {r['winner_cast_ms']:.3f} ms; the corrector's "
        f"correction {r['correction_ms']:.3f} ms; gaps {gap_m:.3g} m, {gap_rad:.3g} rad, "
        f"{gap_match:.0f} matches; two launches bitwise")
    return r


def phase_sweep():
    from rmcl_tpu_torch.bench import JITTER, SweepBench, settings_from_env
    from rmcl_tpu_torch.ops.cull_cuda import (_cull_args, _factored_bounds, cull_factored,
                                              cull_factored_reference)
    from rmcl_tpu_torch.ops.raycast_binned import (_factored_block_candidates, _hyper_budget,
                                                   _pad_factored_blocks, _resolve_budgets)
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_factored

    cfg, run = settings_from_env({})  # the JAX bench's defaults at 1M faces
    t0 = time.perf_counter()
    bench = SweepBench(**cfg, device="cuda")
    torch.cuda.synchronize()
    bins = bench.bins
    log(f"phase 7 map: sphere {bins.n_bins * bins.bin_size} tris in {bins.n_bins} bins of "
        f"{bins.bin_size} ({bin_order_note()}), {bins.n_super} supers, {bins.n_hyper} hypers, built in "
        f"{time.perf_counter() - t0:.2f} s; {bench.trans_true.shape[0]} poses, "
        f"{bench.sweep.n_rays} sweep rays in blocks of {bench.sweep.pt} poses x "
        f"{bench.sweep.dir_groups} directions; {json.dumps(cfg)}")
    trans = bench.trans_true
    est0 = trans + torch.tensor([0.0, 0.0, 0.2], device="cuda")
    k = run["steps"]
    rng = bench.rng
    jit_sets = [torch.from_numpy(rng.uniform(-JITTER, JITTER, size=(k,) + tuple(trans.shape))
                                 .astype(np.float32)).cuda() for _ in range(SWEEP_CHAINS + 1)]
    # warm-up (not counted): first-call allocations
    data_points, data_mask = bench.make_dataset(trans)
    bench.chain(data_points, data_mask, est0, jit_sets[0][:2])
    torch.cuda.synchronize()

    # the main path: the dataset cast, then three timed 16-step chains
    reset_counts()
    t = time.perf_counter()
    data_points, data_mask = bench.make_dataset(trans)
    torch.cuda.synchronize()
    dataset_ms = (time.perf_counter() - t) * 1e3
    chain_ms = []
    for js in jit_sets[1:]:
        t = time.perf_counter()
        bench.chain(data_points, data_mask, est0, js)
        torch.cuda.synchronize()
        chain_ms.append((time.perf_counter() - t) * 1e3 / k)
    counts = read_counts()
    require_launches("phase 7 sweep", counts, ("K3f", "K4", "EP"), culls=1 + SWEEP_CHAINS)
    if counts["EP"] != SWEEP_CHAINS * k:
        fail(f"phase 7 sweep: {SWEEP_CHAINS * k} corrections launched the epilogue kernel "
             f"{counts['EP']} times")
    hit_frac = float(data_mask.float().mean())
    ms = statistics.median(chain_ms)
    rays_per_s = bench.n_rays / (ms * 1e-3)
    log(f"phase 7 sweep: dataset cast {dataset_ms:.2f} ms, hits {hit_frac:.6f}; "
        f"{SWEEP_CHAINS} chains of {k} corrections (one reuse cull each, margin "
        f"{bench.margin} m): median {ms:.3f} ms/correction ({', '.join(f'{x:.3f}' for x in chain_ms)}), "
        f"{rays_per_s:.4g} corr-rays/s; launches K3 {counts['K3f']}, K4 {counts['K4']}, "
        f"K1 {counts['K1']}")
    if not hit_frac >= 0.999:
        fail(f"phase 7: only {hit_frac:.6f} of the dataset's rays hit the sphere")

    # saturation of the dataset cast's fresh cull and of a reuse cull
    cs, cb, _ = _resolve_budgets(bins, cfg["c_super"], cfg["c_bin"], cfg["c_mid"])
    R = cfg["sub_blocks"]

    def padded(tr):
        return _pad_factored_blocks(*bench.sweep.factored_rays(tr, bench.dirs), None,
                                    cfg["block_chunk"])

    o_p, d_p, alive, n_blk, _, _ = padded(trans)
    t_min, t_max = 0.0, float(3.0e38)
    fresh = _factored_block_candidates(bins, o_p, d_p, alive, t_min, t_max, cs, cb,
                                       cfg["c_hyper"], R, 0.0)
    o_p, d_p, alive, n_blk, _, _ = padded(est0)

    # K3 on the reuse cull's inputs at the chain's base estimate
    ch = _hyper_budget(bins, cfg["c_hyper"])
    back_args = _cull_args(bins, _factored_bounds(o_p, d_p, alive, t_min, t_max, R, bench.margin,
                                                  0.0), R, cs, cb, ch)
    kl, pl, r3 = check_cull("phase 7 K3", cull_factored, cull_factored_reference,
                            (bins, o_p, d_p, alive, t_min, t_max, R, cs, cb, ch, bench.margin,
                             0.0), back_args, e2e=lambda: bench.candidates(est0))
    del back_args
    reuse_ms = r3["e2e_ms"]
    r3.update(launches=counts["K3f"])
    log(cull_line(f"phase 7 K3 (reuse cull, {n_blk} blocks, {R} cones each)", r3)
        + f"; saturated blocks: {int(fresh[3].sum())} (dataset cast) of {o_p.shape[0]}")

    # K4 on a correction's cast: the reuse lists at the chain's base estimate
    order = torch.argsort(kl[1], descending=True, stable=True).to(torch.int32)
    inputs = (bins.tri, o_p, d_p, alive, t_min, t_max) + tuple(x.contiguous() for x in kl[:3])
    _, r4 = check_factored("phase 7 K4", inputs, paired=False, order=order, time_plain=False)
    same_cast("phase 7", intersect_factored(*inputs[:6], *kl[:3]),
              intersect_factored(*inputs[:6], *pl[:3]))
    r4.update(launches=counts["K4"])
    log(f"phase 7 K4 ({o_p.shape[0]} blocks of {o_p.shape[1]} x {d_p.shape[1]} rays): "
        f"max_abs_err {r4['max_abs_err']:.3g}, ref mismatches {r4['ref_mismatch']}, hits "
        f"{r4['hit_frac']:.6f}; kernel {r4['ms']:.3f} ms, plain {r4['plain_ms']:.1f} ms (one "
        f"run), bound {r4['bound_ms']:.3f} ms ({r4['bound_by']}; {r4['visits']:.0f} bin "
        f"visits); the cast through both lists agrees")

    # the epilogue kernel on the same correction
    r_ep = check_epilogue("phase 7 epilogue", bench.corrector, data_points, data_mask, est0,
                          kl[:3])
    r_ep.update(launches=counts["EP"])

    # where one correction's time goes (CUDA events, reused lists)
    cands = bench.candidates(est0)
    cast_ms = cuda_ms(lambda: bench.corrector.cast(est0, cands), reps=3)
    corr_ms = cuda_ms(lambda: bench.correction(data_points, data_mask, est0, cands), reps=3)
    log(f"phase 7 one correction (reused lists): {corr_ms:.3f} ms, the epilogue kernel's; "
        f"the plane cast {cast_ms:.3f} ms (K4 {r4['ms']:.3f} ms + payload, unpermute "
        f"{cast_ms - r4['ms']:.3f} ms); the reuse cull adds {reuse_ms / k:.3f} ms a correction "
        f"over a {k}-step chain")

    # ten iterated corrections from the reference's +0.2 m z offset
    t = time.perf_counter()
    est = bench.iterate(data_points, data_mask, est0, SWEEP_ITERS)
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t
    err = torch.linalg.vector_norm(est - trans, dim=1)
    med = float(err.median())
    log(f"phase 7 iterated correction: median |dt| {med:.6f} m after {SWEEP_ITERS} (from "
        f"0.2 m; max {float(err.max()):.6f} m), {iter_s:.2f} s")
    if not (med < SWEEP_ITER_ERR_MAX and bool(torch.isfinite(est).all())):
        fail(f"phase 7: the iterated correction ended at a median {med} m")
    return dict(k3=r3, k4=r4, ep=r_ep, ms=ms, rays_per_s=rays_per_s, hit_frac=hit_frac,
                iter_err=med, counts=counts, bench=bench, est0=est0)


def traverse_bound(visits, n_rays, slots_read):
    """Least time for K5's work on these inputs: OPS_PER_TRAVERSE_RAY per
    ray, OPS_PER_SLAB_VISIT per internal visit and OPS_PER_MT_VISIT per leaf
    visit, against reading the rays and the slots the walk needs (64 bytes
    each) once and writing t and the slot."""
    internal, leaf = (float(x) for x in visits.double().sum(0))
    ops = n_rays * OPS_PER_TRAVERSE_RAY + internal * OPS_PER_SLAB_VISIT + leaf * OPS_PER_MT_VISIT
    return bound_of(n_rays * (32 + 8) + 64 * slots_read, ops) + (internal + leaf,)


def closest_bvh_bound(visits, n_queries, slots_read, serial_visits=None):
    """Least time for K6's work: OPS_PER_BOX_VISIT per internal visit and
    OPS_PER_CP_VISIT per leaf visit, against reading the queries and the
    slots the walk needs once and writing d2, the point and the slot. With
    ``serial_visits`` (the serial walk's, where the kernel ran the split
    walk) each query counts the cheaper of the two walks, so the split
    walk's extra visits are never counted as work."""
    ops = visits.double() @ torch.tensor([OPS_PER_BOX_VISIT, OPS_PER_CP_VISIT],
                                         dtype=torch.float64, device=visits.device)
    if serial_visits is not None:
        serial = serial_visits.double() @ torch.tensor(
            [OPS_PER_BOX_VISIT, OPS_PER_CP_VISIT], dtype=torch.float64, device=visits.device)
        visits = torch.where((serial < ops)[:, None], serial_visits, visits)
        ops = torch.minimum(ops, serial)
    n_visits = float(visits.double().sum())
    return bound_of(n_queries * (16 + 20) + 64 * slots_read, float(ops.sum())) + (n_visits,)


def closest_bins_bound(inputs, best_key, B):
    """Least time for K6b's work: per visited candidate (slot < count and
    dlb <= the block's final worst key), its Rq x B pairs at
    OPS_PER_CP_PAIR and its B triangles at OPS_PER_CP_TRI, against its
    triangles' bytes, the queries and the keys."""
    qb, d2b, cand, count, dlb = inputs
    jmask = B - 1
    worst = ((best_key.amax(dim=1) | jmask).view(torch.float32))[:, None]
    slot = torch.arange(cand.shape[1], device=cand.device)[None, :]
    visits = float(((slot < count[:, None]) & (dlb <= worst)).sum())
    Rq = qb.shape[1]
    ops = visits * B * (Rq * OPS_PER_CP_PAIR + OPS_PER_CP_TRI)
    bytes_moved = visits * (9 * B * 4 + 8) + qb.shape[0] * Rq * (16 + 8) + count.numel() * 4
    return bound_of(bytes_moved, ops) + (visits,)


def check_traverse(name, bvh, rays, device_timed=False):
    """K5 against its plain version on the same CUDA tensors (t_best, slot
    and each ray's visits bitwise), with timings and the bound; the bound
    counts the slots the plain version read. ``device_timed``: the kernel's
    time from the profiler's device trace (``call_ms`` keeps the call by
    events, ``timed_by`` says which one ``ms`` is), for a launch shorter
    than the host's call."""
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays, traverse_rays_reference

    launches = traverse_rays.launches
    k = traverse_rays(bvh.nodes, bvh.root_link, *rays, visits=True)
    seen = torch.zeros(bvh.n_slots, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = traverse_rays_reference(bvh.nodes, bvh.root_link, *rays, visits=True, seen=seen)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if traverse_rays.launches != launches + 1:
        fail(f"{name}: K5 did not launch")
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        fail(f"{name}: K5 and its plain version disagree ({int((k[1] != p[1]).sum())} slots, "
             f"{int((k[0] != p[0]).sum())} t, {int((k[2] != p[2]).any(1).sum())} visits)")
    out = dict(max_abs_err=float((k[0] - p[0]).abs().max()), bitwise=True,
               hit_frac=float((k[1] >= 0).float().mean()), plain_ms=plain_ms,
               slots_read=int(seen.sum()), timed_by="events")
    launch = lambda: traverse_rays(bvh.nodes, bvh.root_link, *rays)
    out["ms"] = cuda_ms(launch, reps=3)
    if device_timed:
        out["call_ms"] = out["ms"]
        trace_ms = device_ms(launch, "traverse_bvh")
        if trace_ms is not None:
            out["ms"], out["timed_by"] = trace_ms, "device trace"
    out["bound_ms"], out["bound_by"], out["visits"] = traverse_bound(k[2], rays[0].shape[0],
                                                                     out["slots_read"])
    return out


def check_closest_bvh(name, bvh, q, max_d2):
    """K6 at the wrapper's split P against its plain version at the same P
    (best d2, point, slot and visits bitwise), with timings and the bound;
    where P > 1 also against the serial walk (P = 1), whose visits the
    bound may count instead and whose winners the split walk's equal but
    at float near-ties."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh, closest_bvh_reference, walk_split

    P = walk_split(q.shape[0], q.device)
    launches = closest_bvh.launches
    k = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True)
    seen = torch.zeros(bvh.n_slots, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = closest_bvh_reference(bvh.nodes, bvh.root_link, q, max_d2, visits=True, seen=seen,
                              split=P)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if closest_bvh.launches != launches + 1:
        fail(f"{name}: K6 did not launch")
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        fail(f"{name}: K6 and its plain version disagree at P={P} "
             f"({int((k[2] != p[2]).sum())} slots, {int((k[0] != p[0]).sum())} distances, "
             f"{int((k[3] != p[3]).any(1).sum())} visits)")
    out = dict(max_abs_err=float((k[0] - p[0]).abs().max()), bitwise=True, plain_ms=plain_ms,
               found_frac=float((k[2] >= 0).float().mean()), slots_read=int(seen.sum()),
               split=P, serial_mismatch=0)
    serial_visits = None
    if P > 1:
        seen_s = torch.zeros_like(seen)
        s = closest_bvh_reference(bvh.nodes, bvh.root_link, q, max_d2, visits=True, seen=seen_s)
        off = k[2] != s[2]
        dk, ds = k[0][off].sqrt(), s[0][off].sqrt()
        gap = float((dk - ds).abs().max()) if bool(off.any()) else 0.0
        # float32 spacings between the two distances (non-negative floats
        # order like their bits)
        ulps = int((dk.view(torch.int32) - ds.view(torch.int32)).abs().max()) if gap else 0
        out.update(serial_mismatch=int(off.sum()), serial_gap=gap, serial_gap_ulps=ulps,
                   slots_read=min(out["slots_read"], int(seen_s.sum())),
                   serial_visits=float(s[3].double().sum()))
        serial_visits = s[3]
        log(f"{name}: split walk (P={P}) vs serial walk: {int(off.sum())} of {q.shape[0]} "
            f"winners differ (float near-ties), distances within {gap:.3g} m ({ulps} float32 "
            f"spacings); visits split {float(k[3].double().sum()):.0f}, serial "
            f"{out['serial_visits']:.0f}")
        if float(off.float().mean()) > 0.005 or gap > 1e-5:
            fail(f"{name}: the split walk's winners stray from the serial walk's")
    out["ms"] = cuda_ms(lambda: closest_bvh(bvh.nodes, bvh.root_link, q, max_d2), reps=3)
    out["bound_ms"], out["bound_by"], out["visits"] = closest_bvh_bound(
        k[3], q.shape[0], out["slots_read"], serial_visits)
    return out


def pair_divisions(tri, inputs, best_key, n_blocks, chunk=256):
    """The IEEE divisions K6b's pairs run, counted from the regions the
    plain version's arithmetic gives (two in the face, one on an edge, none
    at a vertex or for a padding triangle) over the candidates the first
    ``n_blocks`` blocks visit (slot < count, dlb <= the block's final worst
    key). Returns (divisions a pair, {region: share of the pairs})."""
    qb, d2b, cand, count, dlb = (x[:n_blocks] for x in inputs)
    B = tri.shape[2]
    worst = ((best_key[:n_blocks].amax(dim=1) | (B - 1)).view(torch.float32))[:, None]
    slot = torch.arange(cand.shape[1], device=cand.device)[None, :]
    blk, c = torch.nonzero((slot < count[:, None]) & (dlb <= worst), as_tuple=True)
    tally = torch.zeros(5, dtype=torch.float64, device=tri.device)  # pad vertex edge face
    for s in range(0, blk.numel(), chunk):
        b, bins = blk[s:s + chunk], cand[blk[s:s + chunk], c[s:s + chunk]]
        t = tri[bins.long(), :9]
        ax, ay, az, abx, aby, abz, acx, acy, acz = (t[:, k, :, None] for k in range(9))
        qx, qy, qz = (qb[b, None, :, k] for k in range(3))
        apx, apy, apz = qx - ax, qy - ay, qz - az
        d1, d2 = abx * apx + aby * apy + abz * apz, acx * apx + acy * apy + acz * apz
        bpx, bpy, bpz = apx - abx, apy - aby, apz - abz
        d3, d4 = abx * bpx + aby * bpy + abz * bpz, acx * bpx + acy * bpy + acz * bpz
        cpx, cpy, cpz = apx - acx, apy - acy, apz - acz
        d5, d6 = abx * cpx + aby * cpy + abz * cpz, acx * cpx + acy * cpy + acz * cpz
        va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
        vert = ((d1 <= 0) & (d2 <= 0)) | ((d3 >= 0) & (d4 <= d3)) | ((d6 >= 0) & (d5 <= d6))
        edge = ~vert & (((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))
                        | ((vb <= 0) & (d2 >= 0) & (d6 <= 0)) | ((vc <= 0) & (d1 >= 0) & (d3 <= 0)))
        pad = ((abx.abs() + aby.abs() + abz.abs() + acx.abs() + acy.abs() + acz.abs())
               < 1e-30).expand_as(vert)
        for i, m in enumerate((pad, ~pad & vert, ~pad & edge, ~pad & ~vert & ~edge)):
            tally[i] += m.sum()
    tally[4] = tally[:4].sum()
    n = float(tally[4])
    shares = dict(zip(("padding", "vertex", "edge", "face"), (float(x) / n for x in tally[:4])))
    return (float(tally[2]) + 2 * float(tally[3])) / n, shares


def check_closest_bins(name, tri, inputs, plain_blocks=None, division_blocks=None):
    """K6b against its plain version (keys and bins bitwise) on the first
    ``plain_blocks`` blocks (all by default); the kernel is timed on all
    of them, with the bound, and its divisions a pair counted on the first
    ``division_blocks`` (all by default)."""
    from rmcl_tpu_torch.ops.closest_cuda import bins_groups, closest_bins, closest_bins_reference

    part = inputs if plain_blocks is None else tuple(x[:plain_blocks] for x in inputs)
    launches = closest_bins.launches
    k = closest_bins(tri, *part)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = closest_bins_reference(tri, *part)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if closest_bins.launches != launches + 1:
        fail(f"{name}: K6b did not launch")
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        fail(f"{name}: K6b and its plain version disagree ({int((k[0] != p[0]).sum())} keys, "
             f"{int((k[1] != p[1]).sum())} bins)")
    key = k[0] if plain_blocks is None else closest_bins(tri, *inputs)[0]
    n_blk, Rq, B = inputs[0].shape[0], inputs[0].shape[1], tri.shape[2]
    out = dict(max_abs_err=0.0, bitwise=True, plain_ms=plain_ms,
               plain_queries=part[0].shape[0] * part[0].shape[1],
               groups=bins_groups(n_blk, Rq, B, tri.device))
    out["ms"] = cuda_ms(lambda: closest_bins(tri, *inputs), reps=3)
    out["bound_ms"], out["bound_by"], out["visits"] = closest_bins_bound(inputs, key, B)
    out["div_per_pair"], out["regions"] = pair_divisions(tri, inputs, key,
                                                         division_blocks or n_blk)
    log(f"{name}: G={out['groups']} lanes a query; {out['div_per_pair']:.3f} divisions a pair "
        f"(regions " + ", ".join(f"{k} {v:.4f}" for k, v in out["regions"].items())
        + f"; first {division_blocks or n_blk} blocks), 5 before the region-first form")
    return out


def exact_line(name, r, what):
    return (f"{name}: kernel = plain version bitwise; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.1f} ms (one run{', ' + what if what else ''}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['visits']:.0f} visits), roofline "
            f"{r['bound_ms'] / r['ms']:.2%}")


def launch_floor_ms(n_blk, threads):
    """Device ms of one launch of an empty kernel at n_blk CTAs of threads
    on the current stream (csrc/cull_boxes.cu's launch_floor_kernel): by
    the profiler's device trace, else by events around LOOP_LAUNCHES."""
    import ctypes

    from rmcl_tpu_torch import _build

    fn = _build.load_library("cull_boxes").rmcl_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        if fn(n_blk, threads, torch.cuda.current_stream().cuda_stream):
            fail("the empty kernel did not launch")

    ms = device_ms(launch, "launch_floor_kernel")
    if ms is None:
        ms = cuda_ms(lambda: [launch() for _ in range(LOOP_LAUNCHES)], reps=3) / LOOP_LAUNCHES
    return ms


def cp_candidates_bound(bins, qb, d2b, cs, cb, chunk=2048):
    """Least time for K7's work on these blocks: the box-box tests it runs
    (every super, then the bins of the supers a block keeps: those within
    its bound, at most cs) at OPS_PER_BOX_BOX and each block's box and bound
    at OPS_PER_BLOCK_QUERY a query, against reading the queries, their
    bounds and the boxes once and writing the lists."""
    from rmcl_tpu_torch.ops.closest_point import _box_box_d2

    n_blk, Rq = qb.shape[0], qb.shape[1]
    kept = 0.0
    for s in range(0, n_blk, chunk):
        lo, hi = qb[s:s + chunk].amin(dim=1)[:, None], qb[s:s + chunk].amax(dim=1)[:, None]
        d2 = _box_box_d2(lo, hi, bins.super_aabb[None, :, :3], bins.super_aabb[None, :, 3:])
        within = (d2 <= d2b[s:s + chunk].amax(dim=1)[:, None]).sum(dim=1)
        kept += float(torch.clamp(within, max=cs).double().sum())
    tests = n_blk * bins.n_super + kept * bins.bins_per_super
    ops = tests * OPS_PER_BOX_BOX + n_blk * Rq * OPS_PER_BLOCK_QUERY
    bytes_moved = ((bins.n_super + bins.n_bins) * 24 + n_blk * Rq * 16
                   + n_blk * (cb * 8 + 5))
    return bound_of(bytes_moved, ops) + (tests,)


def check_cp_candidates(name, bins, qb, d2b, cs, cb, plain_blocks=None, path_lists=None):
    """K7 against its plain version (lists, counts and bounds bitwise) on
    the first ``plain_blocks`` query blocks (all by default), and against
    the path's own lists ``path_lists`` where given; the kernel timed on
    every block by the profiler's device trace (where the trace holds no
    launch, by events around LOOP_LAUNCHES launches), its call by events,
    the plain version by events on the compared blocks, with the bound, the
    launch plan (threads a CTA, dynamic shared bytes) and the device time of
    an empty launch at the same grid."""
    from rmcl_tpu_torch.ops.closest_cuda import cp_candidates, cp_launch_plan, fill_threads
    from rmcl_tpu_torch.ops.closest_point import _cp_candidates

    n = qb.shape[0] if plain_blocks is None else min(plain_blocks, qb.shape[0])
    plain = lambda: _cp_candidates(bins, qb[:n], torch.amax(d2b[:n], dim=1), cs, cb)
    launches = cp_candidates.launches
    k = cp_candidates(bins, qb[:n].contiguous(), d2b[:n].contiguous(), cs, cb)
    p = plain()
    torch.cuda.synchronize()
    if cp_candidates.launches != launches + 1:
        fail(f"{name}: K7 did not launch")
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        fail(f"{name}: K7 and its plain version disagree ({int((k[0] != p[0]).any(1).sum())} "
             f"lists, {int((k[1] != p[1]).sum())} counts, {int((k[2] != p[2]).any(1).sum())} "
             f"bounds)")
    if path_lists is not None and not all(torch.equal(a[:n], b) for a, b in zip(path_lists, k)):
        fail(f"{name}: the path's candidate lists differ from K7's")
    launch = lambda: cp_candidates(bins, qb, d2b, cs, cb)
    out = dict(max_abs_err=0.0, bitwise=True, blocks=qb.shape[0], plain_blocks=n,
               mean_count=float(k[1].float().mean()), max_count=int(k[1].max()),
               saturated=int(p[3].sum()), timed_by="device trace")
    out["call_ms"] = cuda_ms(launch, reps=3)
    out["ms"] = device_ms(launch, "cull_boxes_kernel")
    if out["ms"] is None:
        out["ms"] = cuda_ms(lambda: [launch() for _ in range(LOOP_LAUNCHES)], reps=3) / LOOP_LAUNCHES
        out["timed_by"] = f"events around {LOOP_LAUNCHES} launches"
    out["plain_ms"] = cuda_ms(plain, reps=1)
    out["bound_ms"], out["bound_by"], out["tests"] = cp_candidates_bound(bins, qb, d2b, cs, cb)
    out["threads"], _, out["shared_bytes"] = cp_launch_plan(
        qb.shape[0], bins.n_super, bins.bins_per_super, cs, cb, fill_threads(qb.device))
    out["floor_ms"] = launch_floor_ms(qb.shape[0], out["threads"])
    return out


def check_cull_wide(bins, o, d, lim, cs, cb):
    """K3 (``cull_rays``: phase 8's scan in 128-ray blocks of 4 cones) on a
    level wider than the 16,384 keys its key region once held, which the
    kernel's earlier form refused: one launch counted, bitwise its plain
    version on every block, timed by the device trace, its bound and launch
    plan."""
    from rmcl_tpu_torch.ops.cull_cuda import cull_launch_plan, cull_rays, cull_rays_reference
    from rmcl_tpu_torch.ops.raycast_binned import _flat_rays, _pad_rays

    blocks = tuple(x.contiguous() for x in _pad_rays(*_flat_rays(o, d, *lim)[:4],
                                                       DEFAULT_BLOCK_SIZE))
    args = (bins, *blocks, 4, cs, cb, 0, 0)
    label = (f"phase 8 K3 on a level wider than 16,384 keys ({bins.n_super} supers of "
             f"{bins.bins_per_super}, cs={cs}, cb={cb})")
    reset_counts()
    k = cull_rays(*args)
    torch.cuda.synchronize()
    launches = read_counts()["K3r"]
    p = cull_rays_reference(*args)
    if launches != 1:
        fail(f"{label}: K3 launched {launches} times")
    if not all(torch.equal(x, y) for x, y in zip(k, p)):
        fail(f"{label}: K3 is not bitwise its plain version")
    threads, slots, smem, stream = cull_launch_plan(blocks[0].shape[0], 4, DEFAULT_BLOCK_SIZE,
                                                    bins.n_super, bins.bins_per_super, cs, cb)
    r = dict(n_super=bins.n_super, S=bins.bins_per_super, cs=cs, cb=cb, launches=launches,
             bitwise=True, max_abs_err=0.0, threads=threads, key_slots=slots, shared_bytes=smem,
             streamed=stream,
             max_count=int(k[1].max()), saturated=int(k[3].sum()), timed_by="device trace")
    r["ms"] = device_ms(lambda: cull_rays(*args), "cull_kernel")
    if r["ms"] is None:
        r["ms"], r["timed_by"] = cuda_ms(lambda: cull_rays(*args)), "events"
    r["plain_ms"] = cuda_ms(lambda: cull_rays_reference(*args), reps=1)
    r["bound_ms"], r["bound_by"], r["tests"] = full_cull_bound(bins, blocks, 4, cs, cb, 0, 0)
    log(f"{label}: bitwise its plain version on {blocks[0].shape[0]} blocks, launches {launches}, "
        f"{r['ms']:.4f} ms by the {r['timed_by']} (bound {r['bound_ms']:.4f} ms {r['bound_by']}, "
        f"{r['bound_ms'] / r['ms']:.1%}; {r['tests']:.0f} tests), plain {r['plain_ms']:.3f} ms; "
        f"{threads} threads, {slots} key slots, {smem} B shared; candidates max "
        f"{r['max_count']}, {r['saturated']} saturated")
    return r


def k7_line(name, r):
    return (f"{name}: K7 = plain version bitwise on {r['plain_blocks']} of {r['blocks']} blocks; "
            f"kernel {r['ms']:.4f} ms by the {r['timed_by']} (the call {r['call_ms']:.4f} ms by "
            f"events; {r['threads']} threads a CTA, {r['shared_bytes']} B of shared memory), plain "
            f"{r['plain_ms']:.3f} ms ({r['plain_blocks']} blocks), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['tests']:.0f} box-box tests), an empty launch at this grid "
            f"{r['floor_ms']:.4f} ms, roofline {r['bound_ms'] / r['ms']:.2%}; candidates mean "
            f"{r['mean_count']:.2f}, max {r['max_count']}, {r['saturated']} blocks truncated (sat)")


def binned_breakdown(bins, q, max_dist, **budgets):
    """closest_points_binned's steps on the card, one CUDA event between
    each: the Morton order and permute, binned_inputs (the candidate cull,
    _cp_candidates), K6b, and the winners' exact points with the
    un-permute. Returns ({step: ms}, the result)."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins
    from rmcl_tpu_torch.ops.closest_point import _max_d2, binned_inputs, binned_winners
    from rmcl_tpu_torch.ops.order import cluster_order

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    max_d2 = _max_d2(max_dist, q.shape[:1], "cuda", cap=1.7e19)
    torch.cuda.synchronize()
    ev[0].record()
    order, inv = cluster_order(q, None)
    qs, md = q[order.long()], max_d2[order.long()]
    ev[1].record()
    *inputs, _ = binned_inputs(bins, qs, md, **budgets)
    ev[2].record()
    key, best_bin = closest_bins(bins.tri, *inputs)
    ev[3].record()
    out = binned_winners(bins, qs, md, key, best_bin, inv)
    ev[4].record()
    torch.cuda.synchronize()
    steps = ("cluster_order", "binned_inputs (K7)", "K6b", "winners")
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(steps)}, out


def phase_exact_main_path(main_r):
    import dataclasses

    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.pipeline import MICPSensorConfig, correct_once
    from rmcl_tpu_torch.ops import closest_cuda, traverse_cuda
    from rmcl_tpu_torch.ops.closest_cuda import bins_groups, walk_split
    from rmcl_tpu_torch.ops.closest_point import _max_d2, binned_inputs
    from rmcl_tpu_torch.ops.order import cluster_order
    from rmcl_tpu_torch.ops.raycast import cast_rays
    from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
    from rmcl_tpu_torch.sensors.simulate import simulate

    regs = {**traverse_cuda.kernel_registers(), **closest_cuda.kernel_registers()}
    log("phase 8 exact-engine and closest-point kernels as built (registers, local bytes a thread; local bytes "
        "are spills): " + ", ".join(f"{k} {r} regs {b} B" for k, (r, b) in regs.items()))
    if any(b for _, b in regs.values()):
        fail("phase 8: a kernel spills to local memory")
    bmap, model = main_r["bmap"], main_r["model"]
    true_pose, config = main_r["true_pose"], main_r["config"]
    # CP on the bins at budgets that cut no list (every super and bin):
    # its corrections are then the exact engine's, and held to JAX's CP on
    # the BVH; JAX's CP on the bins ran at phase 4's ray budgets, cut lists
    # (its last block padded with origin queries) that the port no longer
    # reproduces
    bins = bmap.bins
    cs_all = bins.n_super
    cp_config = dataclasses.replace(config, cp_super=cs_all, cp_bin=min(
        bins.n_bins, cs_all * bins.bins_per_super, closest_cuda.cp_max_keys(cs_all)))
    held = {"cp_bins": "cp_bvh"}  # the JAX figure each variant is held to
    # the scan to localise against, as the sensor measures it: the exact
    # engine's. Phase 4's scan comes from the bins at the default budgets,
    # which truncate 97 of its 113 blocks and drop 10.3% of the rays; which
    # rays depends on the bins, and with the native order's the rest leave
    # the correction ill-conditioned: the JAX package's own RC on the BVH
    # ends 0.19 m off there and its CP on the bins 0.44 m
    # (scripts/torch_exact_probe.py with that scan)
    hits = simulate(bmap.bvh, model, true_pose)
    sensor = dataclasses.replace(main_r["sensor"], points=hits.point, mask=hits.hit)
    tbo = Transform.identity()
    variants = (("cp_bins", "CP on the bins", bmap.bins, "CP", "K6b"),
                ("rc_bvh", "RC on the BVH", bmap.bvh, "RC", "K5"),
                ("cp_bvh", "CP on the BVH", bmap.bvh, "CP", "K6"))
    runs = {}
    for key, label, structure, corr, kernel in variants:
        s = dataclasses.replace(sensor, config=MICPSensorConfig.create(max_dist=EXACT_MAX_DIST,
                                                                       corr_type=corr))
        cfg = cp_config if key == "cp_bins" else config
        correct_once(structure, [s], true_pose, tbo, 0.0, cfg)  # warm-up, not counted
        torch.cuda.synchronize()
        tom = Transform.from_pose_tuple(EXACT_START)
        progress = torch.zeros((), device="cuda")
        times, truncated = [], []
        reset_counts()
        for _ in range(N_CORRECTIONS):
            t = time.perf_counter()
            tom, stats = correct_once(structure, [s], tom, tbo, progress, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            progress = stats.convergence_progress
            truncated.append(stats.truncated_blocks)
        counts = read_counts()
        if key == "cp_bins" and any(int(n) for n in truncated):
            fail(f"phase 8 {label}: K7 flags truncated blocks at every super and bin")
        err = float(torch.linalg.vector_norm(tom.trans - true_pose.trans))
        G = bins_groups(-(-model.n_rays // 128), 128, bmap.bins.bin_size, "cuda")
        split = {"K6": f" at P={walk_split(model.n_rays, 'cuda')}", "K6b": f" at G={G}"}
        log(f"phase 8 {label}: {N_CORRECTIONS} corrections x {model.n_rays} rays, median "
            f"{statistics.median(times):.3f} ms/correction (min {min(times):.3f}), final |dt| "
            f"{err:.3e} m (JAX on the CPU: {EXACT_ERR_JAX[held.get(key, key)]:.3e} m), matches "
            f"{float(stats.valid_matches):.0f}/{float(stats.valid_measurements):.0f}; launches "
            + ", ".join(f"{k} {v}{split.get(k, '')}" for k, v in counts.items() if v))
        want = EXACT_ERR_JAX[held.get(key, key)]
        if not (err <= want + EXACT_ERR_SLACK and bool(torch.isfinite(tom.trans).all())):
            fail(f"phase 8 {label}: final translation error {err} m, JAX's {want} m")
        for k in (kernel, "K7", "GN") if key == "cp_bins" else (kernel, "GN"):
            if counts[k] != N_CORRECTIONS:
                fail(f"phase 8 {label}: {k} launched {counts[k]} times in "
                     f"{N_CORRECTIONS} corrections (one a correction expected)")
        runs[key] = dict(tom=tom, ms=statistics.median(times), err=err, launches=counts[kernel],
                         sensor=s, k7_launches=counts["K7"])

    # the same corrections against phase 4's budgeted scan, held to the JAX
    # package's own there
    budgeted = {}
    for key, label, structure, corr, _ in variants:
        s = dataclasses.replace(main_r["sensor"], config=MICPSensorConfig.create(
            max_dist=EXACT_MAX_DIST, corr_type=corr))
        tom = Transform.from_pose_tuple(EXACT_START)
        progress = torch.zeros((), device="cuda")
        trans = []
        for _ in range(N_CORRECTIONS):
            tom, stats = correct_once(structure, [s], tom, tbo, progress,
                                      cp_config if key == "cp_bins" else config)
            progress = stats.convergence_progress
            trans.append(tom.trans)
        trans = torch.stack(trans).double().cpu()
        errs = torch.linalg.vector_norm(trans - true_pose.trans.double().cpu(), dim=1).tolist()
        step1 = float((trans[0] - torch.tensor(BUDGETED_TRANS1_JAX[held.get(key, key)],
                                               dtype=torch.float64)).abs().max())
        budgeted[key] = dict(errs=errs, step1_gap=step1)
        log(f"phase 8 {label} on phase 4's budgeted scan: |dt| after each correction "
            + ", ".join(f"{e:.3e}" for e in errs) + f" m (JAX on the CPU ends at "
            f"{BUDGETED_ERR_JAX[held.get(key, key)]:.3e} m); the first correction {step1:.3e} m "
            f"from JAX's")
        if not (step1 <= BUDGETED_STEP1_TOL and bool(torch.isfinite(trans).all())):
            fail(f"phase 8 {label} on the budgeted scan: the first correction is {step1} m from "
                 f"JAX's (at most {BUDGETED_STEP1_TOL} m)")
    rc_gap = max(abs(a - b) for a, b in zip(budgeted["rc_bvh"]["errs"], BUDGETED_RC_ERRS_JAX))
    log(f"phase 8 RC on the BVH on the budgeted scan: every correction's |dt| within "
        f"{rc_gap:.3e} m of JAX's")
    if not rc_gap <= EXACT_ERR_SLACK:
        fail(f"phase 8 RC on the BVH on the budgeted scan: a correction {rc_gap} m from JAX's")
    if not budgeted["cp_bvh"]["errs"][-1] <= BUDGETED_ERR_JAX["cp_bvh"] + EXACT_ERR_SLACK:
        fail(f"phase 8 CP on the BVH on the budgeted scan: final translation error "
             f"{budgeted['cp_bvh']['errs'][-1]} m, JAX's {BUDGETED_ERR_JAX['cp_bvh']} m")

    # K5 on the last RC correction's rays
    o_s, d_s = model.rays("cuda")
    n = o_s.shape[0]
    lim = (torch.full((n,), model.range.min, device="cuda"),
           torch.full((n,), model.range.max, device="cuda"))
    tsm = (runs["rc_bvh"]["tom"] @ tbo) @ sensor.tsb
    r5 = check_traverse("phase 8 K5", bmap.bvh, (tsm.apply(o_s), tsm.rotate(d_s), *lim),
                        device_timed=True)
    log(exact_line("phase 8 K5 on the last RC correction's rays", r5,
                   f"{r5['slots_read']} of {bmap.bvh.n_slots} slots read")
        + f"; kernel by the {r5['timed_by']}, the call {r5['call_ms']:.4f} ms by events")
    # K6 on the last CP correction's queries (find_cpc's map-frame points)
    tsm = (runs["cp_bvh"]["tom"] @ tbo) @ sensor.tsb
    q = tsm.apply(sensor.points).contiguous()
    r6 = check_closest_bvh("phase 8 K6", bmap.bvh, q, _max_d2(EXACT_MAX_DIST, q.shape[:1], "cuda"))
    log(exact_line(f"phase 8 K6 (P={r6['split']}) on the last CP correction's queries", r6,
                   f"{r6['slots_read']} slots read"))
    # K6b on the last CP-on-bins correction's query blocks (cluster order)
    tsm = (runs["cp_bins"]["tom"] @ tbo) @ sensor.tsb
    q = tsm.apply(sensor.points)
    order, _ = cluster_order(q, None)
    qs = q[order.long()]
    md = _max_d2(EXACT_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19)
    budgets = dict(zip(("c_super", "c_bin"), cp_config.cp_budgets()))
    *inputs, sat = binned_inputs(bmap.bins, qs, md, **budgets)
    r6b = check_closest_bins("phase 8 K6b", bmap.bins.tri, inputs)
    log(exact_line(f"phase 8 K6b (G={r6b['groups']}) on the last CP-on-bins correction's "
                   f"{inputs[0].shape[0]} blocks", r6b, ""))
    cs = min(cp_config.cp_super, bmap.bins.n_super)
    r7 = check_cp_candidates("phase 8 K7", bmap.bins, inputs[0], inputs[1], cs,
                             inputs[2].shape[1], path_lists=(*inputs[2:], sat))
    r7.update(launches=runs["cp_bins"]["k7_launches"], correction_ms=runs["cp_bins"]["ms"],
              inputs_ms=cuda_ms(lambda: binned_inputs(bmap.bins, qs, md, **budgets), reps=3))
    log(k7_line("phase 8 K7 on the last CP-on-bins correction's blocks", r7)
        + f"; binned_inputs (blocks + K7) {r7['inputs_ms']:.4f} ms a call by events")
    # K7 on levels wider than 16,384 keys, on the same queries
    qb, d2b = inputs[:2]
    wide, wide_k3 = [], []
    for S, cs, cb in K7_WIDE_LEVELS:
        bins = build_bins(bmap.mesh, bin_size=K7_WIDE_BIN_SIZE, bins_per_super=S)
        rw = check_cp_candidates(f"phase 8 K7 wide (S {S})", bins, qb, d2b, cs, cb)
        rw.update(n_super=bins.n_super, S=S, cs=cs, cb=cb)
        log(k7_line(f"phase 8 K7 on a level wider than 16,384 keys ({bins.n_super} supers of {S}, "
                    f"cs={cs}, cb={cb}: {max(bins.n_super, cs * S)} keys)", rw))
        wide.append({k: rw[k] for k in ("n_super", "S", "cs", "cb", "ms", "bound_ms", "threads",
                                        "shared_bytes", "max_count")})
        wide_k3.append(check_cull_wide(bins, true_pose.apply(o_s), true_pose.rotate(d_s), lim,
                                       cs, cb))
    r7["wide_levels"] = wide
    r7["k3_wide_levels"] = wide_k3

    # the exact engine recovers what the dense engine's budgets drop
    o, d = true_pose.apply(o_s), true_pose.rotate(d_s)
    exact = cast_rays(bmap.bvh, o, d, t_min=lim[0], t_max=lim[1])
    bins = bmap.bins
    free = cast_rays_binned(bins, o, d, lim[0], lim[1], c_super=bins.n_super,
                            c_bin=bins.n_super * bins.bins_per_super)
    capped = cast_rays_binned(bins, o, d, lim[0], lim[1], c_super=config.c_super,
                              c_bin=config.c_bin)
    hit, hit_free = float(exact.hit.float().mean()), float(free.hit.float().mean())
    log(f"phase 8 hits at the true pose: exact (K5) {hit:.6f}, dense with no budget "
        f"{hit_free:.6f}, dense at the default budgets {float(capped.hit.float().mean()):.6f}; "
        f"{int((exact.hit != free.hit).sum())} rays differ between exact and unbudgeted")
    if not abs(hit - hit_free) <= 0.001:
        fail(f"phase 8: the exact engine hits {hit:.6f}, the unbudgeted dense engine {hit_free:.6f}")
    for key, r in (("rc_bvh", r5), ("cp_bvh", r6), ("cp_bins", r6b)):
        r.update(launches=runs[key]["launches"], correction_ms=runs[key]["ms"],
                 err=runs[key]["err"])
    return dict(k5=r5, k6=r6, k6b=r6b, hit_frac=hit, hit_frac_unbudgeted=hit_free,
                runs={k: dict(ms=v["ms"], err=v["err"]) for k, v in runs.items()},
                k7=r7, registers=regs)


def reference_scan_rays(model):
    """Phase 9's rays: N_POSES poses of ``model`` at uniform offsets in [-5,
    5] m (seed 0), unrotated; (o, d) flattened to (N_POSES * rays, 3) and
    the offsets (numpy)."""
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform

    trans = np.random.default_rng(0).uniform(-5, 5, size=(N_POSES, 3)).astype(np.float32)
    tsm = Transform(rot=Quaternion.identity((N_POSES,), "cuda"),
                    trans=torch.from_numpy(trans).cuda()).expand_dims(-1)
    o_s, d_s = model.rays("cuda")
    return (tsm.apply(o_s).reshape(-1, 3).contiguous(),
            tsm.rotate(d_s).reshape(-1, 3).contiguous(), trans)


def mcl_beams(points, mask, seed=MCL_SEED):
    """MCL_BEAMS beams drawn with ``seed`` from the valid points of a
    sensor-frame scan, with replacement as the JAX package's
    ``mcl/sensor_update.py::sample_beams`` draws them: unit directions (S,
    3) and ranges (S,)."""
    valid = torch.nonzero(mask.reshape(-1)).squeeze(1).cpu().numpy()
    pick = np.random.default_rng(seed).choice(valid, MCL_BEAMS, replace=True)
    p = points.reshape(-1, 3)[torch.from_numpy(pick).to(points.device)]
    r = torch.linalg.vector_norm(p, dim=1)
    return p / r[:, None], r


def angular_order(dirs):
    """The beams' angular order, as the JAX package sorts them once for its
    particle-major layouts (``sensor_update.py:340-350``): by the elevation's
    band of 22.5 degrees, then the azimuth in 512 steps (a stable sort)."""
    az = torch.atan2(dirs[:, 1], dirs[:, 0])
    el = torch.asin(torch.clamp(dirs[:, 2], -1.0, 1.0))
    band = torch.clamp(((el + np.pi * 0.5) * (8.0 / np.pi)).to(torch.int32), 0, 7)
    azq = torch.clamp(((az + np.pi) * (512.0 / (2.0 * np.pi))).to(torch.int32), 0, 511)
    return torch.argsort(band * 512 + azq, stable=True)


def mcl_rays(dirs, ranges, n_particles=MCL_PARTICLES, seed=MCL_SEED):
    """MCL's sensor-update rays, particle-major: ``n_particles`` poses drawn
    with ``seed`` uniformly over the building's floor (x in [0, 24], y in
    [0, 18] m, z = MCL_Z, yaw in [-pi, pi); MCLNode.global_localization's
    box) and ray (i, s) = particle i's pose applied to beam s. Returns o, d
    (n_particles * S, 3) and t_max (range + MCL_RANGE_CAP) (n_particles *
    S,), contiguous."""
    from rmcl_tpu_torch.math.se3 import Transform

    rng = np.random.default_rng(seed)
    poses = np.zeros((n_particles, 6), np.float32)
    poses[:, :2] = rng.uniform((0.0, 0.0), MCL_FLOOR, (n_particles, 2))
    poses[:, 2] = MCL_Z
    poses[:, 5] = rng.uniform(-np.pi, np.pi, n_particles)
    tsm = Transform.from_pose_tuple(torch.from_numpy(poses).cuda()).expand_dims(-1)
    S = dirs.shape[0]
    d = tsm.rotate(dirs).reshape(-1, 3).contiguous()
    o = tsm.trans.expand(n_particles, S, 3).reshape(-1, 3).contiguous()
    t_max = (ranges + MCL_RANGE_CAP).expand(n_particles, S).reshape(-1).contiguous()
    return o, d, t_max


def phase_mcl_cast(main_r):
    """Phase 10: MCL's sensor-update cast at the reference's size on phase
    4's building map, through ``cast_rays`` (host clock and events), then
    K5 against its plain version on a slice, timed on all rays in the
    beams' sampled and angular orders (which change no ray's result)."""
    from rmcl_tpu_torch.ops.raycast import cast_rays
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    bvh, sensor = main_r["bmap"].bvh, main_r["sensor"]
    dirs, ranges = mcl_beams(sensor.points, sensor.mask)
    o, d, t_max = mcl_rays(dirs, ranges)
    n = o.shape[0]
    log(f"phase 10 rays: {MCL_PARTICLES} particles x {MCL_BEAMS} beams = {n} rays on the "
        f"building's BVH ({bvh.n_slots} slots, {bvh.nbytes() / 1e6:.1f} MB); beam ranges "
        f"{float(ranges.min()):.2f}-{float(ranges.max()):.2f} m (median "
        f"{float(ranges.median()):.2f}), t_max = range + {MCL_RANGE_CAP} m")
    cast_rays(bvh, o[:1024], d[:1024], t_max=t_max[:1024])  # warm-up, not counted
    torch.cuda.synchronize()

    # the main drive: one cast of every ray
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reset_counts()
    t = time.perf_counter()
    ev[0].record()
    hits = cast_rays(bvh, o, d, t_min=0.0, t_max=t_max)
    ev[1].record()
    torch.cuda.synchronize()
    cast_ms = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hit = hits.hit
    hit_frac = float(hit.float().mean())
    finite = bool(torch.isfinite(hits.t[hit]).all() & torch.isfinite(hits.point[hit]).all())
    in_range = bool(((hits.t[hit] > 0) & (hits.t[hit] <= t_max[hit] * (1 + T_RTOL))).all())
    log(f"phase 10 cast_rays: {n} rays in {cast_ms:.2f} ms (host clock; "
        f"{ev[0].elapsed_time(ev[1]):.2f} ms by events), hits {hit_frac:.6f}, peak memory "
        f"{peak_gb:.2f} GB; launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if counts["K5"] != 1 or sum(counts.values()) != 1:
        fail(f"phase 10: the cast launched {counts} (K5 once expected)")
    if tuple(hits.t.shape) != (n,) or not finite or not in_range or not hit_frac > 0.5:
        fail(f"phase 10: the cast's hits are off (shape {tuple(hits.t.shape)}, finite {finite}, "
             f"t within (0, t_max] {in_range}, hits {hit_frac})")
    S = EXACT_SLICE
    head = (hits.hit[:S].clone(), hits.prim_id[:S].clone())
    del hits, hit

    # K5 against its plain version on the first rays; the cast's hits there
    t_min = torch.zeros(n, device="cuda")
    r5 = check_traverse("phase 10 K5", bvh, (o[:S], d[:S], t_min[:S], t_max[:S]))
    _, slot, _ = traverse_rays(bvh.nodes, bvh.root_link, o[:S], d[:S], t_min[:S], t_max[:S],
                               visits=True)
    prim = bvh.nodes.view(torch.int32)[slot.clamp(min=0).long(), 12]
    if not (torch.equal(head[0], slot >= 0) and torch.equal(head[1][head[0]], prim[slot >= 0])):
        fail("phase 10: cast_rays' hits differ from K5's plain version on the first rays")
    # K5 on every ray: one run with visits (the bound), then timed; the
    # same rays with the beams in angular order
    _, slot, visits = traverse_rays(bvh.nodes, bvh.root_link, o, d, t_min, t_max, visits=True)
    r5["ms"] = cuda_ms(lambda: traverse_rays(bvh.nodes, bvh.root_link, o, d, t_min, t_max),
                       reps=3)
    r5["bound_ms"], r5["bound_by"], r5["visits"] = traverse_bound(visits, n, r5["slots_read"])
    r5.update(launches=counts["K5"], hit_frac=hit_frac,
              cast_ms=cast_ms, cast_event_ms=ev[0].elapsed_time(ev[1]), peak_gb=peak_gb,
              visits_per_ray=r5["visits"] / n,
              visits_p99=float(torch.quantile(visits[:S].sum(1).double(), 0.99)),
              visits_max=int(visits.sum(1).max()))
    log(exact_line(f"phase 10 K5 ({n} rays; plain version on the first {S})", r5, f"{S} rays")
        + f"; visits a ray {r5['visits_per_ray']:.1f} mean, {r5['visits_p99']:.0f} p99 "
        f"(first {S}), {r5['visits_max']} max")
    del o, d, t_max, visits
    order = angular_order(dirs)
    o, d, t_max = mcl_rays(dirs[order], ranges[order])
    _, slot_a = traverse_rays(bvh.nodes, bvh.root_link, o, d, t_min, t_max)
    if not torch.equal(slot_a.view(-1, MCL_BEAMS), slot.view(-1, MCL_BEAMS)[:, order]):
        fail("phase 10: the angular order changed a ray's result")
    r5["angular_ms"] = cuda_ms(lambda: traverse_rays(bvh.nodes, bvh.root_link, o, d, t_min,
                                                     t_max), reps=3)
    log(f"phase 10 K5 with the beams in angular order: {r5['angular_ms']:.3f} ms against "
        f"{r5['ms']:.3f} ms in sampled order (the same rays' results)")
    del o, d, t_max, t_min, slot, slot_a
    return r5


def phase_mcl_walk_score(world=None):
    """Phase 10b: MCL's RC sensor update at the cell mcl-1m-tracking's
    shape, 1,048,576 particles x 100 beams on phase 11's building from a
    cloud concentrated about the truth (the cell's covariance), on the exact
    walk: ``sensor_update`` through ``walk_score_rc`` (K5 with its scoring
    epilogue, then the fold kernel; one launch each) against the composition
    it replaced (``cast_update_rays``: K5 and ``cast_rays``' winner rows,
    ``score_rc``, ``fold``) on the same beams, both timed by events with
    their peak memory; each kernel by the device trace beside its bound; the
    kernel's evals against its plain version on the first MCL_WS_SLICE
    particles; registers."""
    import dataclasses

    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.sensor_update import (beam_layout, cluster_poses, cast_update_rays,
                                                  fold, sample_beams, score_beams, score_rc,
                                                  sensor_update, update_rays)
    from rmcl_tpu_torch.ops.traverse_cuda import (kernel_registers, traverse_rays,
                                                  walk_score_rc, walk_score_rc_reference)

    mmap, model, truth, points, mask, scfg = world or mcl_world()
    bvh = mmap.bvh
    cfg = dataclasses.replace(scfg, engine="bvh")
    gen = torch.Generator(device="cuda").manual_seed(MCL_SEED)
    cloud = mcl_cloud(truth, MCL_PARTICLES, gen)
    beams = sample_beams(gen, points, mask, MCL_BEAMS)
    tsb = Transform.identity()
    N, S = MCL_PARTICLES, MCL_BEAMS
    regs = kernel_registers()
    if any(local for _, local in regs.values()):
        fail(f"phase 10b: a kernel of traverse_bvh.cu spills: {regs}")

    layout = beam_layout(cfg, beams)
    tsm, _ = cluster_poses(cloud, tsb, cfg)
    tsm7 = torch.cat([tsm.rot, tsm.trans], dim=-1)
    table = score_beams(layout)
    kw = dict(range_min=cfg.range_min, hit_miss=cfg.real_hit_sim_miss_error,
              miss_hit=cfg.real_miss_sim_hit_error, miss_miss=cfg.real_miss_sim_miss_error,
              dist_sigma=cfg.dist_sigma)

    # the kernel's evals against its plain version on the first particles
    n = MCL_WS_SLICE
    k_mean, k_var, k_ev = walk_score_rc(bvh.nodes, bvh.root_link, tsm7[:n].contiguous(), table,
                                        evals=True, **kw)
    p_mean, p_var, p_ev = walk_score_rc_reference(bvh.nodes, bvh.root_link,
                                                  tsm7[:n].contiguous(), table, evals=True, **kw)
    rel = lambda a, b: ((a.double() - b.double()).abs()
                        / b.double().abs().clamp(min=1e-30))
    ev_rel = rel(k_ev, p_ev)
    off = int((ev_rel > MCL_WS_EVAL_RTOL).sum())
    gaps = {"evals_off": off, "evals_off_share": off / ev_rel.numel(),
            "evals_rel_max_agreeing": float(ev_rel[ev_rel <= MCL_WS_EVAL_RTOL].max()),
            "e_mean_rel_p75": float(torch.quantile(rel(k_mean, p_mean), 0.75)),
            "e_var_rel_p75": float(torch.quantile(rel(k_var, p_var), 0.75))}
    if (off > MCL_WS_EVALS_OFF * ev_rel.numel() or gaps["e_mean_rel_p75"] > MCL_WS_FOLD_RTOL
            or gaps["e_var_rel_p75"] > MCL_WS_FOLD_RTOL):
        fail(f"phase 10b: the kernel's evals are off its plain version's: {gaps}")
    log(f"phase 10b kernel vs plain version ({n} particles x {S} beams): " + json.dumps(gaps))
    del k_ev, p_ev, ev_rel

    def composed():
        o, d, hits = cast_update_rays(bvh, cfg, tsm, layout)
        return fold(cloud, cfg, layout, score_rc(cfg, layout, o, d, hits), None)

    fused = lambda: sensor_update(bvh, cloud, None, None, None, tsb, cfg, beams=beams)
    out = {}
    for name, fn in (("composed", composed), ("fused", fused)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        launches = (traverse_rays.launches, walk_score_rc.fold_launches)
        lik = fn().likelihood
        torch.cuda.synchronize()
        out[name] = dict(lik=lik, peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                         launches=(traverse_rays.launches - launches[0],
                                   walk_score_rc.fold_launches - launches[1]))
    if out["fused"]["launches"] != (1, 1) or out["composed"]["launches"] != (1, 0):
        fail(f"phase 10b: launches (K5, fold) fused {out['fused']['launches']}, composed "
             f"{out['composed']['launches']} (expected (1, 1) and (1, 0))")
    mean_rel = rel(out["fused"]["lik"].mean, out["composed"]["lik"].mean)
    r = dict(lik_rel_p75=float(torch.quantile(mean_rel[:MCL_WS_QUANTILE_CAP], 0.75)),
             lik_rel_max=float(mean_rel.max()), registers=regs)
    for name, fn in (("composed", composed), ("fused", fused)):
        r[f"{name}_ms"] = cuda_ms(fn, reps=3)
        r[f"{name}_peak_gb"] = out[name]["peak_gb"]
    del out, mean_rel
    r["k5_score_ms"] = device_ms(fused, "traverse_bvh", reps=3)
    r["fold_ms"] = device_ms(fused, "mcl_fold", reps=3)
    r["k5_store_ms"] = device_ms(composed, "traverse_bvh", reps=3)
    # the bound: the walk's visits on the same rays (the cast's rays in the
    # walk's angular order), every slot read once (an upper bound on bytes)
    orig_m, dirs_m, t_m = update_rays(tsm, layout)
    from rmcl_tpu_torch.mcl.sensor_update import _angular_order
    order = _angular_order(layout.dirs)
    o = orig_m[:, order].reshape(-1, 3)
    d = dirs_m[:, order].reshape(-1, 3)
    t_max = t_m[:, order].reshape(-1).contiguous()
    del orig_m, dirs_m, t_m
    _, slot, visits = traverse_rays(bvh.nodes, bvh.root_link, o, d, torch.zeros_like(t_max),
                                    t_max, visits=True)
    internal, leaf = (float(x) for x in visits.double().sum(0))
    del o, d, t_max, slot, visits
    R = N * S
    ops = (R * (OPS_PER_TRAVERSE_RAY + OPS_PER_SCORE_RAY) + internal * OPS_PER_SLAB_VISIT
           + leaf * OPS_PER_MT_VISIT)
    r["k5_score_bound_ms"], r["k5_score_bound_by"] = bound_of(
        N * 28 + S * 32 + 64 * bvh.n_slots + R * 4, ops)
    r["fold_bound_ms"], r["fold_bound_by"] = bound_of(R * 4 + N * 8, R * OPS_PER_FOLD_EVAL)
    r["visits"] = internal + leaf
    r["speedup"] = r["composed_ms"] / r["fused_ms"]
    if r["lik_rel_p75"] > MCL_WS_FOLD_RTOL:
        fail(f"phase 10b: the fused update's likelihoods are off the composition's: {r}")
    log(f"phase 10b sensor update at {N} x {S} (mcl-1m-tracking's shape): " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}))
    return r


def mcl_world():
    """Phase 11's map, scan and sensor configuration: the JAX package's MCL
    benchmark (scripts/bench_mcl_1m.py) — the 4 x 3-room building at subdiv
    45 with doors at mid-wall, bins of 64 (16 a super, 16 supers a hyper,
    8-bin mids), one VLP-16 scan (900 wide) simulated on the BVH at the
    truth, and its sensor-update configuration."""
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    t0 = time.perf_counter()
    mesh = make_building_scene(rooms_x=4, rooms_y=3, subdiv=BUILDING_SUBDIV, seed=0, door_t=0.5)
    bins = build_bins(mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16)
    mmap = MeshMap(mesh=mesh, bvh=build_bvh(mesh), bins=bins, name="building")
    torch.cuda.synchronize()
    model = SphericalModel.vlp16(width=900)
    truth = Transform.from_pose_tuple(MCL_TRUTH)
    hits = simulate(mmap.bvh, model, truth)
    points = model.polar_to_cartesian(torch.where(hits.hit, hits.t, 0.0))
    scfg = SensorUpdateConfig.create(
        samples=MCL_BEAMS, engine="binned", layout="beam", c_super=48, c_bin=288, c_hyper=8,
        range_max=30.0, dist_sigma=0.4, block_size=128, sub_blocks=8, sort_blocks=True)
    log(f"phase 11 map: building {mesh.n_faces} faces (doors at mid-wall), {bins.n_bins} bins "
        f"of {bins.bin_size} ({bin_order_note()}), {bins.n_super} supers, {bins.n_mid} mids, {bins.n_hyper} hypers, "
        f"BVH {mmap.bvh.n_slots} slots, built in {time.perf_counter() - t0:.2f} s; scan "
        f"{int(hits.hit.sum())}/{model.n_rays} hits at the truth {MCL_TRUTH[:3]}")
    return mmap, model, truth, points, hits.hit, scfg


def mcl_cloud(truth, n, gen):
    from rmcl_tpu_torch.math.stats import sample_pose_gaussian
    from rmcl_tpu_torch.mcl.particles import ParticleCloud

    poses = sample_pose_gaussian(gen, truth, torch.diag(torch.tensor(MCL_COV, device="cuda")), n)
    return ParticleCloud.create(n).with_poses(poses)


def full_cull_bound(bins, blocks, R, cs, cb, ch, cm):
    """fused_bound of one K3 launch on every block of ``blocks``, its tests
    counted in steps of blocks (the plain count's tensors grow with the
    blocks and the boxes a level tests)."""
    from rmcl_tpu_torch.ops.cull_cuda import (_REF_TESTS_PER_STEP, _cull_args,
                                              _subblock_bounds, cull_rays, cull_tests)

    back = _cull_args(bins, lambda r: _subblock_bounds(*blocks, r), R, cs, cb, ch, cm)
    cones, fat = back[:2]
    S, H = bins.bins_per_super, bins.supers_per_hyper
    width = max(cs * S, ch * H if ch else bins.n_super)
    step = max(1, _REF_TESTS_PER_STEP // (R * width))
    tests = 0.0
    for s0 in range(0, cones.shape[0], step):
        sl = slice(s0, s0 + step)
        tests += float(cull_tests(cones[sl], None if fat is None else fat[sl], *back[3:10],
                                  *back[11:]).double().sum())
    return fused_bound(cull_rays, (bins, *blocks), back, tests) + (tests,)


def check_binned_kernels(label, what, bins, inputs, order, sub_blocks, cs, cb, ch, counts):
    """K1 (in the launch order ``order``) and the fused K3 of a binned cast
    (``inputs``: ``_kernel_inputs``' blocks and lists) against their plain
    versions on the first MCL_CHECK_BLOCKS blocks, then each on every block:
    the device trace's time (events where it holds none), K1 in block order
    too, the bounds, K3's registers (a spill fails). Returns (k1, k3)."""
    from rmcl_tpu_torch.ops.cull_cuda import (_cull_args, _subblock_bounds, cull_rays,
                                              cull_rays_reference, kernel_registers)
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins, intersect_bins_reference

    B = bins.bin_size
    sl = lambda x: x[:MCL_CHECK_BLOCKS].contiguous()
    part = tuple(sl(x) for x in inputs)
    part_order = torch.argsort(part[5], stable=True).to(torch.int32)
    launches = intersect_bins.launches
    kt, kref = intersect_bins(bins.tri, *part, order=part_order)
    pt, pref = intersect_bins_reference(bins.tri, *part, order=part_order)
    torch.cuda.synchronize()
    if intersect_bins.launches != launches + 1:
        fail(f"{label} K1: the kernel did not launch")
    k1 = dict(zip(("max_abs_err", "ref_mismatch"),
                  check_agreement(f"{label} K1", bins.tri, part, kt, kref, pt, pref)))
    k1["plain_ms"] = cuda_ms(lambda: intersect_bins_reference(bins.tri, *part), reps=1)
    k1["ms"] = (device_ms(lambda: intersect_bins(bins.tri, *inputs, order=order),
                          "intersect_bins", reps=3)
                or cuda_ms(lambda: intersect_bins(bins.tri, *inputs, order=order), reps=3))
    k1["unsorted_ms"] = (device_ms(lambda: intersect_bins(bins.tri, *inputs), "intersect_bins",
                                   reps=3)
                         or cuda_ms(lambda: intersect_bins(bins.tri, *inputs), reps=3))
    t_best, _ = intersect_bins(bins.tri, *inputs, order=order)
    k1["bound_ms"], k1["bound_by"], k1["visits"] = kernel_bound(inputs, t_best, B)
    k1.update(launches=counts["K1"], blocks=inputs[0].shape[0], plain_blocks=MCL_CHECK_BLOCKS,
              order="count")
    log(f"{label} K1 (count order) on {what} {k1['blocks']} blocks: "
        f"{k1['ms']:.3f} ms ({k1['unsorted_ms']:.3f} ms in block order), bound "
        f"{k1['bound_ms']:.3f} ms ({k1['bound_by']}; {k1['visits']:.0f} bin visits), "
        f"roofline {k1['bound_ms'] / k1['ms']:.2%}; vs plain on {MCL_CHECK_BLOCKS} blocks: "
        f"max_abs_err {k1['max_abs_err']:.3g}, {k1['ref_mismatch']} near-tie winners, plain "
        f"{k1['plain_ms']:.2f} ms")

    blocks = tuple(x.contiguous() for x in inputs[:4])
    part_blocks = tuple(sl(x) for x in blocks)
    back = _cull_args(bins, lambda r: _subblock_bounds(*part_blocks, r), sub_blocks, cs, cb, ch)
    _, _, k3 = check_cull(f"{label} K3", cull_rays, cull_rays_reference,
                          (bins, *part_blocks, sub_blocks, cs, cb, ch), back)
    full = (bins, *blocks, sub_blocks, cs, cb, ch)
    k3_slice_ms = k3["ms"]
    k3["ms"] = device_ms(lambda: cull_rays(*full), "cull_kernel", reps=3) or cuda_ms(
        lambda: cull_rays(*full), reps=3)
    k3["bound_ms"], k3["bound_by"], k3["tests"] = full_cull_bound(
        bins, blocks, sub_blocks, cs, cb, ch, 0)
    k3.update(launches=counts["K3r"], blocks=blocks[0].shape[0], plain_blocks=MCL_CHECK_BLOCKS,
              slice_ms=k3_slice_ms, registers=kernel_registers())
    log(f"{label} K3{' (hyper level)' if ch else ''} on {what} {k3['blocks']} blocks: "
        f"{k3['ms']:.3f} ms by the device trace, bound {k3['bound_ms']:.3f} ms "
        f"({k3['bound_by']}; {k3['tests']:.4g} tests), roofline "
        f"{k3['bound_ms'] / k3['ms']:.2%}; vs plain on {MCL_CHECK_BLOCKS} blocks: lists agree "
        f"({'bitwise' if k3['bitwise'] else str(k3['ties']) + ' tie blocks'}), plain "
        f"{k3['plain_ms']:.2f} ms; registers (regs, local bytes) {k3['registers']}")
    if any(local for _, local in k3["registers"].values()):
        fail(f"{label}: K3 spills: {k3['registers']}")
    return k1, k3


def mcl_update_steps(bins, cloud, beams, tsb, cfg, ev, mark):
    """One binned beam-major sensor update on ``cloud`` through the steps
    that ``sensor_update`` composes, with a CUDA event at each boundary:
    the layout and the rays, K3 (the cull), K1 (in count order), the winner
    gather and the scoring, the fold. Returns the cloud and the cull's
    (blocked rays, kernel inputs, sat, order) for the checks."""
    from rmcl_tpu_torch.mcl.sensor_update import (beam_layout, cluster_poses, fold, score_rc,
                                                  update_rays)
    from rmcl_tpu_torch.ops.raycast import RayHits
    from rmcl_tpu_torch.ops.raycast_binned import _hits_from_winners, _kernel_inputs
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_bins

    layout = beam_layout(cfg, beams)
    tsm, perm_inv = cluster_poses(cloud, tsb, cfg)
    N, Sp = cloud.capacity, layout.dirs.shape[0]
    orig_m, dirs_m, t_m = update_rays(tsm, layout)
    o = orig_m.transpose(0, 1).reshape(-1, 3)
    d = dirs_m.transpose(0, 1).reshape(-1, 3)
    t_max = t_m.transpose(0, 1).reshape(-1)
    t_min = torch.zeros_like(t_max)
    mark("rays")
    inputs, sat = _kernel_inputs(bins, o, d, t_min, t_max, cfg.block_size, cfg.c_super,
                                 cfg.c_bin, cfg.sub_blocks, cfg.c_hyper, cfg.c_mid)
    mark("K3")
    order = torch.argsort(inputs[5], stable=True).to(torch.int32)
    t_best, ref = intersect_bins(bins.tri, *inputs, order=order)
    mark("K1")
    h = _hits_from_winners(bins, o, d, t_max, t_best, ref, "index", False)
    hits = RayHits(**{f: getattr(h, f).reshape((Sp, N) + tuple(getattr(h, f).shape[1:]))
                      .transpose(0, 1) for f in ("t", "hit", "prim_id", "inst_id", "point",
                                                 "normal")})
    error = score_rc(cfg, layout, orig_m, dirs_m, hits)
    mark("gather_score")
    out = fold(cloud, cfg, layout, error, perm_inv)
    mark("fold")
    return out, (inputs, sat, order)


def phase_mcl_cycle():
    """Phase 11a: the full MCL cycle at the JAX MCL benchmark's workload:
    1,048,576 particles x 100 beams, binned beam-major (K3 with the hyper
    level, K1 in count order), four 262,144-particle chunks."""
    import dataclasses

    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.motion import MotionUpdateConfig, motion_update
    from rmcl_tpu_torch.mcl.particles import ParticleCloud
    from rmcl_tpu_torch.mcl.resampling import ResamplerConfig, gladiator_resample
    from rmcl_tpu_torch.mcl.sensor_update import probe_update_rays, sample_beams, sensor_update
    from rmcl_tpu_torch.mcl.stats import estimate_stats
    from rmcl_tpu_torch.ops.order import cluster_order
    from rmcl_tpu_torch.ops.raycast_binned import _resolve_budgets, block_cull_stats

    mmap, model, truth, points, mask, scfg = mcl_world()
    bins = mmap.bins
    tsb = Transform.identity()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cloud = mcl_cloud(truth, MCL_PARTICLES, gen)

    # the budget audit on the first 65,536 particles' update rays
    o_p, d_p, t_p = probe_update_rays(cloud.map(lambda x: x[:MCL_SLICE]), gen, points, mask,
                                      tsb, scfg)
    counts, sat = block_cull_stats(bins, o_p, d_p, t_max=t_p, block_size=scfg.block_size,
                                   c_super=scfg.c_super, c_bin=scfg.c_bin,
                                   sub_blocks=scfg.sub_blocks, c_hyper=scfg.c_hyper)
    audit = dict(sat_frac=float(sat.float().mean()), mean=float(counts.float().mean()),
                 max=int(counts.max()))
    log(f"phase 11a audit: {MCL_SLICE} particles' update rays, candidates a block mean "
        f"{audit['mean']:.1f}, max {audit['max']} (c_bin {scfg.c_bin}); saturated blocks "
        f"{audit['sat_frac']:.4%}")
    del o_p, d_p, t_p

    mcfg, rcfg = MotionUpdateConfig.create(), ResamplerConfig.create()
    scfg_nc = dataclasses.replace(scfg, cluster=False)
    n_chunks = MCL_PARTICLES // MCL_CHUNK
    stages = ("motion", "cluster", "beams", "rays", "K3", "K1", "gather_score", "fold",
              "resample", "stats")

    def cycle(cloud, delta_t, ev=None):
        """One cycle; with ``ev`` (a dict of event lists) the sensor
        update runs through its steps with events between them."""
        marks = []

        def mark(name):
            if ev is not None:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((name, e))

        mark("start")
        cloud = motion_update(cloud, Transform(rot=torch.tensor([1.0, 0, 0, 0], device="cuda"),
                                               trans=delta_t), 0.05, mcfg)
        mark("motion")
        fw = cloud.poses.rotate(torch.tensor([1.0, 0.0, 0.0], device="cuda"))
        order, _ = cluster_order(cloud.poses.trans, fw)
        cloud = cloud.map(lambda x: x[order.long()])
        mark("cluster")
        beams = sample_beams(gen, points, mask, MCL_BEAMS)
        mark("beams")
        parts, first = [], None
        for i in range(n_chunks):
            sub = cloud.map(lambda x: x[i * MCL_CHUNK:(i + 1) * MCL_CHUNK])
            if ev is None:
                parts.append(sensor_update(bins, sub, None, None, None, tsb, scfg_nc,
                                           beams=beams).likelihood)
            else:
                out, cull = mcl_update_steps(bins, sub, beams, tsb, scfg_nc, ev, mark)
                parts.append(out.likelihood)
                first = first or (sub, beams, cull)
        lik = parts[0].__class__(*(torch.cat([getattr(p, f) for p in parts])
                                   for f in ("mean", "sigma", "n_meas")))
        cloud = dataclasses.replace(cloud, likelihood=lik)
        cloud = gladiator_resample(cloud, gen, rcfg)
        mark("resample")
        stats = estimate_stats(cloud, max_induction_particles=50_000)
        mark("stats")
        if ev is not None:
            torch.cuda.synchronize()
            prev = marks[0][1]
            for name, e in marks[1:]:
                ev.setdefault(name, []).append(prev.elapsed_time(e))
                prev = e
        return cloud, stats, first

    rng = np.random.default_rng(0)
    times, errs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for it in range(MCL_CYCLES + 1):
        delta_t = torch.from_numpy(rng.normal(0, 0.002, 3).astype(np.float32)).cuda()
        if it == 1:
            reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        cloud, stats, _ = cycle(cloud, delta_t)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        err = float(torch.linalg.vector_norm(stats.pose.trans - truth.trans))
        errs.append(err)
        if it:
            times.append(dt)
        log(f"phase 11a {'warm' if it == 0 else f'cycle {it}'}: {dt:.1f} ms, estimate error "
            f"{err:.4f} m")
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cycle_ms = statistics.median(times)
    require_launches("phase 11a", counts, ("K1", "K3r"), culls=MCL_CYCLES * n_chunks)
    if counts["K1"] != MCL_CYCLES * n_chunks:
        fail(f"phase 11a: {counts['K1']} K1 launches for {MCL_CYCLES * n_chunks} chunk casts")
    if not errs[-1] < MCL_ERR_MAX:
        fail(f"phase 11a: the estimate is {errs[-1]:.4f} m off the truth (>= {MCL_ERR_MAX})")
    if not bool(torch.isfinite(cloud.likelihood.mean).all()):
        fail("phase 11a: non-finite likelihoods")

    # the same cycle per engine on a copy of the first n particles: at 1M
    # the exact engine (K5) beside the timed binned cycles above, at the
    # 50k cell's count both engines; a warm cycle, then the median of the
    # timed ones
    def engine_cycle_ms(engine, n, reps):
        scfg_e = dataclasses.replace(scfg_nc, engine=engine)
        accel = mmap.bvh if engine == "bvh" else bins
        ms = []
        for _ in range(reps + 1):
            c_b = cloud.map(lambda x: x[:n].clone())
            torch.cuda.synchronize()
            t = time.perf_counter()
            c_b = motion_update(c_b, Transform(rot=torch.tensor([1.0, 0, 0, 0], device="cuda"),
                                               trans=torch.zeros(3, device="cuda")), 0.05, mcfg)
            fw = c_b.poses.rotate(torch.tensor([1.0, 0.0, 0.0], device="cuda"))
            c_b = c_b.map(lambda x: x[cluster_order(c_b.poses.trans, fw)[0].long()])
            beams_b = sample_beams(gen, points, mask, MCL_BEAMS)
            lik = [sensor_update(accel, c_b.map(lambda x: x[i:i + MCL_CHUNK]), None, None, None,
                                 tsb, scfg_e, beams=beams_b).likelihood
                   for i in range(0, n, MCL_CHUNK)]
            c_b = dataclasses.replace(c_b, likelihood=lik[0].__class__(
                *(torch.cat([getattr(p, f) for p in lik]) for f in ("mean", "sigma", "n_meas"))))
            c_b = gladiator_resample(c_b, gen, rcfg)
            estimate_stats(c_b, max_induction_particles=50_000)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms[1:])

    engines_ms = {"bvh 1M": engine_cycle_ms("bvh", MCL_PARTICLES, MCL_CYCLES),
                  "binned 1M": cycle_ms}
    for engine in ("bvh", "binned"):
        engines_ms[f"{engine} 50k"] = engine_cycle_ms(engine, MCL_SMALL, MCL_SMALL_CYCLES)
    log(f"phase 11a the cycle per engine (host clock, median; exact K5, binned K3 + K1 at "
        f"c_super {scfg.c_super}, c_bin {scfg.c_bin}, c_hyper {scfg.c_hyper}): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in engines_ms.items()))
    for size in ("1M", "50k"):
        if not engines_ms[f"bvh {size}"] < engines_ms[f"binned {size}"]:
            fail(f"phase 11a: at {size} particles the exact engine's cycle is not faster than "
                 "the binned one, and MCLNode's engine='auto' takes it on the card")

    # one more cycle through the update's steps, with events between them
    ev = {}
    delta_t = torch.from_numpy(rng.normal(0, 0.002, 3).astype(np.float32)).cuda()
    cloud_i, stats_i, (sub0, beams0, (inputs, sat0, order)) = cycle(cloud, delta_t, ev)
    stage_ms = {k: sum(v) for k, v in ev.items()}
    log(f"phase 11a cycle: median {cycle_ms:.1f} ms of {MCL_CYCLES} (host clock), "
        f"{MCL_PARTICLES / cycle_ms * 1e3:.0f} particles/s, "
        f"{MCL_PARTICLES * MCL_BEAMS / cycle_ms * 1e3:.3g} rays/s; peak memory {peak_gb:.2f} GB; "
        f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    log("phase 11a stages by events (one instrumented cycle, " + f"{sum(stage_ms.values()):.1f}"
        " ms): " + ", ".join(f"{k} {stage_ms[k]:.2f}" for k in stages))
    # the stepped update gives the composed update's likelihoods, bit for bit
    ref = sensor_update(bins, sub0, None, None, None, tsb, scfg_nc, beams=beams0).likelihood
    step_out = mcl_update_steps(bins, sub0, beams0, tsb, scfg_nc, {}, lambda name: None)[0]
    if not torch.equal(step_out.likelihood.mean, ref.mean):
        fail("phase 11a: the stepped update differs from sensor_update")
    del cloud_i, stats_i

    # K1 (count order) and K3 (hyper level) against their plain versions on
    # the first MCL_CHECK_BLOCKS blocks of the first chunk; then each on the
    # whole chunk: device time, bound
    cs, cb, _ = _resolve_budgets(bins, scfg.c_super, scfg.c_bin)
    k1, k3 = check_binned_kernels("phase 11a", "the first chunk's", bins, inputs, order,
                                  scfg.sub_blocks, cs, cb, min(scfg.c_hyper, bins.n_hyper),
                                  counts)
    log(f"phase 11a: {int(sat0.sum())} of {k3['blocks']} blocks saturated")
    return dict(mmap=mmap, model=model, truth=truth, points=points, mask=mask, scfg=scfg,
                cloud=cloud, gen=gen, cycle_ms=cycle_ms, stage_ms=stage_ms, err=errs[-1],
                engines_ms=engines_ms,
                audit=audit, peak_gb=peak_gb, k1=k1, k3=k3, counts=counts)


def phase_mcl_engines(r11):
    """Phase 11b: one sensor update per engine on a 65,536-particle slice of
    11a's cloud with one injected beam set; the mid level against the
    two-level cull; a CP update per engine on 131,072 particles."""
    import dataclasses

    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.sensor_update import (beam_layout, cluster_poses,
                                                  probe_update_rays, sample_beams,
                                                  sensor_update, update_rays)
    from rmcl_tpu_torch.ops.cull_cuda import _packs, cull_rays, cull_rays_reference
    from rmcl_tpu_torch.ops.raycast_binned import (_flat_rays, _pad_rays, _resolve_budgets,
                                                   block_cull_stats, cast_rays_binned)
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    from rmcl_tpu_torch.mcl.node import MCLNode

    mmap, scfg, gen = r11["mmap"], r11["scfg"], r11["gen"]
    bvh, bins = mmap.bvh, mmap.bins
    points, mask = r11["points"], r11["mask"]
    tsb = Transform.identity()
    cloud = r11["cloud"].map(lambda x: x[:MCL_SLICE].contiguous())
    beams = sample_beams(gen, points, mask, MCL_BEAMS)
    # the mid level's comparison: the first rung of MCLNode's budget ladder
    # (then every super and bin) at which the two-level cull truncates no
    # block of these update rays, with the hyper budget raised to cover
    # c_super, and the least mid budget there (from ceil(c_bin / M), the
    # least the engine takes, to every mid of the kept supers) at which the
    # mid level truncates none either
    lay = lambda cfg: probe_update_rays(cloud, None, None, None, tsb, cfg, beams=beams)
    o, d, t_b = lay(scfg)
    M, Sm = bins.bins_per_mid, bins.bins_per_super // bins.bins_per_mid
    sats, mid_budgets = {}, None
    H = bins.supers_per_hyper
    for cs_, cb_ in MCLNode._BUDGET_RUNGS + ((bins.n_super, bins.n_bins),):
        ch_ = max(scfg.c_hyper, -(-cs_ // H))
        kw = dict(block_size=scfg.block_size, c_super=cs_, c_bin=cb_,
                  sub_blocks=scfg.sub_blocks, c_hyper=ch_)
        sats[(cs_, cb_, 0)] = int(block_cull_stats(bins, o, d, t_max=t_b, **kw)[1].sum())
        if sats[(cs_, cb_, 0)]:
            continue
        for c_mid in sorted({-(-cb_ // M), -(-3 * cb_ // (2 * M)), cs_ * Sm}):
            sats[(cs_, cb_, c_mid)] = int(block_cull_stats(bins, o, d, t_max=t_b, c_mid=c_mid,
                                                           **kw)[1].sum())
            if not sats[(cs_, cb_, c_mid)]:
                mid_budgets = (cs_, cb_, ch_, c_mid)
                break
        break
    log(f"phase 11b blocks saturated at (c_super, c_bin, c_mid; 0: two levels): {sats}")
    if mid_budgets is None:
        fail(f"phase 11b: the culls truncate at every budget tried: {sats}")
    cs_, cb_, ch_, c_mid = mid_budgets
    cfgs = {
        "bvh": dataclasses.replace(scfg, engine="bvh"),
        "seeded": dataclasses.replace(scfg, engine="seeded"),
        "binned_particle": dataclasses.replace(scfg, layout="particle"),
        "binned_beam": dataclasses.replace(scfg, c_super=cs_, c_bin=cb_, c_hyper=ch_),
        "binned_beam_mid": dataclasses.replace(scfg, c_super=cs_, c_bin=cb_, c_hyper=ch_,
                                               c_mid=c_mid),
    }
    accel = {"bvh": bvh, "seeded": (bvh, bins)}
    out, ms, counts = {}, {}, {}
    for name, cfg in cfgs.items():
        run = lambda: sensor_update(accel.get(cfg.engine, bins), cloud, None, None, None, tsb,
                                    cfg, beams=beams).likelihood
        run()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = run()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        counts[name] = {k: v for k, v in read_counts().items() if v}
    need = {"bvh": ("K5",), "seeded": ("K3r", "K1", "K5"), "binned_particle": ("K3r", "K1"),
            "binned_beam": ("K3r", "K1"), "binned_beam_mid": ("K3r", "K1")}
    for name, ks in need.items():
        require_launches(f"phase 11b {name}", {**dict.fromkeys(wrappers(), 0), **counts[name]},
                         ks)

    # the seeded pass's certified rays (its particle-major blocks); the
    # binned beam-major run's certified particles: those whose every
    # beam's block no budget truncated
    o_pm, d_pm, t_pm = lay(dataclasses.replace(scfg, layout="particle"))
    _, sat_pm = block_cull_stats(bins, o_pm, d_pm, t_max=t_pm, block_size=scfg.block_size,
                                 c_super=scfg.c_super, c_bin=scfg.c_bin,
                                 sub_blocks=scfg.sub_blocks, c_hyper=scfg.c_hyper)
    del o_pm, d_pm, t_pm
    certified_frac = 1.0 - float(sat_pm.float().mean())
    _, sat_bm = block_cull_stats(bins, o, d, t_max=t_b, block_size=scfg.block_size,
                                 c_super=cs_, c_bin=cb_, sub_blocks=scfg.sub_blocks, c_hyper=ch_)
    _, inv = cluster_poses(cloud, tsb, scfg)
    N = cloud.capacity
    ray_ok = (~sat_bm)[:, None].expand(-1, scfg.block_size).reshape(-1)[:N * MCL_BEAMS]
    cert_particle = ray_ok.reshape(MCL_BEAMS, N).all(0)[inv]
    ref = out["bvh"].mean
    close = lambda a, b, rtol, atol: bool(torch.allclose(a, b, rtol=rtol, atol=atol))
    # the dense and exact engines' triangle tests round apart on rays through
    # a shared edge (ROADMAP.md §3): a particle with such a beam differs
    binned_close = float(torch.isclose(out["binned_beam"].mean[cert_particle],
                                       ref[cert_particle], rtol=1e-4, atol=1e-6).float().mean())
    if not (cert_particle.any() and binned_close >= MCL_BINNED_CLOSE):
        fail(f"phase 11b: the binned engine is off the exact one on certified particles "
             f"({int(cert_particle.sum())} certified, {binned_close:.4%} within rtol 1e-4)")

    # the mid level against the two-level cull, at a budget where neither
    # truncates; K3 with the mid level bitwise its plain version on a slice
    cs, cb, cm = _resolve_budgets(bins, cs_, cb_, c_mid)
    ch = min(ch_, bins.n_hyper)
    if not close(out["binned_beam_mid"].mean, out["binned_beam"].mean, 1e-5, 1e-7):
        fail("phase 11b: the mid level's likelihoods are off the two-level cull's")
    o_r, d_r, tmin_r, tmax_r, _ = _flat_rays(o, d, 0.0, t_b)
    blocks = _pad_rays(o_r, d_r, tmin_r, tmax_r, scfg.block_size)
    part = tuple(x[:MCL_CHECK_BLOCKS].contiguous() for x in blocks)
    args = (bins, *part, scfg.sub_blocks, cs, cb, ch, cm)
    launches = cull_rays.launches
    k = cull_rays(*args)
    p = cull_rays_reference(*args)
    torch.cuda.synchronize()
    if cull_rays.launches != launches + 1:
        fail("phase 11b: K3 with the mid level did not launch")
    if not all(torch.equal(x, y) for x, y in zip(k, p)):
        fail("phase 11b: K3 with the mid level is not bitwise its plain version")
    full = (bins, *(x.contiguous() for x in blocks), scfg.sub_blocks, cs, cb, ch, cm)
    kmid = dict(bitwise=True, max_abs_err=0.0, launches=counts["binned_beam_mid"].get("K3r", 0),
                blocks=blocks[0].shape[0], plain_blocks=MCL_CHECK_BLOCKS, cm=cm,
                mid_packed=_packs(bins.n_mid),
                plain_ms=cuda_ms(lambda: cull_rays_reference(*args), reps=1))
    kmid["ms"] = device_ms(lambda: cull_rays(*full), "cull_kernel", reps=3) or cuda_ms(
        lambda: cull_rays(*full), reps=3)
    kmid["two_level_ms"] = device_ms(lambda: cull_rays(*full[:-1], 0), "cull_kernel",
                                     reps=3) or cuda_ms(lambda: cull_rays(*full[:-1], 0), reps=3)
    kmid["bound_ms"], kmid["bound_by"], kmid["tests"] = full_cull_bound(
        bins, full[1:5], scfg.sub_blocks, cs, cb, ch, cm)
    log(f"phase 11b K3 with the mid level (c_mid {cm}, packed mid keys "
        f"{kmid['mid_packed']}) on {kmid['blocks']} blocks: {kmid['ms']:.3f} ms by the device "
        f"trace ({kmid['two_level_ms']:.3f} ms two-level), bound {kmid['bound_ms']:.3f} ms "
        f"({kmid['bound_by']}; {kmid['tests']:.4g} tests), roofline "
        f"{kmid['bound_ms'] / kmid['ms']:.2%}; bitwise its plain version on "
        f"{MCL_CHECK_BLOCKS} blocks (plain {kmid['plain_ms']:.2f} ms)")

    # K5's refine launch in the seeded pass: the suspect rays, sorted by bound
    scfg_s = cfgs["seeded"]
    layout = beam_layout(scfg_s, beams)
    tsm, inv_s = cluster_poses(cloud, tsb, scfg_s)
    N, Sp = cloud.capacity, layout.dirs.shape[0]
    o_s, d_s, t_s = (x.reshape(-1, *x.shape[2:]).contiguous() for x in update_rays(tsm, layout))
    seed, lossless = cast_rays_binned(bins, o_s, d_s, t_max=t_s, flip_normals=False,
                                      block_size=scfg.block_size, c_super=scfg.c_super,
                                      c_bin=scfg.c_bin, c_hyper=scfg.c_hyper,
                                      sub_blocks=scfg.sub_blocks, with_lossless=True)
    bound = torch.minimum(torch.where(seed.hit, seed.t * (1.0 + 1e-5) + 1e-6, t_s), t_s)
    bound = torch.where(lossless, -1.0, bound)
    srt = torch.argsort(bound, stable=True)
    rays5 = (o_s[srt].contiguous(), d_s[srt].contiguous(), torch.zeros_like(t_s),
             bound[srt].contiguous())
    k5 = check_traverse("phase 11b K5 (seeded refine)", bvh,
                        tuple(x[-EXACT_SLICE:].contiguous() for x in rays5))
    _, slot5, visits = traverse_rays(bvh.nodes, bvh.root_link, *rays5, visits=True)
    k5["ms"] = device_ms(lambda: traverse_rays(bvh.nodes, bvh.root_link, *rays5),
                         "traverse_bvh", reps=3) or cuda_ms(
        lambda: traverse_rays(bvh.nodes, bvh.root_link, *rays5), reps=3)
    k5["bound_ms"], k5["bound_by"], k5["visits"] = traverse_bound(visits, rays5[0].shape[0],
                                                                  k5["slots_read"])
    k5.update(launches=counts["seeded"].get("K5", 0), rays=rays5[0].shape[0],
              suspect=int((~lossless).sum()), plain_rays=EXACT_SLICE)
    # seeded against the exact engine, on the particles whose every ray
    # keeps the exact walk's winner: a ray whose result is the dense
    # engine's (certified, or the fallback) may differ where the two
    # engines' triangle tests round apart (a ray through a shared edge,
    # ROADMAP.md §3)
    slot = torch.empty_like(slot5)
    slot[srt] = slot5
    _, slot_ex = traverse_rays(bvh.nodes, bvh.root_link, o_s, d_s, torch.zeros_like(t_s), t_s)
    prim = lambda sl: torch.where(sl >= 0, bvh.nodes.view(torch.int32)[sl.clamp(min=0).long(),
                                                                       12], -1)
    from_seed = lossless | (seed.hit & (slot < 0))
    seeded_prim = torch.where(from_seed, seed.prim_id, prim(slot))
    fallback = (seeded_prim != prim(slot_ex)).reshape(N, Sp).any(1)[inv_s]
    if float(fallback.float().mean()) > MCL_EDGE_PARTICLES:
        fail(f"phase 11b: {int(fallback.sum())} particles have a ray whose seeded winner is "
             f"not the exact engine's")
    if not close(out["seeded"].mean[~fallback], ref[~fallback], 1e-4, 1e-6):
        fail("phase 11b: the seeded likelihoods are off the exact engine's")
    log(f"phase 11b sensor updates on {MCL_SLICE} particles x {MCL_BEAMS} beams (one beam "
        f"set): " + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f"; seeded: {certified_frac:.4%} of the rays certified by the dense pass (one "
        f"particle's 100 beams a block), likelihoods within rtol 1e-4 of the exact engine's "
        f"but on the {int(fallback.sum())} particles with a ray whose winner differs; "
        f"binned beam-major at c_super {cs_}, c_bin {cb_}: {binned_close:.4%} of its "
        f"{int(cert_particle.sum())} certified particles within rtol 1e-4 of the exact "
        f"engine; at c_super "
        f"{cs}, c_bin {cb}, c_hyper {ch}, c_mid {cm} is within rtol 1e-5 of the two-level "
        f"cull (neither saturates)")
    log(f"phase 11b K5 in the seeded pass: {k5['rays']} rays ({k5['suspect']} suspect) sorted "
        f"by bound, {k5['ms']:.3f} ms, bound {k5['bound_ms']:.3f} ms ({k5['bound_by']}), "
        f"roofline {k5['bound_ms'] / k5['ms']:.2%}; bitwise its plain version on the last "
        f"{EXACT_SLICE} rays (plain {k5['plain_ms']:.1f} ms)")
    del o_s, d_s, t_s, seed, lossless, bound, rays5, visits, slot5, slot, slot_ex

    # CP updates on the tracking cloud: K6 on the BVH, K6b on the bins
    # (candidates in torch ops); the first call checked, then timed warm
    cp_cloud = r11["cloud"].map(lambda x: x[:MCL_CP_PARTICLES].contiguous())
    cp = {}
    for name, acc, k in (("bvh", bvh, "K6"), ("binned", bins, "K6b")):
        cfg = dataclasses.replace(scfg, engine=name, correspondence_type="CP")
        update = lambda: sensor_update(acc, cp_cloud, None, None, None, tsb, cfg,
                                       beams=beams).likelihood
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lik = update()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        require_launches(f"phase 11b CP {name}", read_counts(), (k,))
        if not bool(torch.isfinite(lik.mean).all()):
            fail(f"phase 11b: CP {name} gave non-finite likelihoods")
        cp[name] = (cuda_ms(update, reps=3), lik, first_ms)
    cp_close = float(torch.isclose(cp["binned"][1].mean, cp["bvh"][1].mean, rtol=1e-4,
                                   atol=1e-6).float().mean())
    log(f"phase 11b CP updates on {MCL_CP_PARTICLES} particles x {MCL_BEAMS} beams (warm, "
        f"median of 3; first call): bvh (K6) {cp['bvh'][0]:.1f} ms ({cp['bvh'][2]:.1f}), "
        f"binned (K6b) {cp['binned'][0]:.1f} ms ({cp['binned'][2]:.1f}); {cp_close:.4%} of "
        f"the particles' likelihoods agree within rtol 1e-4")
    return dict(ms=ms, certified_frac=certified_frac, kmid=kmid, k5=k5,
                cp_ms={k: v[0] for k, v in cp.items()})


def phase_mcl_node(r11):
    """Phase 11c: MCLNode end to end at MCLConfig's default 100,000
    particles on 11a's map, ten steps of +0.2 m in x with a scan simulated
    at the truth, twice: engine "auto", which on the card is the exact walk
    for every RC cloud (one K5 launch an update, no K1 or K3, no budget
    audit), and engine "binned" (the budget audit on the first update, then
    K3r and K1 alike on every update, and nothing else)."""
    import dataclasses

    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.node import MCLConfig, MCLNode
    from rmcl_tpu_torch.sensors.simulate import simulate

    mmap, model, truth = r11["mmap"], r11["model"], r11["truth"]
    tsb = Transform.identity()
    out = {}
    for engine in ("auto", "binned"):
        cfg = MCLConfig(n_particles=MCL_NODE_PARTICLES, auto_engine_period=1, seed=MCL_SEED,
                        sensor=dataclasses.replace(r11["scfg"], engine=engine))
        node = MCLNode(mmap, cfg)
        t = time.perf_counter()
        node.warm()
        warm_s = time.perf_counter() - t
        node.initial_pose_guess(truth, torch.diag(torch.tensor(MCL_COV)))
        pose = list(MCL_TRUTH)
        counts = dict.fromkeys(wrappers(), 0)
        for step in range(MCL_NODE_STEPS):
            pose[0] += MCL_NODE_STEP
            true_bm = Transform.from_pose_tuple(pose)
            hits = simulate(mmap.bvh, model, true_bm)
            points = model.polar_to_cartesian(torch.where(hits.hit, hits.t, 0.0))
            if step == 0:  # the odometry's first reading sets its origin
                node.motion_update(Transform.from_pose_tuple(MCL_TRUTH), 0.0)
            node.motion_update(true_bm, 0.1 * (step + 1))
            if step == 1:  # the binned node's audit casts on the first update
                audit_counts = {k: v for k, v in counts.items() if v}
                counts = dict.fromkeys(wrappers(), 0)
            reset_counts()
            node.sensor_update(points, hits.hit, tsb)
            counts = {k: counts[k] + v for k, v in read_counts().items()}
            node.resample()
            err = float(torch.linalg.vector_norm(node.estimate().pose.trans - true_bm.trans))
            sc = node.effective_sensor_config()
            log(f"phase 11c {engine} step {step + 1}: engine {sc.engine}, budgets c_super "
                f"{sc.c_super} c_bin {sc.c_bin} c_mid {sc.c_mid} (audit {node.last_audit}), "
                f"error {err:.4f} m")
            if engine == "auto" and (sc.engine != "bvh" or node.last_audit is not None):
                fail(f"phase 11c: engine 'auto' on the card took {sc.engine} (audit "
                     f"{node.last_audit}) at step {step + 1}, not the exact walk")
        counts = {k: v for k, v in counts.items() if v}
        steps = MCL_NODE_STEPS - 1  # counted from the second update on
        if engine == "auto" and (counts != {"K5": steps} or audit_counts != {"K5": 1}):
            fail(f"phase 11c: {MCL_NODE_STEPS} sensor updates launched {audit_counts} then "
                 f"{counts}, not one K5 each and nothing else")
        if engine == "binned":
            if node.last_audit is None:
                fail("phase 11c: the binned node's budget audit never ran")
            if set(counts) != {"K3r", "K1"} or not counts["K3r"] == counts["K1"] >= steps:
                fail(f"phase 11c: {steps} binned sensor updates after the audit launched "
                     f"{counts}, not K3r and K1 alike, at least once each an update, and "
                     "nothing else")
        log(f"phase 11c MCLNode ({engine}): {cfg.n_particles} particles, {MCL_NODE_STEPS} "
            f"steps, final error {err:.4f} m; kernels built by warm() in {warm_s:.2f} s; "
            f"launches {audit_counts} on the first update, {counts} on the other {steps}; "
            f"StageTimer:\n{node.timer.report()}")
        if not err < MCL_NODE_ERR_MAX:
            fail(f"phase 11c: MCLNode ({engine}) ended {err:.4f} m off the truth "
                 f"(>= {MCL_NODE_ERR_MAX})")
        out[engine] = dict(err=err, engine=node._engine_choice, audit=node.last_audit,
                           counts=counts, first_counts=audit_counts,
                           stage_ms={k: node.timer.mean(k) * 1e3 for k in node.timer.total})
    return out


def phase_exact_reference_size(sphere_mesh, sphere_bins):
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh, walk_split
    from rmcl_tpu_torch.ops.closest_point import (_max_d2, binned_inputs, closest_points,
                                                  closest_points_binned)
    from rmcl_tpu_torch.ops.order import cluster_order
    from rmcl_tpu_torch.ops.raycast import cast_rays, occluded
    from rmcl_tpu_torch.ops.raycast_binned import cast_rays_binned
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays
    from rmcl_tpu_torch.sensors.models import SphericalModel

    t0 = time.perf_counter()
    bvh = build_bvh(sphere_mesh)
    torch.cuda.synchronize()
    log(f"phase 9 map: sphere BVH {bvh.n_slots} slots, {bvh.nbytes() / 1e6:.1f} MB, built in "
        f"{time.perf_counter() - t0:.2f} s")
    model = SphericalModel.vlp16()
    o, d, trans = reference_scan_rays(model)
    n = o.shape[0]
    lim = dict(t_min=model.range.min, t_max=model.range.max)
    cast_rays(bvh, o[:1024], d[:1024], **lim)  # warm-up, not counted
    torch.cuda.synchronize()

    # the main drive: the cast, then the noisy hit points' closest points
    reset_counts()
    t = time.perf_counter()
    hits = cast_rays(bvh, o, d, **lim)
    torch.cuda.synchronize()
    cast_ms = (time.perf_counter() - t) * 1e3
    hit_frac = float(hits.hit.float().mean())
    pts = hits.point[hits.hit]
    noise = np.random.default_rng(QUERY_SEED).normal(0.0, QUERY_NOISE, size=tuple(pts.shape))
    q = (pts + torch.from_numpy(noise.astype(np.float32)).cuda()).contiguous()
    # budgets under which no query block's candidate list is cut: a cut list
    # may give a farther point (the binned engine's budget contract), which
    # the comparison with the exact engine below would count as a fault
    need_s, need_b = cp_budget_need(sphere_bins, q, QUERY_MAX_DIST)
    c_super, c_bin = int(need_s.max()), int(need_b.max())
    log(f"phase 9 closest-point budgets: blocks need at most {c_super} supers and {c_bin} bins "
        f"(mean {float(need_s.float().mean()):.2f}, {float(need_b.float().mean()):.2f}); at the "
        f"defaults 24 and 96, {int(((need_s > 24) | (need_b > 96)).sum())} of {need_s.numel()} "
        f"blocks would be cut")
    t = time.perf_counter()
    cp_bins = closest_points_binned(sphere_bins, q, max_dist=QUERY_MAX_DIST, c_super=c_super,
                                    c_bin=c_bin, block_chunk=QUERY_BLOCK_CHUNK)
    torch.cuda.synchronize()
    bins_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    cp_exact = closest_points(bvh, q, max_dist=QUERY_MAX_DIST)
    torch.cuda.synchronize()
    exact_ms = (time.perf_counter() - t) * 1e3
    # occlusion of 1000 particle moves: from each pose, 0-70 m in a random
    # direction; a segment that ends outside the sphere crosses it
    rng = np.random.default_rng(QUERY_SEED + 1)
    step = rng.normal(size=(N_POSES, 3))
    step *= rng.uniform(0.0, 70.0, (N_POSES, 1)) / np.linalg.norm(step, axis=1, keepdims=True)
    ends = torch.from_numpy((trans + step).astype(np.float32)).cuda()
    blocked = occluded(bvh, torch.from_numpy(trans).cuda(), ends)
    torch.cuda.synchronize()
    counts = read_counts()

    log(f"phase 9 exact cast: {n} rays ({N_POSES} poses x VLP-16) on {int(bvh.n_tris)} tris in "
        f"{cast_ms:.2f} ms, hits {hit_frac:.6f}; closest points of {q.shape[0]} noisy hit points "
        f"(sigma {QUERY_NOISE} m, max_dist {QUERY_MAX_DIST} m): binned {bins_ms:.2f} ms, exact "
        f"{exact_ms:.2f} ms; launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if not hit_frac >= 0.999:
        fail(f"phase 9: only {hit_frac:.6f} of rays hit the sphere")
    for k, want in (("K5", 2), ("K6b", 1), ("K7", 1), ("K6", 1)):  # K5: the cast and occluded
        if counts[k] != want:
            fail(f"phase 9: {k} launched {counts[k]} times ({want} expected)")

    # the dense engine on the same rays: t agrees where both hit
    dense = cast_rays_binned(sphere_bins, o, d, block_size=CAST_BLOCK_SIZE, **lim)
    both = hits.hit & dense.hit
    rel = ((hits.t[both] - dense.t[both]).abs() / dense.t[both]).max()
    log(f"phase 9 exact vs dense: t max relative difference {float(rel):.3g} on {int(both.sum())} "
        f"rays both hit; the dense engine hits {float(dense.hit.float().mean()):.6f}")
    if not float(rel) <= 1e-4:
        fail(f"phase 9: exact and dense t differ by {float(rel)} relative")
    del dense, both
    # the two closest-point engines agree
    f_b, f_e = cp_bins.found, cp_exact.found
    found = f_b & f_e
    diff = (cp_bins.dist[found] - cp_exact.dist[found]).abs()
    tol = QUERY_DIST_RTOL * cp_exact.dist[found] + QUERY_DIST_ATOL
    log(f"phase 9 binned vs exact closest points: found {float(f_e.float().mean()):.6f} (exact), "
        f"{int((f_b != f_e).sum())} found flags differ, dist max difference "
        f"{float(diff.max()):.3g} m, {int((diff > tol).sum())} beyond {QUERY_DIST_RTOL} relative "
        f"+ {QUERY_DIST_ATOL} m")
    if not torch.equal(f_b, f_e) or bool((diff > tol).any()):
        fail("phase 9: the binned and exact closest points disagree")
    r_end = torch.linalg.vector_norm(ends, dim=1)
    outside, inside = r_end > 50.5, r_end < 49.5
    log(f"phase 9 occluded: {int(blocked.sum())} of {N_POSES} moves blocked; {int(outside.sum())} "
        f"end outside the sphere, {int(inside.sum())} inside")
    if not (bool(blocked[outside].all()) and not bool(blocked[inside].any())):
        fail("phase 9: occluded disagrees with the sphere's geometry")
    del cp_bins, cp_exact, hits

    # each kernel against its plain version on a slice; timed on all
    S = EXACT_SLICE
    t_lo = torch.full((n,), model.range.min, device="cuda")
    t_hi = torch.full((n,), model.range.max, device="cuda")
    r5 = check_traverse("phase 9 K5", bvh, (o[:S], d[:S], t_lo[:S], t_hi[:S]))
    _, _, visits = traverse_rays(bvh.nodes, bvh.root_link, o, d, t_lo, t_hi, visits=True)
    r5["ms"] = cuda_ms(lambda: traverse_rays(bvh.nodes, bvh.root_link, o, d, t_lo, t_hi), reps=3)
    # the slots the slice's walks read: a floor for the whole cast's
    r5["bound_ms"], r5["bound_by"], r5["visits"] = traverse_bound(visits, n, r5["slots_read"])
    r5.update(launches=counts["K5"])
    log(exact_line(f"phase 9 K5 ({n} rays; plain version on the first {S})", r5,
                   f"{S} rays"))
    max_d2 = _max_d2(QUERY_MAX_DIST, q.shape[:1], "cuda")
    r6 = check_closest_bvh("phase 9 K6", bvh, q[:S].contiguous(), max_d2[:S])
    P, P_slice = walk_split(q.shape[0], q.device), r6["split"]
    _, _, _, cvis = closest_bvh(bvh.nodes, bvh.root_link, q, max_d2, visits=True)
    r6["ms"] = cuda_ms(lambda: closest_bvh(bvh.nodes, bvh.root_link, q, max_d2), reps=3)
    r6["bound_ms"], r6["bound_by"], r6["visits"] = closest_bvh_bound(cvis, q.shape[0],
                                                                      r6["slots_read"])
    r6["split"] = P
    log(exact_line(f"phase 9 K6 ({q.shape[0]} queries at P={P}; plain version on the first "
                   f"{S} at P={P_slice})", r6, f"{S} queries"))
    budgets = dict(c_super=c_super, c_bin=c_bin, block_chunk=QUERY_BLOCK_CHUNK)
    steps, _ = binned_breakdown(sphere_bins, q, QUERY_MAX_DIST, **budgets)
    log(f"phase 9 binned query by events ({sum(steps.values()):.2f} ms): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items()))
    order, _ = cluster_order(q, None)
    qs = q[order.long()]
    md = _max_d2(QUERY_MAX_DIST, q.shape[:1], "cuda", cap=1.7e19)
    *inputs, sat = binned_inputs(sphere_bins, qs, md, **budgets)
    r6b = check_closest_bins("phase 9 K6b", sphere_bins.tri, inputs,
                             plain_blocks=S // inputs[0].shape[1],
                             division_blocks=S // inputs[0].shape[1])
    log(exact_line(f"phase 9 K6b ({inputs[0].shape[0]} blocks at G={r6b['groups']}; plain "
                   f"version on the first {r6b['plain_queries']} queries)", r6b,
                   f"{r6b['plain_queries']} queries"))
    r7 = check_cp_candidates("phase 9 K7", sphere_bins, inputs[0], inputs[1],
                             min(c_super, sphere_bins.n_super), inputs[2].shape[1],
                             plain_blocks=K7_PLAIN_BLOCKS, path_lists=(*inputs[2:], sat))
    r7.update(launches=counts["K7"],
              inputs_ms=cuda_ms(lambda: binned_inputs(sphere_bins, qs, md, **budgets), reps=3))
    log(k7_line(f"phase 9 K7 ({inputs[0].shape[0]} blocks, cs={min(c_super, sphere_bins.n_super)}, "
                f"cb={inputs[2].shape[1]})", r7)
        + f"; binned_inputs (blocks + K7) {r7['inputs_ms']:.3f} ms a call by events")
    return dict(k5=r5, k6=r6, k6b=r6b, k7=r7, hit_frac=hit_frac, cast_ms=cast_ms,
                bins_ms=bins_ms, exact_ms=exact_ms, binned_steps=steps, bvh=bvh)


def node_log(model, bvh):
    """Phase 12's world: phase 4's building and a VLP-16 driven along the
    arc. Returns the truth's pose tuples and the message logs (every scan
    with its odometry; the first SMALL_SCANS also with their clouds)."""
    from rmcl_tpu_torch.io import msgs
    from rmcl_tpu_torch.io.conversions import model_to_scan_info
    from rmcl_tpu_torch.io.replay import MessageLog
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.sensors.simulate import simulate

    info = model_to_scan_info(model)
    truth, full, small = [], MessageLog(), MessageLog()
    x0, y0, z0 = NODE_START
    for k in range(NODE_SCANS):
        a = k / (NODE_SCANS - 1)  # 1 rad of arc: 2 m at radius 2 m
        pose = [x0 + NODE_RADIUS * np.sin(a), y0 + NODE_RADIUS * (1 - np.cos(a)), z0, 0.0, 0.0, a]
        true = Transform.from_pose_tuple(pose)
        drift = Transform.from_pose_tuple([NODE_DRIFT[0] * k, 0.0, 0.0, 0.0, 0.0,
                                           NODE_DRIFT[1] * k])
        tbo = drift @ true
        hits = simulate(bvh, model, true)
        ranges = torch.where(hits.hit, hits.t, 0.0).cpu().numpy()
        mask = hits.hit.cpu().numpy()
        stamp = 0.1 * k
        scan = msgs.ScanStamped(msgs.Header(stamp), info, msgs.RangeData(ranges=ranges, mask=mask))
        for log in (full, small) if k < SMALL_SCANS else (full,):
            log.add_odometry(stamp, tbo)
            log.add(stamp, "scan", "lidar", scan)
        if k < SMALL_SCANS:
            points = torch.where(hits.hit[:, None], hits.point, float("nan")).cpu().numpy()
            small.add(stamp, "cloud", "lidar", {"points": points, "mask": mask})
        truth.append(pose)
    return truth, full, small


def run_cli(name, main, args):
    """A tool's main(args) with its standard output captured (and logged);
    fails unless it returns 0. Returns the output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"{name} | {line}")
    if rc != 0:
        fail(f"{name}: exit {rc}")
    return out


def phase_node_and_tools():
    import os

    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.geom.mesh import make_building_scene, save_obj
    from rmcl_tpu_torch.micp.node import MICPLocalization
    from rmcl_tpu_torch.ops import closest_point
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.tools import map_segmentation, micp_localization, rmcl_localization

    os.makedirs(NODE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    mesh = make_building_scene(subdiv=BUILDING_SUBDIV)
    map_path = os.path.join(NODE_DIR, "building.obj")
    save_obj(mesh, map_path)
    model = SphericalModel.vlp16()
    truth, full, small = node_log(model, build_bvh(mesh))
    log_path, small_path = os.path.join(NODE_DIR, "run.npz"), os.path.join(NODE_DIR, "small.npz")
    full.save(log_path)
    small.save(small_path)
    log(f"phase 12 files: {map_path} ({mesh.n_faces} faces), {log_path} ({NODE_SCANS} scans x "
        f"{model.n_rays} rays, a {NODE_RADIUS:.0f} m radius arc of 1 rad), {small_path} "
        f"({SMALL_SCANS} scans with clouds), written in {time.perf_counter() - t0:.2f} s")
    guess = [f"{v:.6f}" for v in truth[0]]
    runs = {}
    variants = (("rc", "RC, engine auto (binned)", None, ("K3r", "K1")),
                ("cp", "CP on the bins", "sensors:\n  lidar:\n    correspondences:\n"
                                          "      type: CP\n", ("K7", "K6b")),
                ("bvh", "RC, engine bvh", "engine: bvh\n", ("K5",)))
    for key, label, cfg, kernels in variants:
        args = ["--device", "cuda", "--map", map_path, "--log", log_path, "--steps-per-scan",
                str(NODE_STEPS_PER_SCAN), "--out", os.path.join(NODE_DIR, f"track_{key}.npz"),
                "--initial-pose-guess", *guess]
        if cfg is not None:
            with open(os.path.join(NODE_DIR, f"{key}.yaml"), "w") as f:
                f.write(cfg)
            args += ["--config", os.path.join(NODE_DIR, f"{key}.yaml")]
        # each correction timed on the host clock after a synchronize; the
        # CP run's last K7 inputs recorded (a launch through the wrapper)
        times, recorded = [], {}
        step, cp_candidates = MICPLocalization.step, closest_point.cp_candidates

        def timed_step(self):
            t = time.perf_counter()
            out = step(self)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return out

        def recording(*a):
            recorded["args"] = a
            return cp_candidates(*a)

        MICPLocalization.step, closest_point.cp_candidates = timed_step, recording
        reset_counts()
        t = time.perf_counter()
        try:
            out = run_cli(f"phase 12 micp_localization [{key}]", micp_localization.main, args)
        finally:
            MICPLocalization.step, closest_point.cp_candidates = step, cp_candidates
        wall = time.perf_counter() - t
        counts = read_counts()
        track = np.load(os.path.join(NODE_DIR, f"track_{key}.npz"))
        err = float(np.linalg.norm(track["trans"][-1] - np.float32(truth[-1][:3])))
        adopted = "auto-adopting" in out
        runs[key] = dict(ms=statistics.median(times), min_ms=min(times), err=err,
                         corrections=len(times), launches={k: v for k, v in counts.items() if v},
                         adopted=adopted, wall_s=wall)
        log(f"phase 12 {label}: {len(times)} corrections ({NODE_SCANS} scans x "
            f"{NODE_STEPS_PER_SCAN}), median {runs[key]['ms']:.3f} ms/correction (min "
            f"{min(times):.3f}; host clock after a synchronize), last pose {err:.3e} m from the "
            f"truth, poses {track['trans'].shape[0]}, audit adopted {adopted}, launches "
            + ", ".join(f"{k} {v}" for k, v in runs[key]["launches"].items())
            + f"; the CLI run {wall:.1f} s (map load included)")
        if not (err <= NODE_ERR_MAX and np.isfinite(track["trans"]).all()):
            fail(f"phase 12 {label}: the last pose is {err} m from the truth")
        if track["trans"].shape[0] != NODE_SCANS:
            fail(f"phase 12 {label}: {track['trans'].shape[0]} poses for {NODE_SCANS} scans")
        for k in kernels:
            if counts[k] < 1:
                fail(f"phase 12 {label}: the run never launched {k}")
        if key != "bvh" and not adopted:
            fail(f"phase 12 {label}: the budget audit adopted no budgets")
        if key == "cp":
            bins, qb, d2b, cs, cb = recorded["args"][:5]
            r7 = check_cp_candidates("phase 12 K7", bins, qb, d2b, cs, cb)
            r7.update(launches=counts["K7"], correction_ms=runs[key]["ms"])
            log(k7_line(f"phase 12 K7 on the CP run's last {qb.shape[0]} blocks (cs={cs}, "
                        f"cb={cb})", r7))
            # the node's own CP audit set (cs, cb) from each block's need
            # (utils/tune.py): which block needs most, and the padded last one's
            need_s, need_b = cp_block_need(bins, qb, d2b)
            widest = int(torch.argmax(need_b))
            last = qb.shape[0] - 1
            padded = model.n_rays % qb.shape[1] != 0
            runs[key].update(cs=cs, cb=cb, need_super=int(need_s.max()),
                             need_bin=int(need_b.max()), widest_block=widest,
                             widest_is_padded=padded and widest == last)
            log(f"phase 12 CP audit: adopted cs={cs}, cb={cb}; the widest block is {widest} of "
                f"{qb.shape[0]} ({int(need_s[widest])} supers, {int(need_b[widest])} bins; the "
                f"most supers a block needs {int(need_s.max())}), the last block "
                f"{'padded' if padded else 'whole'}: {int(need_s[last])} supers, "
                f"{int(need_b[last])} bins; {r7['saturated']} blocks truncated")
            if r7["saturated"]:
                fail(f"phase 12 {label}: the audited budgets truncate {r7['saturated']} blocks")
            # K6b on the same lists: what the adopted budgets cost it, and
            # the candidates each block visits (slot < count, bound <= the
            # block's final worst key), which its one CTA walks in turn
            lists = cp_candidates(bins, qb, d2b, cs, cb)[:3]
            k6b = lambda: closest_bins(bins.tri, qb, d2b, *lists)
            k6b_ms = device_ms(k6b, "closest_bins")
            runs[key]["k6b_ms"] = k6b_ms if k6b_ms is not None else cuda_ms(k6b)
            jmask = bins.bin_size - 1
            worst = (k6b()[0].amax(dim=1) | jmask).view(torch.float32)[:, None]
            slot = torch.arange(cb, device=qb.device)[None, :]
            visits = ((slot < lists[1][:, None]) & (lists[2] <= worst)).sum(dim=1)
            top = torch.topk(visits, 3).values.tolist()
            log(f"phase 12 K6b on the same blocks: {runs[key]['k6b_ms']:.4f} ms "
                f"({'device trace' if k6b_ms is not None else 'events'}); candidates visited a "
                f"block: mean {float(visits.float().mean()):.1f}, the three most {top}")

    # the other tools on the log's first scans, at a small size
    reset_counts()
    seg_out = os.path.join(NODE_DIR, "segmentation.npz")
    run_cli("phase 12 map_segmentation", map_segmentation.main,
            ["--device", "cuda", "--map", map_path, "--log", small_path, "--pose", *guess,
             "--out", seg_out])
    seg = np.load(seg_out)
    seg_counts = read_counts()
    outliers = int(seg["s0_scan_outlier"].sum() + seg["s0_map_outlier"].sum())
    if int(seg["n_scans"]) != SMALL_SCANS or outliers or seg_counts["K5"] < SMALL_SCANS:
        fail(f"phase 12 map_segmentation: {int(seg['n_scans'])} scans, {outliers} outliers in "
             f"the scan rendered from its own pose, K5 launched {seg_counts['K5']} times")
    with open(os.path.join(NODE_DIR, "rmcl.yaml"), "w") as f:
        f.write(f"max_particles: {SMALL_PARTICLES}\n")
    reset_counts()
    rmcl_out = os.path.join(NODE_DIR, "track_rmcl.npz")
    run_cli("phase 12 rmcl_localization", rmcl_localization.main,
            ["--device", "cuda", "--map", map_path, "--log", small_path, "--config",
             os.path.join(NODE_DIR, "rmcl.yaml"), "--initial-pose", *guess, "--out", rmcl_out])
    rmcl = np.load(rmcl_out)
    rmcl_counts = read_counts()
    rmcl_err = float(np.linalg.norm(rmcl["trans"][-1] - np.float32(truth[SMALL_SCANS - 1][:3])))
    log(f"phase 12 small runs: map_segmentation {int(seg['n_scans'])} scans (first scan "
        f"{outliers} outliers), launches K5 {seg_counts['K5']}; rmcl_localization "
        f"{SMALL_PARTICLES} particles, {rmcl['trans'].shape[0]} estimates, last {rmcl_err:.3f} m "
        f"from the truth, launches " + ", ".join(f"{k} {v}" for k, v in rmcl_counts.items() if v))
    if (rmcl["trans"].shape[0] != SMALL_SCANS or not np.isfinite(rmcl["trans"]).all()
            or rmcl_err > SMALL_ERR_MAX or not any(rmcl_counts.values())):
        fail(f"phase 12 rmcl_localization: {rmcl['trans'].shape[0]} estimates, last "
             f"{rmcl_err} m from the truth")
    return dict(runs=runs, k7=r7, rmcl_err=rmcl_err)


def groups_bound(inputs, t_best, B, G):
    """Least time for K2g's work on these inputs: per visited candidate
    (slot < count and tnear <= the block's final worst t_best), its live
    rays' pairs at OPS_PER_GROUP_PAIR, its B x G (triangle, group) terms
    at OPS_PER_GROUP_TERM and its B triangles at OPS_PER_GROUP_TRI, against
    K1's bytes (the same reads and writes)."""
    ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear = inputs
    slot = torch.arange(cand_bin.shape[1], device=ob.device)[None, :]
    worst = t_best.amax(dim=1, keepdim=True)
    visits = ((slot < cand_count[:, None]) & (cand_tnear <= worst)).sum(dim=1).to(torch.float64)
    live = (t_max_b > t_min_b).sum(dim=1).to(torch.float64)
    n_rays = ob.shape[0] * ob.shape[1]
    bytes_moved = (float(visits.sum()) * (9 * B * 4 + 8) + n_rays * 8 * 4 + n_rays * 8
                   + cand_count.numel() * 4)
    ops = float((visits * live).sum()) * B * OPS_PER_GROUP_PAIR \
        + float(visits.sum()) * B * (G * OPS_PER_GROUP_TERM + OPS_PER_GROUP_TRI)
    return bound_of(bytes_moved, ops) + (float(visits.sum()),)


@contextlib.contextmanager
def recorded(module, name):
    """Within the block, every call of ``module.name`` passes through and is
    recorded: yields the list of (args, kwargs)."""
    fn, calls = getattr(module, name), []

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def dense_cast(bins, sweep, rays, **kw):
    """The library's dense cast of a sweep's rays through K2g
    (``cast_rays_binned`` with the sweep's ``dir_groups``, launch order
    sorted, ``DENSE_C_BIN``; ``kw`` for the rest). Returns (its hits, the
    calls of K2g's wrapper it made as (args, kwargs))."""
    from rmcl_tpu_torch.ops import raycast_binned

    with recorded(raycast_binned, "intersect_groups") as calls:
        hits = raycast_binned.cast_rays_binned(
            bins, *rays, block_size=sweep.block_size, dir_groups=sweep.dir_groups,
            c_bin=DENSE_C_BIN, sort_blocks=True, **kw)
    return hits, calls


def slice_blocks(inputs, blocks):
    """The kernel's inputs restricted to the given blocks (a launch-order
    prefix), contiguous."""
    return tuple(x[blocks].contiguous() for x in inputs)


def check_groups(name, tri, inputs, G):
    """K2g against its plain version on the same CUDA tensors: bitwise, or
    the run fails. Returns the kernel's outputs."""
    from rmcl_tpu_torch.ops.raycast_cuda import intersect_groups, intersect_groups_reference

    launches = intersect_groups.launches
    kt, kref = intersect_groups(tri, *inputs, G)
    pt, pref = intersect_groups_reference(tri, *inputs, G)
    torch.cuda.synchronize()
    if intersect_groups.launches != launches + 1:
        fail(f"{name}: K2g did not launch")
    if not (torch.equal(kt, pt) and torch.equal(kref, pref)):
        fail(f"{name}: K2g and its plain version disagree ({int((kt != pt).sum())} t, "
             f"{int((kref != pref).sum())} winners)")
    return kt, kref


def phase_groups_and_sah(sweep_r, main_r):
    """Phase 13: K2g at full width against its plain version and against K1,
    and the SAH BVH on phase 4's building."""
    from rmcl_tpu_torch.bvh.builder import build_bvh, build_bvh_sah
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    from rmcl_tpu_torch.ops.raycast import cast_rays
    from rmcl_tpu_torch.ops.raycast_binned import TiledSweep, cast_rays_binned
    from rmcl_tpu_torch.ops.raycast_cuda import (intersect_bins, intersect_groups,
                                                 intersect_groups_reference, kernel_registers,
                                                 winner_t)

    regs = kernel_registers()
    log("phase 13 K1 and K2g as built (registers, local bytes a thread): "
        + ", ".join(f"{k} {r} regs {b} B" for k, (r, b) in regs.items()))
    if any(b for _, b in regs.values()):
        fail("phase 13: K1 or K2g spills to local memory")

    # (a) the library's dense cast with dir_groups (K3r + K2g) at full width on
    # phase 7's sweep rays at its base estimate, against the same cast through
    # K1; K2g's inputs and launch order are the ones that cast's cull made
    bench = sweep_r["bench"]
    bins, sweep, trans, dirs = bench.bins, bench.sweep, bench.trans_true, bench.dirs
    G, B = sweep.dir_groups, bins.bin_size
    rays = sweep.rays(sweep_r["est0"], dirs)
    reset_counts()
    (hits, lossless), calls = dense_cast(bins, sweep, rays, with_lossless=True)
    torch.cuda.synchronize()
    counts = read_counts()
    require_launches("phase 13 dense cast", counts, ("K3r", "K2g"), culls=1)
    if counts["K2g"] != 1 or counts["K1"] or counts["K4"] or len(calls) != 1:
        fail(f"phase 13: the dense cast launched K2g {counts['K2g']}, K1 {counts['K1']}, "
             f"K4 {counts['K4']} times")
    k2g = dict(launches=counts["K2g"])
    (_, *inputs, _), order = calls[0][0], calls[0][1]["order"]
    hits_1 = cast_rays_binned(bins, *rays, block_size=sweep.block_size, c_bin=DENSE_C_BIN,
                              sort_blocks=True)
    hit_diff, both = int((hits.hit != hits_1.hit).sum()), hits.hit & hits_1.hit
    cast_rel = float(((hits.t - hits_1.t).abs() / hits_1.t.abs())[both].max())
    if not (hit_diff <= DENSE_HIT_DIFF * sweep.n_rays and cast_rel <= 1e-4):
        fail(f"phase 13: the dense cast through K2g and through K1 differ ({hit_diff} hits, "
             f"t {cast_rel:.3g} relative)")
    log(f"phase 13 dense cast (cast_rays_binned, dir_groups={G}, c_bin {DENSE_C_BIN}): "
        f"{sweep.n_rays} sweep rays at phase 7's base estimate in {inputs[0].shape[0]} blocks of "
        f"{G} groups x {sweep.pt} poses, launches K3r {counts['K3r']}, K2g {counts['K2g']}; "
        f"candidates mean {float(inputs[5].float().mean()):.2f}, max {int(inputs[5].max())}; "
        f"{float((~lossless).float().mean()):.4%} of the rays in truncated blocks; hits "
        f"{float(hits.hit.float().mean()):.6f}; against the cast through K1: {hit_diff} hits "
        f"differ, t within "
        f"{cast_rel:.3g} relative, {int((hits.prim_id != hits_1.prim_id).sum())} other winners")
    del hits, hits_1, lossless, rays
    launch_g = lambda: intersect_groups(bins.tri, *inputs, G, order=order)
    launch_1 = lambda: intersect_bins(bins.tri, *inputs, order=order)
    kt, kref = launch_g()

    def timed(launch, kernel):
        """(ms, by what): the device trace's, or events around one call
        where the trace holds none (these launches take tens of ms, so
        the host's part of a call is small)"""
        trace = device_ms(launch, kernel)
        return (trace, "device trace") if trace else (cuda_ms(launch), "events")

    k2g["call_ms"] = cuda_ms(launch_g)
    k2g["ms"], k2g["timed_by"] = timed(launch_g, "intersect_groups")
    k2g["k1_ms"], k1_by = timed(launch_1, "intersect_bins")
    k2g["bound_ms"], k2g["bound_by"], k2g["visits"] = groups_bound(inputs, kt, B, G)
    log(f"phase 13 K2g ({inputs[0].shape[0]} blocks of {inputs[0].shape[1]} rays, B={B}, G={G}, "
        f"cb={inputs[4].shape[1]}): kernel {k2g['ms']:.3f} ms by the {k2g['timed_by']} "
        f"({k2g['call_ms']:.3f} ms a call by events), bound {k2g['bound_ms']:.3f} ms "
        f"({k2g['bound_by']}; {k2g['visits']:.0f} bin visits), roofline "
        f"{k2g['bound_ms'] / k2g['ms']:.2%}; K1 on the same rays and candidates "
        f"{k2g['k1_ms']:.3f} ms by the {k1_by} ({k2g['k1_ms'] / k2g['ms']:.2f}x)")

    # K2g bitwise its plain version on the first blocks in launch order, and
    # against K1 on them
    blocks = order[:DENSE_CHECK_BLOCKS].long()
    part = slice_blocks(inputs, blocks)
    gt, gref = check_groups("phase 13 K2g", bins.tri, part, G)
    torch.cuda.synchronize()
    t = time.perf_counter()
    intersect_groups_reference(bins.tri, *part, G)
    torch.cuda.synchronize()
    k2g.update(plain_ms=(time.perf_counter() - t) * 1e3, plain_blocks=len(blocks),
               max_abs_err=0.0, registers=regs["K2g"][0])
    if not torch.equal(kt[blocks], gt) or not torch.equal(kref[blocks], gref):
        fail("phase 13: K2g on a slice differs from K2g on every block")
    t1, ref1 = intersect_bins(bins.tri, *part)
    hit_g, hit_1 = gref >= 0, ref1 >= 0
    if not torch.equal(hit_g, hit_1):
        fail(f"phase 13: K2g and K1 hit different rays ({int((hit_g != hit_1).sum())})")
    rel = ((gt - t1).abs() / t1.abs())[hit_g]
    mis = gref != ref1
    # a different winner only at a near-tie: K1's t for K2g's triangle
    tie_t = winner_t(bins.tri, part[0][mis], part[1][mis], part[2][mis], gref[mis])
    bad_tie = int(((tie_t.double() - t1[mis].double()).abs() > 1e-4 * t1[mis].double().abs()).sum())
    if not (float(rel.max()) <= 1e-4 and bad_tie == 0):
        fail(f"phase 13: K2g and K1 disagree (t {float(rel.max()):.3g} relative, {bad_tie} "
             f"winners off a near-tie)")
    k2g.update(k1_t_rel=float(rel.max()), k1_other_winners=int(mis.sum()))
    log(f"phase 13 K2g = plain version bitwise on the first {len(blocks)} blocks in launch order "
        f"(plain {k2g['plain_ms']:.1f} ms, one run); against K1 on them: hits equal, t within "
        f"{k2g['k1_t_rel']:.3g} relative, {k2g['k1_other_winners']} other winners, all near-ties")
    small = []
    for tiles in ((32, 1, 1), (16, 2, 2)):
        sw = TiledSweep(bench.trans_true_np[:64], bench.model.width, bench.model.height, *tiles)
        s_in = dense_cast(bins, sw, sw.rays(trans[:64], dirs))[1][0][0][1:-1]
        check_groups(f"phase 13 K2g G={sw.dir_groups}", bins.tri, s_in, sw.dir_groups)
        small.append(f"G={sw.dir_groups} ({s_in[0].shape[0]} blocks of {sw.block_size})")
    log(f"phase 13 K2g = plain version bitwise also at {' and '.join(small)}")
    del inputs, order, part, kt, kref

    # (b) the SAH BVH of phase 4's building, against the LBVH on phase 4's scan
    mesh = make_building_scene(subdiv=BUILDING_SUBDIV)
    t = time.perf_counter()
    lbvh = build_bvh(mesh, device="cuda")
    torch.cuda.synchronize()
    lbvh_s = time.perf_counter() - t
    t = time.perf_counter()
    sah = build_bvh_sah(mesh, device="cuda")
    torch.cuda.synchronize()
    sah_s = time.perf_counter() - t
    o_s, d_s = main_r["model"].rays("cuda")
    pose = main_r["true_pose"]
    n = o_s.shape[0]
    lim = (torch.full((n,), main_r["model"].range.min, device="cuda"),
           torch.full((n,), main_r["model"].range.max, device="cuda"))
    rays = (pose.apply(o_s).contiguous(), pose.rotate(d_s).contiguous(), *lim)
    reset_counts()
    h_sah = cast_rays(sah, rays[0], rays[1], t_min=lim[0], t_max=lim[1])
    torch.cuda.synchronize()
    if read_counts()["K5"] != 1:
        fail("phase 13: the cast on the SAH BVH did not launch K5 once")
    h_lbvh = cast_rays(lbvh, rays[0], rays[1], t_min=lim[0], t_max=lim[1])
    r5 = check_traverse("phase 13 K5 (SAH)", sah, rays, device_timed=True)
    r5l = check_traverse("phase 13 K5 (LBVH)", lbvh, rays, device_timed=True)
    diff = int((h_sah.hit != h_lbvh.hit).sum())
    both = h_sah.hit & h_lbvh.hit
    t_rel = float(((h_sah.t - h_lbvh.t).abs() / h_lbvh.t.abs())[both].max())
    sah_r = dict(build_s=sah_s, lbvh_build_s=lbvh_s, slots=sah.n_slots, lbvh_slots=lbvh.n_slots,
                 visits=r5["visits"], lbvh_visits=r5l["visits"], hit_diff=diff, t_rel=t_rel,
                 ms=r5["ms"], lbvh_ms=r5l["ms"], timed_by=r5["timed_by"])
    log(f"phase 13 SAH BVH of the building ({mesh.n_faces} faces): built in {sah_s:.2f} s (LBVH "
        f"{lbvh_s:.2f} s), {sah.n_slots} slots (LBVH {lbvh.n_slots}); on phase 4's scan K5 visits "
        f"{r5['visits']:.0f} (LBVH {r5l['visits']:.0f}) in {r5['ms']:.4f} ms (LBVH "
        f"{r5l['ms']:.4f} ms), by the {r5['timed_by']} (LBVH: {r5l['timed_by']}); "
        + exact_line("K5 on the SAH BVH", r5, "")
        + f"; hits against the LBVH cast: {diff} rays differ, t within {t_rel:.3g} relative")
    if not (diff <= SAH_HIT_DIFF * n and t_rel <= 1e-4):
        fail(f"phase 13: the SAH BVH's hits are off the LBVH's ({diff} rays, t {t_rel})")
    return dict(k2g=k2g, sah=sah_r)


def host_ms(fn, reps=BW_REPS, prepare=None):
    """Median milliseconds of fn(*prepare()) over reps runs by the host
    clock, each ending in torch.cuda.synchronize() (after one warm-up run);
    ``prepare`` makes each run's inputs outside the timed region."""
    times = []
    for it in range(reps + 1):
        args = prepare() if prepare else ()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        if it:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sub_row(r, **extra):
    """A kernel's numbers at one more phase, for its row of the kernels
    line."""
    keys = ("ms", "timed_by", "bound_ms", "bound_by", "launches", "plain_ms", "max_abs_err",
            "blocks", "plain_blocks")
    return dict({k: r[k] for k in keys if k in r}, roofline=r["bound_ms"] / r["ms"], **extra)


def fd_check(name, what, autograd, fd, tol):
    """Central differences against autograd, |fd - g| <= rtol |g| + atol
    (``atol`` one for all, or one a coordinate)."""
    rtol, atol = tol
    atol = list(atol) if isinstance(atol, (list, tuple)) else [atol] * len(fd)
    bad = [(a, f) for a, f, t in zip(autograd, fd, atol) if abs(f - a) > rtol * abs(a) + t]
    log(f"{name} central differences (eps {FD_EPS}) on {what}: autograd "
        + ", ".join(f"{a:.5g}" for a in autograd) + "; differences "
        + ", ".join(f"{f:.5g}" for f in fd) + f" (within {rtol:g} relative + "
        + ", ".join(f"{t:.3g}" for t in sorted(set(atol))) + ")")
    if bad:
        fail(f"{name}: central differences disagree with autograd on {what}: {bad}")


def phase_backward(sphere_mesh):
    """Phase 14a: ``cast_rays_diff`` at the JAX backward benchmark's workload
    (scripts/bench_backward.py): the loss (sum of hit t) and its gradients
    with respect to the 100 pose translations and to the vertices on the
    binned engine (K3 + K1 in count order), at the benchmark's budgets and
    at budgets audited until no block saturates; at the latter also on the
    exact engine (K5), with central differences and K1 and K3 against their
    plain versions."""
    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.bvh.builder import build_bvh
    from rmcl_tpu_torch.ops.diff import cast_rays_diff
    from rmcl_tpu_torch.ops.raycast import NO_HIT_T, _map_hits
    from rmcl_tpu_torch.ops.raycast_binned import (_flat_rays, _kernel_inputs, _resolve_budgets,
                                                   block_cull_stats, cast_rays_binned)
    from rmcl_tpu_torch.sensors.models import SphericalModel

    t0 = time.perf_counter()
    bins = build_bins(sphere_mesh, bin_size=64, bins_per_super=16, supers_per_hyper=16)
    torch.cuda.synchronize()
    bins_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = build_bvh(sphere_mesh)
    torch.cuda.synchronize()
    bvh_s = time.perf_counter() - t0
    verts0 = torch.from_numpy(sphere_mesh.vertices).cuda()
    faces = torch.from_numpy(sphere_mesh.faces).cuda()
    model = SphericalModel.vlp16(width=900)
    _, dirs = model.rays("cuda")
    nd = model.n_rays
    rng = np.random.default_rng(0)
    trans0 = torch.from_numpy(rng.uniform(-5, 5, (BW_POSES, 3)).astype(np.float32)).cuda()
    n = BW_POSES * nd
    log(f"phase 14a map: sphere {sphere_mesh.n_faces} faces, {sphere_mesh.n_vertices} vertices; "
        f"bins {bins.n_bins} of 64 in {bins.n_super} supers of 16, {bins.n_hyper} hypers of 16 "
        f"({bin_order_note()}), built in {bins_s:.2f} s; BVH {bvh.n_slots} slots in {bvh_s:.2f} s; "
        f"{n} rays ({BW_POSES} poses x VLP-16 of {model.width} columns)")

    def rays(trans, poses=slice(None)):
        t = trans[poses]
        o = t[:, None, :].expand(t.shape[0], nd, 3).reshape(-1, 3)
        return o, dirs[None].expand(t.shape[0], nd, 3).reshape(-1, 3)

    def loss(struct, kw, trans, verts, poses=slice(None)):
        h = cast_rays_diff(struct, verts, faces, *rays(trans, poses), **kw)
        return torch.where(h.hit, h.t, 0.0).sum(), h

    def fwd(struct, kw, trans):
        with torch.no_grad():
            return loss(struct, kw, trans, verts0)

    def bwd_pose(struct, kw, trans):
        tr = trans.clone().requires_grad_(True)
        value, h = loss(struct, kw, tr, verts0)
        value.backward()
        return value, h, tr.grad

    def bwd_verts(struct, kw, trans):
        v = verts0.clone().requires_grad_(True)
        value, h = loss(struct, kw, trans, v)
        value.backward()
        return value, h, v.grad

    o, d = rays(trans0)
    jitter = lambda: (trans0 + torch.from_numpy(
        rng.uniform(-0.02, 0.02, (BW_POSES, 3)).astype(np.float32)).cuda(),)

    def drive(label, kw, with_bvh):
        """Each program once (its launches, the values, the gradients), then
        timed on fresh jitters as the JAX benchmark draws them."""
        programs = [("fwd", fwd, bins), ("fwd+bwd_pose", bwd_pose, bins),
                    ("fwd+bwd_verts", bwd_verts, bins)]
        if with_bvh:
            programs.append(("fwd+bwd_verts_bvh", bwd_verts, bvh))
        out, launches = {}, {}
        for key, fn, struct in programs:
            skw = kw if struct is bins else {}
            fn(struct, skw, trans0)  # warm-up: first-call allocations
            torch.cuda.synchronize()
            reset_counts()
            out[key] = fn(struct, skw, trans0)
            torch.cuda.synchronize()
            launches[key] = {k: v for k, v in read_counts().items() if v}
            want = {"K5": 1} if struct is bvh else {"K3r": 1, "K1": 1}
            if launches[key] != want:
                fail(f"phase 14a {label} {key}: launched {launches[key]}, not {want}")
        value, h = out["fwd"]
        with torch.no_grad():
            own = cast_rays_binned(bins, o, d, **kw)
        hit_frac = float(h.hit.float().mean())
        t_rel = float(((h.t - own.t).abs() / own.t.abs())[h.hit].max())
        if not (torch.equal(h.hit, own.hit) and torch.equal(h.prim_id, own.prim_id)
                and t_rel <= T_RTOL):
            fail(f"phase 14a {label}: cast_rays_diff is off cast_rays_binned ({t_rel:.3g} in t)")
        grads = {"translations": out["fwd+bwd_pose"][2], "vertices": out["fwd+bwd_verts"][2]}
        if with_bvh:
            grads["vertices (bvh)"] = out["fwd+bwd_verts_bvh"][2]
        for name, g in grads.items():
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
                fail(f"phase 14a {label}: the gradient over the {name} is not finite and nonzero")
        ms = {key: host_ms(lambda tr, fn=fn, struct=struct: fn(
            struct, kw if struct is bins else {}, tr), prepare=jitter)
              for key, fn, struct in programs}
        log(f"phase 14a {label} {kw}: loss {float(value):.6g}, hits {hit_frac:.6f}, t within "
            f"{t_rel:.3g} relative of cast_rays_binned's (winners equal); programs (median of "
            f"{BW_REPS}, host clock): "
            + ", ".join(f"{k} {v:.3f} ms ({n / v * 1e3:.4g} rays/s)" for k, v in ms.items())
            + f"; fwd+bwd / fwd: pose {ms['fwd+bwd_pose'] / ms['fwd']:.3f}, vertices "
            f"{ms['fwd+bwd_verts'] / ms['fwd']:.3f}; launches a call "
            + "; ".join(f"{k} " + ", ".join(f"{a} {b}" for a, b in v.items())
                        for k, v in launches.items()))
        return dict(ms=ms, hit_frac=hit_frac, t_rel=t_rel, launches=launches, out=out)

    # the benchmark's own budgets; they truncate most blocks' lists, so most
    # rays miss (the JAX package's cast misses the same rays on the CPU, as
    # CHANGES.md records)
    bench = drive("at the benchmark's budgets", BW_CAST, False)
    del bench["out"]
    # the budgets doubled until no block saturates
    cs, cb, ch = BW_CAST["c_super"], BW_CAST["c_bin"], BW_CAST["c_hyper"]
    for _ in range(SCENE_AUDIT_ROUNDS):
        sat = block_cull_stats(bins, o, d, block_size=BW_CAST["block_size"], c_super=cs,
                               c_bin=cb, c_hyper=ch)[1]
        log(f"phase 14a audit at c_super {cs}, c_bin {cb}, c_hyper {ch}: {int(sat.sum())} of "
            f"{sat.shape[0]} blocks saturated")
        if not bool(sat.any()):
            break
        cs, cb, ch = 2 * cs, 2 * cb, 2 * ch
    else:
        fail(f"phase 14a: blocks still saturate at c_super {cs}, c_bin {cb}, c_hyper {ch}")
    kw = dict(BW_CAST, c_super=cs, c_bin=cb, c_hyper=ch)
    r = drive("at the audited budgets", kw, True)
    if not r["hit_frac"] >= HIT_AGREE:
        fail(f"phase 14a: only {r['hit_frac']:.6f} of the rays hit at budgets no block saturates")
    out = r.pop("out")
    h_v, h_b = (_map_hits(torch.Tensor.detach, out[k][1])
                for k in ("fwd+bwd_verts", "fwd+bwd_verts_bvh"))
    g_verts, g_verts_b = out["fwd+bwd_verts"][2], out["fwd+bwd_verts_bvh"][2]
    both = h_v.hit & h_b.hit
    agree = float((h_v.hit == h_b.hit).float().mean())
    bvh_rel = float(((h_b.t - h_v.t).abs() / h_v.t.abs())[both].max())
    g_rel = float((g_verts_b - g_verts).abs().max() / g_verts.abs().max())
    log(f"phase 14a the exact engine (K5) against the binned one: hits agree on {agree:.6f} of "
        f"rays, t within {bvh_rel:.3g} relative where both hit, its vertex gradient {g_rel:.3g} "
        f"of the largest entry off the binned one's")
    if not (agree >= HIT_AGREE and bvh_rel <= BVH_T_RTOL):
        fail(f"phase 14a: the exact engine's cast is off the binned one's ({agree}, {bvh_rel})")

    # central differences: the 5 largest-gradient translation coordinates,
    # each on its pose's rays (those that hit at all three translations),
    # and the 5 largest-gradient vertex coordinates of pose 0's loss (the
    # winners come from the baked bins, so the same rays hit)
    g_trans = out["fwd+bwd_pose"][2]
    auto, fd = [], []
    for i in torch.topk(g_trans.abs().reshape(-1), 5).indices.tolist():
        p, axis = divmod(i, 3)
        step = torch.zeros_like(trans0)
        step[p, axis] = FD_EPS
        with torch.no_grad():
            _, hp = loss(bins, kw, trans0 + step, verts0, slice(p, p + 1))
            _, hm = loss(bins, kw, trans0 - step, verts0, slice(p, p + 1))
        tr = trans0.clone().requires_grad_(True)
        _, h0 = loss(bins, kw, tr, verts0, slice(p, p + 1))
        mask = h0.hit & hp.hit & hm.hit
        torch.where(mask, h0.t, 0.0).sum().backward()
        auto.append(float(tr.grad[p, axis]))
        fd.append(float((hp.t.double() - hm.t.double())[mask].sum()) / (2 * FD_EPS))
    fd_check("phase 14a", "the 5 largest-gradient translation coordinates", auto, fd,
             FD_TRANS_TOL)
    v = verts0.clone().requires_grad_(True)
    value0, h0 = loss(bins, kw, trans0, v, slice(0, 1))
    value0.backward()
    auto, fd = [], []
    for i in torch.topk(v.grad.abs().reshape(-1), 5).indices.tolist():
        step = torch.zeros_like(verts0).reshape(-1)
        step[i] = FD_EPS
        step = step.reshape(verts0.shape)
        with torch.no_grad():
            _, hp = loss(bins, kw, trans0, verts0 + step, slice(0, 1))
            _, hm = loss(bins, kw, trans0, verts0 - step, slice(0, 1))
        auto.append(float(v.grad.reshape(-1)[i]))
        fd.append(float((hp.t.double() - hm.t.double())[h0.hit].sum()) / (2 * FD_EPS))
    fd_check("phase 14a", "the 5 largest-gradient vertex coordinates (pose 0's rays)", auto, fd,
             FD_VERT_TOL)
    del out, h_v, h_b, g_verts, g_verts_b, g_trans

    # K1 and K3 on the audited cast's inputs: against their plain versions, timed
    fo, fd_, fmin, fmax, _ = _flat_rays(o, d, 0.0, NO_HIT_T)
    inputs, _ = _kernel_inputs(bins, fo, fd_, fmin, fmax, kw["block_size"], cs, cb, 4, ch)
    order = torch.argsort(inputs[5], stable=True).to(torch.int32)
    rcs, rcb, _ = _resolve_budgets(bins, cs, cb)
    k1, k3 = check_binned_kernels("phase 14a", "the audited backward cast's", bins, inputs,
                                  order, 4, rcs, rcb, min(ch, bins.n_hyper), {"K1": 1, "K3r": 1})
    return dict(r, bench=bench, budgets=(cs, cb, ch), bvh_agree=agree, bvh_t_rel=bvh_rel,
                k1=k1, k3=k3, bins=bins)


def phase14_scene(building):
    """Phase 14b's scene graph: the building as one instance at identity, 8
    balls and 16 unit boxes (every second one at a scale != 1) placed in
    its rooms from SCENE_SEED, each with a yaw."""
    from rmcl_tpu_torch.geom.mesh import make_box, make_sphere
    from rmcl_tpu_torch.geom.scene import SceneGraph
    from rmcl_tpu_torch.math.se3 import Transform

    rng = np.random.default_rng(SCENE_SEED)
    sg = SceneGraph()
    sg.add_geometry("building", building)
    sg.add_geometry("ball", make_sphere(128, 128, radius=0.5))
    sg.add_geometry("box", make_box())
    sg.add_instance("building", Transform.identity(), name="building")

    def in_a_room():
        ix, iy = rng.integers(0, 4), rng.integers(0, 3)
        return ix * 6.0 + rng.uniform(1.0, 5.0), iy * 6.0 + rng.uniform(1.0, 5.0)

    for k in range(SCENE_BALLS):
        x, y = in_a_room()
        pose = [x, y, rng.uniform(0.6, 2.2), 0.0, 0.0, rng.uniform(-np.pi, np.pi)]
        sg.add_instance("ball", Transform.from_pose_tuple(pose), name=f"ball{k}")
    for k in range(SCENE_BOXES):
        x, y = in_a_room()
        scale = 1.0 if k % 2 == 0 else float(rng.uniform(0.4, 1.6))
        pose = [x, y, scale / 2, 0.0, 0.0, rng.uniform(-np.pi, np.pi)]
        sg.add_instance("box", Transform.from_pose_tuple(pose), scale=scale, name=f"box{k}")
    return sg


def scene_rays(model, n_poses, seed):
    """n_poses VLP-16 poses uniform over phase 4's floor at MCL_Z with a
    yaw; (o, d) flattened, pose-major."""
    from rmcl_tpu_torch.math.se3 import Transform

    rng = np.random.default_rng(seed)
    pose = np.zeros((n_poses, 6), np.float32)
    pose[:, :2] = rng.uniform((0.0, 0.0), MCL_FLOOR, (n_poses, 2))
    pose[:, 2] = MCL_Z
    pose[:, 5] = rng.uniform(-np.pi, np.pi, n_poses)
    tsm = Transform.from_pose_tuple(torch.from_numpy(pose).cuda()).expand_dims(-1)
    o_s, d_s = model.rays("cuda")
    return (tsm.apply(o_s).reshape(-1, 3).contiguous(),
            tsm.rotate(d_s).reshape(-1, 3).contiguous())


def world_triangles(sg, acc):
    """The flattened scene's world triangles (float64, on the card) and
    each instance's first face in them: a hit's face is first[inst] +
    prim."""
    tri = torch.from_numpy(acc.world_mesh.triangles().astype(np.float64)).cuda()
    faces = np.cumsum([0] + [sg.geometries[i.geometry].n_faces for i in sg.instances[:-1]])
    return tri, torch.from_numpy(faces).cuda()


def edge_margin(tri, first, h, o, d):
    """Per ray of ``h``: where it crosses its winner's world triangle,
    min(u, v, 1 - u - v) in float64 (inf where it missed), and the float32
    rounding of that triangle in the same units: the spacing at its largest
    coordinate over its shortest edge. A ray within a few roundings of an
    edge is decided by rounding, and the engines' edge tests (ROADMAP.md §3)
    may decide it apart."""
    g = first[h.inst_id.clamp(min=0).long()] + h.prim_id.clamp(min=0).long()
    v = tri[g]
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    o64, d64 = o.double(), d.double()
    p = torch.linalg.cross(d64, e2, dim=-1)
    det = (e1 * p).sum(-1)
    s = o64 - v0
    u = (s * p).sum(-1) / det
    w = (d64 * torch.linalg.cross(s, e1, dim=-1)).sum(-1) / det
    margin = torch.minimum(torch.minimum(u, w), 1.0 - u - w)
    shortest = torch.stack([e1.norm(dim=-1), e2.norm(dim=-1), (v[:, 2] - v[:, 1]).norm(dim=-1)],
                           -1).amin(-1)
    big = v.abs().amax(dim=(1, 2)).float()
    spacing = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big).double()
    return torch.where(h.hit, margin, float("inf")), spacing / shortest


def face_bin(bins, n_faces, first=None):
    """The bin holding each face of ``bins``: faces are the prim ids, or
    first[inst] + prim with ``first`` (the flattened scene's faces)."""
    prim = bins.tri[:, 12, :].reshape(-1).long()
    face = prim if first is None else first[bins.tri[:, 13, :].reshape(-1).long()] + prim
    keep = prim >= 0  # padding slots hold -1
    out = torch.full((n_faces,), -1, dtype=torch.long, device=prim.device)
    out[face[keep]] = torch.nonzero(keep).squeeze(1) // bins.bin_size
    return out


def listed(inputs, rays, bin_ids):
    """Whether the block of each ray of ``rays`` lists the bin ``bin_ids``
    (one a ray; -1 never) among its candidates (``inputs``:
    ``_kernel_inputs``'): each block's list sorted, every ray's bin looked
    up in its own block's row (no list is copied a ray)."""
    cand, count = inputs[4], inputs[5]
    n_blk, Rb = inputs[0].shape[:2]
    slot = torch.arange(cand.shape[1], device=cand.device)
    keys = torch.sort(torch.where(slot[None] < count[:, None], cand, 2**31 - 1), dim=1).values
    want = torch.full((n_blk * Rb,), -1, dtype=keys.dtype, device=keys.device)
    want[rays] = bin_ids.to(keys.dtype)
    want = want.view(n_blk, Rb)
    at = torch.searchsorted(keys, want).clamp(max=keys.shape[1] - 1)
    return (keys.gather(1, at) == want).view(-1)[rays]


def tlas_saturation(tlas, bins, o, d, lim, cs, cb):
    """Saturated blocks at budgets (cs, cb): each TLAS instance's cull of the
    rays in its frame at the cast's own t_max (the chained bound only
    shrinks each list, so no chained list saturates where this one does
    not), and the flattened bins' cull."""
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats

    kw = dict(block_size=DEFAULT_BLOCK_SIZE, c_super=cs, c_bin=cb, **lim)
    sat_tlas = 0
    for i, g in enumerate(tlas.inst_geom):
        inv = Transform(rot=tlas.poses.rot[i], trans=tlas.poses.trans[i]).inverse()
        s = tlas.scales[i]
        sat_tlas += int(block_cull_stats(tlas.geom_bins[g], inv.apply(o) / s, inv.rotate(d) / s,
                                         **kw)[1].sum())
    return sat_tlas, int(block_cull_stats(bins, o, d, **kw)[1].sum())


def phase_scene_graph():
    """Phase 14b: a scene graph at a building's size: the TLAS cast (K3 +
    K1, one chained cast an instance) against the flattened scene's exact
    cast (K5) and binned cast (K3 + K1) at audited budgets; the TLAS closest
    points (K6 an instance) against the flattened BVH's; the gradient with
    respect to one ball's pose against central differences; and
    refine_instance_pose (K5) recovering a misplaced ball."""
    import dataclasses

    from rmcl_tpu_torch.geom.mesh import make_building_scene
    from rmcl_tpu_torch.geom.scene import refine_instance_pose
    from rmcl_tpu_torch.geom.tlas import build_tlas, cast_rays_tlas, closest_points_tlas
    from rmcl_tpu_torch.math.se3 import Quaternion, Transform
    from rmcl_tpu_torch.ops.closest_cuda import closest_bvh
    from rmcl_tpu_torch.ops.closest_point import _max_d2, closest_points
    from rmcl_tpu_torch.ops.raycast import cast_rays
    from rmcl_tpu_torch.ops.raycast_binned import _kernel_inputs, cast_rays_binned
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays
    from rmcl_tpu_torch.sensors.models import SphericalModel

    building = make_building_scene(subdiv=BUILDING_SUBDIV)
    sg = phase14_scene(building)
    t0 = time.perf_counter()
    acc = sg.build(**SCENE_BIN)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tlas = build_tlas(sg, **SCENE_BIN)
    torch.cuda.synchronize()
    tlas_s = time.perf_counter() - t0
    model = SphericalModel.vlp16()
    o, d = scene_rays(model, BW_POSES, SCENE_SEED)
    n = o.shape[0]
    lim = dict(t_min=model.range.min, t_max=model.range.max)
    log(f"phase 14b scene: {tlas.n_instances} instances ({SCENE_BALLS} balls of "
        f"{sg.geometries['ball'].n_faces} faces, {SCENE_BOXES} boxes, half at scale != 1: "
        f"{[round(float(x), 3) for x in tlas.scales[1 + SCENE_BALLS:]]}), flattened "
        f"{acc.world_mesh.n_faces} faces (BVH {acc.bvh.n_slots} slots, {acc.bins.n_bins} bins) "
        f"built in {flat_s:.2f} s; TLAS of {len(tlas.geom_bins)} geometries built in "
        f"{tlas_s:.2f} s; {n} rays ({BW_POSES} VLP-16 poses on the floor at {MCL_Z} m)")

    # the budget audit: double both budgets until no block saturates
    cs, cb = SCENE_BUDGETS
    for _ in range(SCENE_AUDIT_ROUNDS):
        sat_t, sat_f = tlas_saturation(tlas, acc.bins, o, d, lim, cs, cb)
        log(f"phase 14b audit at c_super {cs}, c_bin {cb}: {sat_t} TLAS instance blocks and "
            f"{sat_f} flattened blocks saturated")
        if not (sat_t or sat_f):
            break
        cs, cb = 2 * cs, 2 * cb
    else:
        fail(f"phase 14b: blocks still saturate at c_super {cs}, c_bin {cb}")
    kw = dict(block_size=DEFAULT_BLOCK_SIZE, c_super=cs, c_bin=cb, sort_blocks=True, **lim)

    # the TLAS cast, the flattened casts
    cast_rays_tlas(tlas, o[:1024], d[:1024], **kw)  # warm-up
    reset_counts()
    ht = cast_rays_tlas(tlas, o, d, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    require_launches("phase 14b TLAS cast", counts, ("K3r", "K1"), culls=tlas.n_instances)
    if counts["K1"] != tlas.n_instances:
        fail(f"phase 14b: the TLAS cast launched K1 {counts['K1']} times")
    reset_counts()
    hf = cast_rays(acc.bvh, o, d, **lim)
    hb = cast_rays_binned(acc.bins, o, d, **kw)
    torch.cuda.synchronize()
    fcounts = read_counts()
    require_launches("phase 14b flattened casts", fcounts, ("K5", "K3r", "K1"), culls=1)

    tri, first_face = world_triangles(sg, acc)
    m_f, s_f = edge_margin(tri, first_face, hf, o, d)
    # the candidate lists the dense casts cull at their own (unchained)
    # bound: the flattened bins', and each TLAS instance's on demand (a
    # chained bound only shortens them)
    t_lo = torch.full((n,), model.range.min, device="cuda")
    t_hi = torch.full((n,), model.range.max, device="cuda")
    bw = DEFAULT_BLOCK_SIZE
    flat_lists = _kernel_inputs(acc.bins, o, d, t_lo, t_hi, bw, cs, cb, 4)[0]
    flat_bin = face_bin(acc.bins, tri.shape[0], first_face)

    def tlas_lists(i):
        g = tlas.inst_geom[i]
        inv = tlas.poses[i].inverse()
        s = tlas.scales[i]
        inputs = _kernel_inputs(tlas.geom_bins[g], inv.apply(o) / s, inv.rotate(d) / s, t_lo,
                                t_hi, bw, cs, cb, 4)[0]
        fb = face_bin(tlas.geom_bins[g], sg.geometries[g].n_faces)
        return inputs, lambda prim: fb[prim]

    def flat_of(i):
        return flat_lists, lambda prim: flat_bin[first_face[i] + prim]

    def held(name, h, lists, launches):
        """``h`` against the flattened exact cast: the same triangle with t
        within SCENE_T_RTOL plus the float32 rounding of a world-frame t
        at its incidence, normals within SCENE_NORMAL_TOL plus the world
        triangle's rounding, another triangle only at a near-tie, and a
        ray the two decide apart (one hit, another triangle farther away)
        only within EDGE_SCALES roundings of an edge of either winner; on
        at most 1 - HIT_AGREE of the rays. Every ray the exact cast hits
        finds its winner's bin in its block's list (the cull keeps flat wall
        bins); a ray whose winner's bin is missing fails the phase, named."""
        both = h.hit & hf.hit
        rel = (h.t - hf.t).abs() / hf.t.abs()
        same = both & (h.inst_id == hf.inst_id) & (h.prim_id == hf.prim_id)
        cos = (hf.normal * d).sum(-1).abs().clamp(min=1e-12)
        t_tol = SCENE_T_RTOL + GRAZE_ULPS * 2.0 ** -23 * (o.norm(dim=-1) + hf.t) / (hf.t * cos)
        t_bad = int((same & (rel > t_tol)).sum())
        tie = both & ~same & (rel <= SCENE_T_RTOL)
        apart = (h.hit != hf.hit) | (both & ~same & ~tie)
        m_h, s_h = edge_margin(tri, first_face, h, o, d)
        edge = ((m_h.abs() <= EDGE_SCALES * s_h + EDGE_SLACK)
                | (m_f.abs() <= EDGE_SCALES * s_f + EDGE_SLACK))
        missing = torch.zeros_like(apart)
        rays = torch.nonzero(hf.hit).squeeze(1)
        for i in hf.inst_id[rays].unique().tolist():
            r = rays[hf.inst_id[rays] == i]
            inputs, bin_of = lists(i)
            missing[r] = ~listed(inputs, r, bin_of(hf.prim_id[r].long()))
        missing_named = torch.nonzero(missing).squeeze(1).tolist()
        unexplained = int((apart & ~edge).sum())
        n_err = (h.normal - hf.normal).abs().amax(-1)
        n_bad = int((same & (n_err > SCENE_NORMAL_TOL + EDGE_SCALES * s_f)).sum())
        agree = float((h.hit == hf.hit).float().mean())
        log(f"phase 14b {name} against the flattened exact cast: hits agree on {agree:.6f}; on "
            f"the same triangle ({int(same.sum())} rays) t within {float(rel[same].max()):.3g} "
            f"relative ({t_bad} beyond {SCENE_T_RTOL} + the rounding at their incidence), "
            f"normals within {float(n_err[same].max()):.3g} ({n_bad} beyond "
            f"{SCENE_NORMAL_TOL} + {EDGE_SCALES} roundings); {int(tie.sum())} other winners at "
            f"near-ties; {int(apart.sum())} rays decided apart: {int((apart & edge).sum())} at "
            f"an edge, {unexplained} not; {len(missing_named)} rays whose exact winner's bin is "
            f"missing from their block's list {missing_named[:20]}; launches (both casts) "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        if missing_named:
            fail(f"phase 14b: the {name}'s lists leave out the exact winner's bin of rays "
                 f"{missing_named[:20]}")
        if not (agree >= HIT_AGREE and int(apart.sum()) <= (1 - HIT_AGREE) * n
                and unexplained == 0 and t_bad == 0 and n_bad == 0):
            fail(f"phase 14b: the {name} is off the flattened exact cast")
        return dict(agree=agree, t_rel=float(rel[same].max()), ties=int(tie.sum()),
                    apart=int(apart.sum()), at_edge=int((apart & edge).sum()),
                    winner_bin_missing=len(missing_named),
                    normal_err=float(n_err[same].max()))

    tlas_vs = held("TLAS cast", ht, tlas_lists, counts)
    flat_vs = held("flattened binned cast", hb, flat_of, fcounts)
    del flat_lists
    hit_frac = float(ht.hit.float().mean())

    # closest points of the TLAS hit points moved by N(0, QUERY_NOISE)
    pts = ht.point[ht.hit]
    noise = np.random.default_rng(QUERY_SEED).normal(0.0, QUERY_NOISE, size=tuple(pts.shape))
    q = (pts + torch.from_numpy(noise.astype(np.float32)).cuda()).contiguous()
    reset_counts()
    ct, ci = closest_points_tlas(tlas, q, max_dist=QUERY_MAX_DIST)
    torch.cuda.synchronize()
    ccounts = read_counts()
    if ccounts["K6"] != tlas.n_instances:
        fail(f"phase 14b: closest_points_tlas launched K6 {ccounts['K6']} times")
    cf = closest_points(acc.bvh, q, max_dist=QUERY_MAX_DIST)
    slot = closest_bvh(acc.bvh.nodes, acc.bvh.root_link, q,
                       _max_d2(QUERY_MAX_DIST, q.shape[:1], "cuda"))[2]
    f_inst = torch.where(slot >= 0, acc.bvh.nodes.view(torch.int32)[slot.clamp(min=0).long(), 14],
                         -1)
    found = ct.found & cf.found
    diff = (ct.dist - cf.dist).abs()
    tol = QUERY_DIST_RTOL * cf.dist + QUERY_DIST_ATOL
    other_inst = found & (ci != f_inst)
    log(f"phase 14b closest points of {q.shape[0]} noisy TLAS hit points (max_dist "
        f"{QUERY_MAX_DIST} m): found {float(cf.found.float().mean()):.6f}, "
        f"{int((ct.found != cf.found).sum())} found flags differ, distances within "
        f"{float(diff[found].max()):.3g} m ({int((diff[found] > tol[found]).sum())} beyond "
        f"{QUERY_DIST_RTOL} relative + {QUERY_DIST_ATOL} m), {int(other_inst.sum())} other "
        f"instances (near-ties); launches K6 {ccounts['K6']}")
    if not torch.equal(ct.found, cf.found) or bool((diff[found] > tol[found]).any()):
        fail("phase 14b: closest_points_tlas disagrees with the flattened BVH's")

    # the gradient with respect to the 6 pose parameters of one ball, and of
    # one scaled box (whose rotation the ranges see; a ball's they barely do),
    # each on the pose whose rays hit it most
    def most_hit(instances):
        per = torch.stack([(ht.inst_id.reshape(BW_POSES, -1) == i).sum(1) for i in instances])
        k, p = divmod(int(torch.argmax(per)), BW_POSES)
        return instances[k], p

    def pose_gradient(inst, p):
        sl = slice(p * model.n_rays, (p + 1) * model.n_rays)

        def cast_at(delta):
            rot, trans = tlas.poses.rot, tlas.poses.trans
            r_i = Quaternion.mul(Quaternion.exp(delta[3:]), rot[inst])
            poses = Transform(rot=torch.cat([rot[:inst], r_i[None], rot[inst + 1:]]),
                              trans=torch.cat([trans[:inst], (trans[inst] + delta[:3])[None],
                                               trans[inst + 1:]]))
            return cast_rays_tlas(tlas, o[sl], d[sl], poses=poses, **kw)

        zero = torch.zeros(6, device="cuda")
        with torch.no_grad():
            h_pm = [(cast_at(zero + FD_EPS * e), cast_at(zero - FD_EPS * e))
                    for e in torch.eye(6, device="cuda")]
        delta = zero.clone().requires_grad_(True)
        reset_counts()
        h0 = cast_at(delta)
        # the rays that hit the same triangle of the instance at all 13
        # poses: there t is smooth, so the differences see the derivative
        # that autograd takes with the winners frozen (a ray whose winner
        # moves to the next facet within eps adds a kink)
        mask = h0.hit & (h0.inst_id == inst)
        for hp, hm in h_pm:
            for h in (hp, hm):
                mask &= h.hit & (h.inst_id == inst) & (h.prim_id == h0.prim_id)
        torch.where(mask, h0.t, 0.0).sum().backward()
        counts = read_counts()
        auto = delta.grad.tolist()
        fd = [float((hp.t.double() - hm.t.double())[mask].sum()) / (2 * FD_EPS)
              for hp, hm in h_pm]
        # the differences also carry the float32 rounding of the rays'
        # origin in the instance frame (R^-1 o - R^-1 t: both terms as long
        # as the origin is far from the world's zero), one shift common to
        # the pose's rays at each perturbation: up to 4 spacings at |o|
        # times the translation gradient, over 2 eps
        spacing = float(np.spacing(np.float32(float(o[sl].abs().max()))))
        atol_o = 4 * spacing * sum(abs(x) for x in auto[:3]) / (2 * FD_EPS)
        name = sg.instances[inst].name
        log(f"phase 14b pose gradient of {name} (instance {inst}, scale "
            f"{sg.instances[inst].scale:.3f}): {int(mask.sum())} rays of pose {p} hit the same "
            f"triangle of it at every perturbation; launches K3 {counts['K3r']}, K1 "
            f"{counts['K1']}")
        rtol, atol = SCENE_FD_TOL
        fd_check("phase 14b", f"{name}'s (tx, ty, tz, rx, ry, rz)", auto, fd,
                 (rtol, atol + atol_o))
        return dict(name=name, rays=int(mask.sum()), autograd=auto, fd=fd, atol=atol + atol_o,
                    launches=counts)

    ball, p = most_hit(list(range(1, 1 + SCENE_BALLS)))
    grads = [pose_gradient(ball, p)]
    box, p_box = most_hit([i for i in range(1 + SCENE_BALLS, tlas.n_instances)
                           if sg.instances[i].scale != 1.0])
    grads.append(pose_gradient(box, p_box))
    gcounts = grads[0]["launches"]

    # refine_instance_pose: the ball misplaced, one VLP-16 scan facing it
    true_t = tlas.poses.trans[ball]
    centre = torch.tensor([3.0 + 6.0 * (float(true_t[0]) // 6.0),
                           3.0 + 6.0 * (float(true_t[1]) // 6.0)], device="cuda")
    toward = centre - true_t[:2]
    toward = toward / torch.clamp(torch.linalg.vector_norm(toward), min=1e-6)
    spot = true_t[:2] + REFINE_RANGE * toward
    yaw = float(torch.atan2(-toward[1], -toward[0]))
    sensor = Transform.from_pose_tuple([float(spot[0]), float(spot[1]), float(true_t[2]), 0.0,
                                        0.0, yaw])
    o_s, d_s = model.rays("cuda")
    o_r, d_r = sensor.apply(o_s), sensor.rotate(d_s)
    truth = cast_rays(acc.bvh, o_r, d_r, **lim)
    meas = torch.where(truth.inst_id == ball, truth.t, 3.0e38)
    est = sg.instances[ball].pose
    est = Transform(rot=est.rot, trans=est.trans - torch.tensor(REFINE_OFFSET, device="cuda"))
    sg_est = dataclasses.replace(sg, instances=list(sg.instances))
    sg_est.instances[ball] = dataclasses.replace(sg.instances[ball], pose=est)
    acc_est = sg_est.build(**SCENE_BIN)
    reset_counts()
    delta_pose, losses = refine_instance_pose(acc_est, ball, o_r, d_r, meas, steps=REFINE_STEPS)
    torch.cuda.synchronize()
    rcounts = read_counts()
    refined = (delta_pose @ est).trans
    err = float(torch.linalg.vector_norm(refined - true_t))
    log(f"phase 14b refine_instance_pose: ball {ball} misplaced by {REFINE_OFFSET} m, "
        f"{int((meas < 1e30).sum())} of the scan's rays see it; losses "
        + ", ".join(f"{x:.4g}" for x in losses.tolist())
        + f"; the refined centre {err:.4g} m from the truth after {REFINE_STEPS} steps; "
        f"launches K5 {rcounts['K5']}")
    if rcounts["K5"] != REFINE_STEPS:
        fail(f"phase 14b: refine_instance_pose launched K5 {rcounts['K5']} times")
    if not (err <= REFINE_TOL and float(losses[-1]) < 0.1 * float(losses[0])):
        fail(f"phase 14b: refine_instance_pose ended {err} m off, losses {losses.tolist()}")

    # times: each call against its flattened counterpart
    ms = dict(
        tlas_cast=host_ms(lambda: cast_rays_tlas(tlas, o, d, **kw)),
        flat_binned=host_ms(lambda: cast_rays_binned(acc.bins, o, d, **kw)),
        flat_exact=host_ms(lambda: cast_rays(acc.bvh, o, d, **lim)),
        tlas_closest=host_ms(lambda: closest_points_tlas(tlas, q, max_dist=QUERY_MAX_DIST)),
        flat_closest=host_ms(lambda: closest_points(acc.bvh, q, max_dist=QUERY_MAX_DIST)),
        refine_step=host_ms(lambda: refine_instance_pose(acc_est, ball, o_r, d_r, meas, steps=1)),
        refine_8=host_ms(lambda: refine_instance_pose(acc_est, ball, o_r, d_r, meas,
                                                      steps=REFINE_STEPS), reps=3))
    log("phase 14b times (median, host clock): " + ", ".join(f"{k} {v:.3f} ms"
                                                            for k, v in ms.items())
        + f"; TLAS / flattened binned {ms['tlas_cast'] / ms['flat_binned']:.2f}, TLAS / "
        f"flattened exact {ms['tlas_cast'] / ms['flat_exact']:.2f}, closest points TLAS / "
        f"flattened {ms['tlas_closest'] / ms['flat_closest']:.2f}")

    # K5 on the flattened exact cast, K6 on the building instance's query:
    # against their plain versions on a slice, timed on all by the device trace
    S = EXACT_SLICE
    r5 = check_traverse("phase 14b K5", acc.bvh, (o[:S], d[:S], t_lo[:S], t_hi[:S]))
    _, _, visits = traverse_rays(acc.bvh.nodes, acc.bvh.root_link, o, d, t_lo, t_hi, visits=True)
    launch5 = lambda: traverse_rays(acc.bvh.nodes, acc.bvh.root_link, o, d, t_lo, t_hi)
    r5["ms"], r5["timed_by"] = device_ms(launch5, "traverse_bvh"), "device trace"
    if r5["ms"] is None:
        r5["ms"], r5["timed_by"] = cuda_ms(launch5, reps=3), "events"
    r5["bound_ms"], r5["bound_by"], r5["visits"] = traverse_bound(visits, n, r5["slots_read"])
    r5.update(launches=fcounts["K5"])
    log(exact_line(f"phase 14b K5 ({n} rays on the flattened scene, by the {r5['timed_by']}; "
                   f"plain version on the first {S})", r5, f"{S} rays"))
    bvh_b = tlas.geom_bvh["building"]
    qb = (tlas.poses[0].inverse().apply(q) / tlas.scales[0]).contiguous()
    md = _max_d2(QUERY_MAX_DIST, q.shape[:1], "cuda")
    r6 = check_closest_bvh("phase 14b K6", bvh_b, qb[:S].contiguous(), md[:S])
    _, _, _, cvis = closest_bvh(bvh_b.nodes, bvh_b.root_link, qb, md, visits=True)
    launch6 = lambda: closest_bvh(bvh_b.nodes, bvh_b.root_link, qb, md)
    r6["ms"], r6["timed_by"] = device_ms(launch6, "closest_bvh"), "device trace"
    if r6["ms"] is None:
        r6["ms"], r6["timed_by"] = cuda_ms(launch6, reps=3), "events"
    r6["bound_ms"], r6["bound_by"], r6["visits"] = closest_bvh_bound(cvis, q.shape[0],
                                                                      r6["slots_read"])
    r6.update(launches=ccounts["K6"])
    log(exact_line(f"phase 14b K6 (the building instance's {q.shape[0]} queries, the first of "
                   f"{tlas.n_instances} launches a call, by the {r6['timed_by']}; plain version "
                   f"on the first {S})", r6, f"{S} queries"))
    return dict(ms=ms, budgets=(cs, cb), faces=acc.world_mesh.n_faces, hit_frac=hit_frac,
                tlas_vs=tlas_vs, flat_vs=flat_vs, refine_err=err, k5=r5, k6=r6,
                grads=[{k: g[k] for k in ("name", "rays", "autograd", "fd", "atol")}
                       for g in grads],
                launches=dict(tlas=counts, flat=fcounts, closest=ccounts, grad=gcounts,
                              refine=rcounts))


def write_ply_binary(mesh, path):
    """``mesh`` as a binary little-endian PLY (float32 vertices, uchar-counted
    int32 triangles)."""
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {mesh.n_vertices}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {mesh.n_faces}\n"
            "property list uchar int vertex_indices\nend_header\n")
    rows = np.empty(mesh.n_faces, dtype=[("n", "u1"), ("i", "<i4", (3,))])
    rows["n"], rows["i"] = 3, mesh.faces
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(mesh.vertices.astype("<f4").tobytes())
        f.write(rows.tobytes())


def write_glb(mesh, path):
    """``mesh`` as a binary glTF (one indexed TRIANGLES primitive, uint32
    indices). glTF is Y-up: a Z-up (x, y, z) is stored as (x, z, -y), which
    the loader maps back exactly."""
    v = mesh.vertices
    pos = np.stack([v[:, 0], v[:, 2], -v[:, 1]], -1).astype("<f4").tobytes()
    idx = mesh.faces.astype("<u4").tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(pos) + len(idx)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
                        {"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": mesh.n_vertices, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 3 * mesh.n_faces,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(pos) + len(idx)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(pos) + len(idx), 0x004E4942) + pos + idx)


def phase_map_formats():
    """Phase 14c: phase 4's building written as binary PLY and as GLB, read
    back through ``load_mesh`` and ``MeshMap.from_file`` (bitwise the
    in-memory mesh and its bins), and the MICP-L CLI on the PLY map over
    phase 12's first scans against phase 12's OBJ run."""
    import os

    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import load_mesh, make_building_scene
    from rmcl_tpu_torch.io.replay import MessageLog
    from rmcl_tpu_torch.tools import micp_localization

    os.makedirs(FORMAT_DIR, exist_ok=True)
    mesh = make_building_scene(subdiv=BUILDING_SUBDIV)
    bins = build_bins(mesh, bin_size=64, bins_per_super=64)
    paths = {}
    for ext, write in (("ply", write_ply_binary), ("glb", write_glb)):
        paths[ext] = os.path.join(FORMAT_DIR, f"building.{ext}")
        t = time.perf_counter()
        write(mesh, paths[ext])
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = load_mesh(paths[ext])
        load_s = time.perf_counter() - t
        mmap = MeshMap.from_file(paths[ext], bin_size=64, bins_per_super=64)
        # PLY carries the float32 bits; the glTF loader maps Y-up to Z-up as
        # (x, -z, y) after a float64 transform that turns -0.0 into 0.0, so
        # a vertex at y = 0 reads back as -0.0: equal values, other bits
        if ext == "ply":
            bits = lambda a: a.view(np.int32)
            same_bins = torch.equal(mmap.bins.tri.view(torch.int32), bins.tri.view(torch.int32))
        else:
            bits = lambda a: a
            same_bins = torch.equal(mmap.bins.tri, bins.tri)
        same = all(np.array_equal(bits(m.vertices), bits(mesh.vertices))
                   and np.array_equal(m.faces, mesh.faces) for m in (loaded, mmap.mesh))
        zeros = int((loaded.vertices.view(np.int32) != mesh.vertices.view(np.int32)).sum())
        log(f"phase 14c {ext.upper()}: {os.path.getsize(paths[ext]) / 1e6:.1f} MB written in "
            f"{write_s:.2f} s, loaded in {load_s:.2f} s; vertices and faces "
            f"{'bitwise' if ext == 'ply' else 'equal in value'} the in-memory mesh's: {same} "
            f"({zeros} coordinates differ in their bits: zeros read back as -0.0); "
            f"MeshMap.from_file's bins {'bitwise' if ext == 'ply' else 'equal in value'}: "
            f"{same_bins}")
        if not (same and same_bins):
            fail(f"phase 14c: the {ext} map differs from the in-memory building")
    # the CLI on the PLY map over phase 12's first scans, against phase 12's OBJ run
    log_path = os.path.join(FORMAT_DIR, "run3.npz")
    full, short = MessageLog.load(os.path.join(NODE_DIR, "run.npz"), device="cpu"), MessageLog()
    for r in full:
        if r.stamp < 0.1 * (FORMAT_SCANS - 0.5):
            short.add(r.stamp, r.kind, r.channel, r.payload)
    short.save(log_path)
    guess = [f"{v:.6f}" for v in (*NODE_START, 0.0, 0.0, 0.0)]  # phase 12's first pose
    out_path = os.path.join(FORMAT_DIR, "track_ply.npz")
    reset_counts()
    run_cli("phase 14c micp_localization [ply]", micp_localization.main,
            ["--device", "cuda", "--map", paths["ply"], "--log", log_path, "--steps-per-scan",
             str(NODE_STEPS_PER_SCAN), "--out", out_path, "--initial-pose-guess", *guess])
    counts = read_counts()
    require_launches("phase 14c CLI", counts, ("K3r", "K1"))
    ply = np.load(out_path)["trans"]
    obj = np.load(os.path.join(NODE_DIR, "track_rc.npz"))["trans"][:FORMAT_SCANS]
    gap = float(np.linalg.norm(ply - obj, axis=1).max()) if ply.shape == obj.shape else np.inf
    log(f"phase 14c the CLI on the PLY map ({FORMAT_SCANS} scans): {ply.shape[0]} poses, at most "
        f"{gap:.3g} m from phase 12's OBJ run; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if not gap <= NODE_ERR_MAX:
        fail(f"phase 14c: the PLY run's poses are {gap} m off the OBJ run's")
    return dict(cli_gap=gap)


def p15_close(label, got, want, rtol, atol):
    """Fail unless ``got`` is within rtol/atol of ``want`` (numpy); the
    largest absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    if not (err <= atol + rtol * np.abs(want)).all():
        fail(f"{label}: {int((err > atol + rtol * np.abs(want)).sum())} values beyond rtol "
             f"{rtol}, atol {atol} (largest difference {float(err.max()):.3g})")
    return float(err.max()) if err.size else 0.0


def p15_launch(world, backend, jobs):
    """The jobs on ``world`` ranks that share the card (each rank on device
    0); raises, and so fails the run, if a rank fails."""
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    runs = launch(pg.run_jobs, world, backend, ("cuda", jobs), timeout=P15_TIMEOUT)
    log(f"phase 15 launch: {world} rank(s) on {backend}, {len(jobs)} jobs in "
        f"{time.perf_counter() - t0:.1f} s (process start and group set-up included)")
    return runs


def p15_require(label, runs, job, want_counts, want_launches, key=None):
    """Every rank's collective counts equal ``want_counts`` and each kernel
    of ``want_launches`` launched that many times."""
    for rank, r in enumerate(runs):
        c = r[job]["counts"] if key is None else r[job]["counts"][key]
        k = r[job]["launches"] if key is None else r[job]["launches"][key]
        c = c[0] if isinstance(c, list) else c
        k = k[0] if isinstance(k, list) else k
        if c != want_counts:
            fail(f"{label} rank {rank}: collectives {c}, expected {want_counts}")
        for name, n in want_launches.items():
            if k[name] != n:
                fail(f"{label} rank {rank}: {name} launched {k[name]} times, expected {n}")


def phase_multi_device(sphere_mesh, sphere_bins, sphere_bvh, r14a):
    """Phase 15: the sharded paths of rmcl_tpu_torch.parallel on ranks that
    share the card: NCCL at world size 1, gloo at 2 and 4 (NCCL refuses two
    ranks on one GPU). (a) the JAX scaling benchmark's sharded MICP-L
    correction (scripts/bench_scaling.py: the ~1M-face sphere, one 3600 x 64
    scan) on the bins (K3 + K1) and the BVH (K5), and a CP-on-bins
    correction at phase 8's size (K7 + K6b), each against the unsharded one;
    (b) sharded MCL at phase 11a's workload on 4 ranks: the binned and bvh
    sensor updates, the tournament, the dynamic residual resampler, the
    statistics and a sharded checkpoint; (c) the sharded backward at phase
    14a's workload; (d) the scene-sharded casts on phase 4's building at
    phase 14b's rays, on ("scene",) of 4 and ("rays", "scene") of 2 x 2.
    Ranks that share one card measure what the collectives cost on this
    card and transport, not scaling."""
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import make_building_scene
    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.micp.pipeline import (MICPConfig, MICPSensorConfig, MICPSensorData,
                                              correct_once)
    from rmcl_tpu_torch.ops.diff import cast_rays_diff
    from rmcl_tpu_torch.ops.raycast import NO_HIT_T, cast_rays
    from rmcl_tpu_torch.ops.raycast_binned import (_kernel_inputs, block_cull_stats,
                                                   cast_rays_binned)
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.sensors.models import SphericalModel
    from rmcl_tpu_torch.sensors.simulate import simulate

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    layout = lambda w: ((w,), ("rays",))
    tbo = Transform.identity()
    out = {}

    # -- (a) the sharded correction: inputs and the unsharded references --
    model = SphericalModel.create(width=P15_SCAN[0], height=P15_SCAN[1], phi_min=-0.4,
                                  phi_max=0.3, range_max=200.0)
    true = Transform.from_pose_tuple(P15_TRUE)
    hits = simulate(sphere_bvh, model, true)
    sensor = MICPSensorData(model=model, points=hits.point, mask=hits.hit, tsb=tbo,
                            config=MICPSensorConfig.create(max_dist=2.0))
    start = Transform.from_pose_tuple([P15_TRUE[0], P15_TRUE[1], P15_TRUE[2] + P15_DZ, 0, 0, 0])
    building = make_building_scene(subdiv=BUILDING_SUBDIV)
    bmap = MeshMap.from_mesh(building)
    vlp = SphericalModel.vlp16()
    b_true = Transform.from_pose_tuple([9.0, 3.0, 1.5, 0.0, 0.0, 0.3])
    b_hits = simulate(bmap.bvh, vlp, b_true)
    cp_sensor = MICPSensorData(model=vlp, points=b_hits.point, mask=b_hits.hit, tsb=tbo,
                               config=MICPSensorConfig.create(max_dist=EXACT_MAX_DIST,
                                                              corr_type="CP"))
    # the CP query's budgets: what the fullest query block of any rank's
    # share needs (a rank's share blocks its queries apart from the whole
    # scan's, so truncated lists would differ between world sizes)
    cp_start = Transform.from_pose_tuple(EXACT_START)
    q = cp_start.apply(b_hits.point)
    need = [0, 0]
    for world, _ in P15_WORLDS:
        for part in q.chunk(world):
            for k, n in enumerate(cp_budget_need(bmap.bins, part.contiguous(), EXACT_MAX_DIST)):
                need[k] = max(need[k], int(n.max()))
    corrections = {"bins": (sphere_bins, sensor, start, MICPConfig(), {"K1": 1, "K3r": 1}),
                   "bvh": (sphere_bvh, sensor, start, MICPConfig(), {"K5": 1}),
                   "cp_bins": (bmap.bins, cp_sensor, cp_start,
                               MICPConfig(c_super=need[0], c_bin=need[1]), {"K7": 1, "K6b": 1})}
    ref_a = {}
    for key, (accel, s, tom, config, _) in corrections.items():
        correct_once(accel, [s], tom, tbo, 0.0, config)  # warm-up
        times = []
        for _ in range(P15_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose, stats = correct_once(accel, [s], tom, tbo, 0.0, config)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ref_a[key] = dict(pose=torch.cat([pose.rot, pose.trans]).cpu().numpy(),
                          matches=float(stats.valid_matches), ms=statistics.median(times))
    log(f"phase 15a inputs: the sphere's {sphere_mesh.n_faces} faces, a {model.width} x "
        f"{model.height} scan ({model.n_rays} rays, {int(hits.hit.sum())} hits) from "
        f"+{P15_DZ} m z; phase 8's CP scan ({vlp.n_rays} points) on the building's "
        f"{building.n_faces} faces at c_super {need[0]}, c_bin {need[1]} (no query block of "
        f"any world size's shares truncates); unsharded ms/correction (median of "
        f"{P15_REPS}): " + ", ".join(f"{k} {v['ms']:.3f}" for k, v in ref_a.items()))
    a_jobs = [(f"a_{key}", None, pg.correct_job, pg.to_host(dict(
        accel=accel, sensors=[s], tom=tom, tbo=tbo, config=config, reps=P15_REPS)))
        for key, (accel, s, tom, config, _) in corrections.items()]

    # -- (c) the sharded backward: phase 14a's rays and bins, its audited
    # budgets raised until no block of any world size's shares saturates (a
    # share of 360,000 rays starts mid-block, so its blocks are not the
    # unsharded cast's) --
    bw_bins, (cs, cb, ch) = r14a["bins"], r14a["budgets"]
    bw_model = SphericalModel.vlp16(width=900)
    _, bw_dirs = bw_model.rays("cuda")
    trans0 = torch.from_numpy(np.random.default_rng(0).uniform(
        -5, 5, (BW_POSES, 3)).astype(np.float32)).cuda()
    dirs = bw_dirs[None].expand(BW_POSES, -1, 3).reshape(-1, 3).contiguous()
    pose_id = torch.arange(BW_POSES, device="cuda").repeat_interleave(bw_model.n_rays)
    origins = trans0[pose_id]
    for _ in range(SCENE_AUDIT_ROUNDS):
        sat = {f"{w}.{r}": int(block_cull_stats(
            bw_bins, o_r, d_r, block_size=BW_CAST["block_size"], c_super=cs, c_bin=cb,
            c_hyper=ch)[1].sum())
            for w, _ in P15_WORLDS
            for r, (o_r, d_r) in enumerate(zip(origins.chunk(w), dirs.chunk(w)))}
        log(f"phase 15c audit at c_super {cs}, c_bin {cb}, c_hyper {ch}: saturated blocks "
            f"(world.rank) {sat}")
        if not any(sat.values()):
            break
        cs, cb, ch = 2 * cs, 2 * cb, 2 * ch
    else:
        fail(f"phase 15c: blocks still saturate at c_super {cs}, c_bin {cb}, c_hyper {ch}")
    bw_kw = dict(BW_CAST, c_super=cs, c_bin=cb, c_hyper=ch)
    del origins
    verts0 = torch.from_numpy(sphere_mesh.vertices).cuda()
    faces = torch.from_numpy(sphere_mesh.faces).cuda()
    # a share's blocks are not the unsharded cast's where a share starts
    # mid-block (360,000 rays at world size 4), so their lists differ: the
    # rays whose winner differs between the two layouts, each named and
    # allowed only where a layout's list leaves the exact winner's bin out
    n_rays = dirs.shape[0]
    origins = trans0[pose_id]
    t_lo = torch.zeros(n_rays, device="cuda")
    t_hi = torch.full((n_rays,), NO_HIT_T, device="cuda")
    kernel_lists = lambda sl: _kernel_inputs(bw_bins, origins[sl], dirs[sl], t_lo[sl], t_hi[sl],
                                             BW_CAST["block_size"], cs, cb, 4, c_hyper=ch)[0]
    shares = lambda w: [slice(r * (n_rays // w), (r + 1) * (n_rays // w)) for r in range(w)]
    with torch.no_grad():
        full = cast_rays_binned(bw_bins, origins, dirs, **bw_kw)
        exact = cast_rays(sphere_bvh, origins, dirs)
    winner_bin = face_bin(bw_bins, sphere_mesh.n_faces)
    full_lists = kernel_lists(slice(None))
    apart = {}
    for w, _ in P15_WORLDS:
        parts = [cast_rays_binned(bw_bins, origins[sl], dirs[sl], **bw_kw) for sl in shares(w)]
        hit = torch.cat([h.hit for h in parts])
        prim = torch.cat([h.prim_id for h in parts])
        rays = torch.nonzero((hit != full.hit) | (hit & (prim != full.prim_id))).squeeze(1)
        gbin = winner_bin[exact.prim_id[rays].long().clamp(min=0)]
        absent = ~listed(full_lists, rays, gbin)
        n_share = n_rays // w
        for r, sl in enumerate(shares(w)):
            m = rays // n_share == r
            absent[m] |= ~listed(kernel_lists(sl), rays[m] - r * n_share, gbin[m])
        explained = exact.hit[rays] & (gbin >= 0) & absent
        apart[w] = dict(rays=rays, prims=torch.cat([prim[rays], full.prim_id[rays]]),
                        explained=int(explained.sum()))
        log(f"phase 15c at world {w}: {rays.numel()} rays whose winner differs between the "
            f"shares' casts and the unsharded cast: {rays[:20].tolist()}; "
            f"{int(explained.sum())} of them have their exact winner's bin absent from a "
            f"block list")
        if not bool(explained.all()):
            fail(f"phase 15c at world {w}: rays {rays[~explained][:20].tolist()} differ between "
                 f"the layouts with their exact winner's bin in every block list")
    del origins, t_lo, t_hi, full_lists

    ref_c = {}
    for wrt in ("pose", "verts"):
        def value_and_grad(sl=slice(None)):
            tr = trans0.clone().requires_grad_(wrt == "pose")
            v = verts0.clone().requires_grad_(wrt == "verts")
            h = cast_rays_diff(bw_bins, v, faces, tr[pose_id[sl]], dirs[sl], **bw_kw)
            loss = torch.where(h.hit, h.t, 0.0).sum()
            (g,) = torch.autograd.grad(loss, [tr if wrt == "pose" else v])
            return loss.detach(), g
        value_and_grad()  # warm-up
        loss, grad = value_and_grad()
        # the program on each share in turn, summed: the sharded program's
        # own blocks
        by_share = {}
        for w, _ in P15_WORLDS:
            parts = [value_and_grad(sl) for sl in shares(w)]
            by_share[w] = dict(loss=float(sum(p[0] for p in parts)),
                               grad=sum(p[1] for p in parts).cpu().numpy())
        ref_c[wrt] = dict(loss=float(loss), grad=grad.cpu().numpy(), by_share=by_share,
                          ms=host_ms(value_and_grad))
    log(f"phase 15c inputs: phase 14a's {dirs.shape[0]} rays at c_super {cs}, c_bin {cb}, "
        f"c_hyper {ch}; unsharded fwd+bwd ms (median of {BW_REPS}): "
        + ", ".join(f"{k} {v['ms']:.3f}" for k, v in ref_c.items()))
    c_jobs = [(f"c_{wrt}", None, pg.backward_job, pg.to_host(dict(
        bins=bw_bins, verts=verts0, faces=faces, trans=trans0, dirs=dirs, pose_id=pose_id,
        wrt=wrt, cast_kw=bw_kw, reps=BW_REPS))) for wrt in ("pose", "verts")]

    # -- world sizes 1 (NCCL), 2 and 4 (gloo): (a) and (c) --
    world_runs = {}
    for world, backend in P15_WORLDS:
        jobs = [(name, layout(world), fn, kw) for name, _, fn, kw in a_jobs + c_jobs]
        if world == 4:
            jobs += phase15_four_rank_jobs(out, bmap, vlp)
        world_runs[world] = (backend, p15_launch(world, backend, jobs))
    for world, (backend, runs) in world_runs.items():
        for key, (*_, kernels) in corrections.items():
            label = f"phase 15a {key} at world {world} ({backend})"
            p15_require(label, runs, f"a_{key}", {"all_reduce": 6, "all_gather": 0,
                                                  "permute": 0}, kernels)
            r0 = runs[0][f"a_{key}"]
            for rank, r in enumerate(runs):
                if not np.array_equal(r[f"a_{key}"]["poses"], r0["poses"]):
                    fail(f"{label}: rank {rank}'s pose differs from rank 0's")
            err = p15_close(label + " pose", r0["poses"][-1], ref_a[key]["pose"], 0.0, 1e-4)
            p15_close(label + " matches", float(r0["valid_matches"]), ref_a[key]["matches"],
                      1e-5, 0.0)
            ms = statistics.median(max(r[f"a_{key}"]["ms"][i] for r in runs)
                                   for i in range(P15_REPS))
            out.setdefault("a", {}).setdefault(key, {})[world] = dict(
                backend=backend, ms=ms, unsharded_ms=ref_a[key]["ms"], pose_err=err,
                matches=float(r0["valid_matches"]), all_reduce=6, launches_per_rank=kernels)
            log(f"{label}: pose within {err:.3g} of the unsharded, matches "
                f"{float(r0['valid_matches']):.0f} ({ref_a[key]['matches']:.0f}), 6 "
                f"all-reduces and {kernels} a rank; {ms:.3f} ms/correction (the slowest "
                f"rank, median of {P15_REPS}) against {ref_a[key]['ms']:.3f} unsharded")
        for wrt in ("pose", "verts"):
            label = f"phase 15c {wrt} at world {world} ({backend})"
            p15_require(label, runs, f"c_{wrt}", {"all_reduce": 1, "all_gather": 0,
                                                  "permute": 0}, {"K1": 1, "K3r": 1})
            # against the program on the same shares (the same blocks), and
            # against the unsharded program on the poses or vertices that no
            # ray of the layouts' differences reaches
            share = ref_c[wrt]["by_share"][world]
            keep = np.ones(ref_c[wrt]["grad"].shape[0], bool)
            if wrt == "pose":
                keep[pose_id[apart[world]["rays"]].cpu().numpy()] = False
            else:
                prims = apart[world]["prims"]
                keep[faces[prims[prims >= 0].long()].reshape(-1).cpu().numpy()] = False
            for r in runs:
                p15_close(label + " loss", float(r[f"c_{wrt}"]["loss"]), ref_c[wrt]["loss"],
                          1e-5, 0.0)
                p15_close(label + " loss (the shares' program)", float(r[f"c_{wrt}"]["loss"]),
                          share["loss"], 1e-5, 0.0)
                err = p15_close(label + " gradient (the shares' program)", r[f"c_{wrt}"]["grad"],
                                share["grad"], 2e-4, 1e-5)
                p15_close(label + " gradient", r[f"c_{wrt}"]["grad"][keep],
                          ref_c[wrt]["grad"][keep], 2e-4, 1e-5)
            ms = statistics.median(max(r[f"c_{wrt}"]["ms"][i] for r in runs)
                                   for i in range(BW_REPS))
            out.setdefault("c", {}).setdefault(wrt, {})[world] = dict(
                backend=backend, ms=ms, unsharded_ms=ref_c[wrt]["ms"], grad_err=err,
                all_reduce=1, rays_apart=int(apart[world]["rays"].numel()),
                held_out=int((~keep).sum()))
            log(f"{label}: loss within 1e-5 of the unsharded; the gradient within {err:.3g} of "
                f"the program on the same shares, and within rtol 2e-4 of the unsharded on all "
                f"but {int((~keep).sum())} entries that the layouts' differing rays reach; 1 "
                f"all-reduce, K3 + K1 once a rank; {ms:.3f} ms (slowest rank, median of "
                f"{BW_REPS}) against {ref_c[wrt]['ms']:.3f} unsharded")
    phase15_check_four_ranks(out, world_runs[4][1])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 done in {out['seconds']:.1f} s")
    return out


def phase15_four_rank_jobs(out, bmap, vlp):
    """The unsharded references of 15b and 15d (kept in ``out["_ref"]``) and
    their jobs for the 4-rank launch."""
    import dataclasses

    from rmcl_tpu_torch.math.se3 import Transform
    from rmcl_tpu_torch.mcl.sensor_update import sample_beams, sensor_update
    from rmcl_tpu_torch.ops.order import cluster_order
    from rmcl_tpu_torch.ops.raycast import cast_rays
    from rmcl_tpu_torch.ops.raycast_binned import (_kernel_inputs, block_cull_stats,
                                                   cast_rays_binned)
    from rmcl_tpu_torch.parallel import programs as pg
    from rmcl_tpu_torch.parallel import scene_shard

    ref = out.setdefault("_ref", {})
    tsb = Transform.identity()
    # (b) phase 11a's map, scan, configuration and a 1M cloud in its global
    # cluster order; one beam set for every rank; the unsharded updates of
    # the same four chunks and of the bvh slice
    mmap, _, truth, points, mask, scfg = mcl_world()
    gen = torch.Generator(device="cuda").manual_seed(P15_SEED)
    cloud = mcl_cloud(truth, MCL_PARTICLES, gen)
    fw = cloud.poses.rotate(torch.tensor([1.0, 0.0, 0.0], device="cuda"))
    order, _ = cluster_order(cloud.poses.trans, fw)
    cloud = cloud.map(lambda x: x[order.long()].contiguous())
    beams = sample_beams(gen, points, mask, MCL_BEAMS)
    cfg = dataclasses.replace(scfg, cluster=False)
    bcfg = dataclasses.replace(cfg, engine="bvh")
    chunks = lambda: [sensor_update(mmap.bins, cloud.map(lambda x: x[i * MCL_CHUNK:(i + 1) * MCL_CHUNK]),
                                    None, None, None, tsb, cfg, beams=beams).likelihood.mean
                      for i in range(MCL_PARTICLES // MCL_CHUNK)]
    ref["b"] = dict(mean=torch.cat(chunks()).cpu().numpy(), ms=host_ms(chunks, reps=3),
                    bvh_mean=sensor_update(mmap.bvh, cloud.map(lambda x: x[:MCL_SLICE]), None,
                                           None, None, tsb, bcfg, beams=beams
                                           ).likelihood.mean.cpu().numpy())
    log(f"phase 15b inputs: phase 11a's {MCL_PARTICLES} particles x {MCL_BEAMS} beams in its "
        f"cluster order, {MCL_PARTICLES // 4} a rank; unsharded binned update of the four "
        f"chunks {ref['b']['ms']:.3f} ms (median of 3)")
    jobs = [("b_mcl", ((4,), ("rays",)), pg.mcl_shard_job, pg.to_host(dict(
        bins=mmap.bins, bvh=mmap.bvh, cloud=cloud, beams=beams, tsb=tsb, config=cfg,
        bvh_config=bcfg, bvh_particles=MCL_SLICE, n_target=MCL_PARTICLES // 2,
        path=P15_CKPT, seed=P15_SEED, reps=3)))]
    del cloud, mmap

    # (d) phase 4's building in 4 and in 2 shards, phase 14b's rays, the
    # budgets doubled until no block saturates unsharded or in any shard
    bins = bmap.bins
    o, d = scene_rays(vlp, BW_POSES, SCENE_SEED)
    n = o.shape[0]
    lim = dict(t_min=vlp.range.min, t_max=vlp.range.max)
    parts = {k: scene_shard.partition_bins(bins, k) for k in (4, 2)}
    shards = {k: [scene_shard._shard(sb, s) for s in range(k)] for k, sb in parts.items()}
    cs, cb = SCENE_BUDGETS
    for _ in range(SCENE_AUDIT_ROUNDS):
        sat = {name: int(block_cull_stats(b, o, d, block_size=DEFAULT_BLOCK_SIZE, c_super=cs,
                                          c_bin=cb, **lim)[1].sum())
               for name, b in [("unsharded", bins)] + [
                   (f"{k}.{s}", b) for k, bs in shards.items() for s, b in enumerate(bs)]}
        log(f"phase 15d audit at c_super {cs}, c_bin {cb}: saturated blocks {sat}")
        if not any(sat.values()):
            break
        cs, cb = 2 * cs, 2 * cb
    else:
        fail(f"phase 15d: blocks still saturate at c_super {cs}, c_bin {cb}")
    kw = dict(block_size=DEFAULT_BLOCK_SIZE, c_super=cs, c_bin=cb, sort_blocks=True, **lim)
    h_ref = cast_rays_binned(bins, o, d, **kw)
    hf = cast_rays(bmap.bvh, o, d, **lim)
    t_lo = torch.full((n,), lim["t_min"], device="cuda")
    t_hi = torch.full((n,), lim["t_max"], device="cuda")
    lists = lambda b: _kernel_inputs(b, o, d, t_lo, t_hi, DEFAULT_BLOCK_SIZE, cs, cb, 4)[0]
    ref["d"] = dict(
        t=h_ref.t.cpu().numpy(), hit=h_ref.hit.cpu().numpy(), normal=h_ref.normal.cpu().numpy(),
        ms=host_ms(lambda: cast_rays_binned(bins, o, d, **kw), reps=3), budgets=(cs, cb),
        exact=hf, flat_lists=lists(bins), shard_lists={k: [lists(b) for b in bs]
                                                      for k, bs in shards.items()},
        face_bin=face_bin(bins, bmap.mesh.n_faces),
        bins_per_shard={k: sb.tri.shape[1] for k, sb in parts.items()}, n=n, shards=shards,
        boxes={k: scene_shard.shard_boxes(sb) for k, sb in parts.items()}, rays=(o, d),
        lim=lim)
    log(f"phase 15d inputs: the building's {bins.n_bins} bins in 4 and in 2 shards of "
        f"{parts[4].tri.shape[1]} and {parts[2].tri.shape[1]}, {n} rays; unsharded cast "
        f"{ref['d']['ms']:.3f} ms (median of 3)")
    for mesh_name, layout, k in (("1d", ((4,), ("scene",)), 4),
                                 ("2d", ((2, 2), ("rays", "scene")), 2)):
        for forwarded in (False, True):
            jobs.append((f"d_{mesh_name}_{'forwarded' if forwarded else 'sharded'}", layout,
                         pg.scene_job, pg.to_host(dict(sbins=parts[k], orig=o, dirs=d,
                                                       forwarded=forwarded, cast_kw=kw, reps=3))))
    return jobs


def forwarded_listed(rd, k, rays, which, shard, local):
    """For the rays ``which`` (indices into the slice ``rays`` of phase 15d's
    rays, one rank's) of the forwarded cast on k shards: False where a round
    in which the winner's shard ``shard`` casts the ray leaves its bin
    ``local`` out of the ray's block (the blocks of the assigned-shard
    order, the round's reach), True otherwise."""
    from rmcl_tpu_torch.ops.raycast_binned import _kernel_inputs, cast_rays_binned
    from rmcl_tpu_torch.parallel import scene_shard

    o, d = (x[rays] for x in rd["rays"])
    n = o.shape[0]
    t_lo = torch.full((n,), rd["lim"]["t_min"], device="cuda")
    t_hi = torch.full((n,), rd["lim"]["t_max"], device="cuda")
    cs, cb = rd["budgets"]
    order, assigned, crosses, t_enter = scene_shard._route(o, d, t_lo, t_hi, rd["boxes"][k])
    o, d, t_lo, t_hi = o[order], d[order], t_lo[order], t_hi[order]
    pos = torch.argsort(order, stable=True)[which]
    reach1 = [scene_shard._round1_t_max(s, assigned, crosses, t_hi) for s in range(k)]
    t1_all = sum(torch.where(h.hit, h.t, r) for h, r in zip(
        (cast_rays_binned(b, o, d, t_min=t_lo, t_max=r, block_size=DEFAULT_BLOCK_SIZE,
                          c_super=cs, c_bin=cb) for b, r in zip(rd["shards"][k], reach1)),
        reach1))
    ok = torch.ones(pos.shape[0], dtype=torch.bool, device="cuda")
    for s, b in enumerate(rd["shards"][k]):
        reach2 = scene_shard._round2_t_max(s, assigned, crosses, t_enter, t_hi, t1_all)
        for reach in (reach1[s], reach2):
            live = (shard == s) & (reach[pos] > t_lo[pos])
            lists = _kernel_inputs(b, o, d, t_lo, reach, DEFAULT_BLOCK_SIZE, cs, cb, 4)[0]
            ok[live] &= listed(lists, pos[live], local[live])
    return ok


def phase15_check_four_ranks(out, runs):
    """15b and 15d against their unsharded references."""
    from rmcl_tpu_torch.parallel import programs as pg

    ref = out.pop("_ref")
    # (b)
    rb = ref["b"]
    n_local = MCL_PARTICLES // 4
    want = {"update": {"all_reduce": 0, "all_gather": 0, "permute": 0},
            "bvh": {"all_reduce": 0, "all_gather": 0, "permute": 0},
            "gladiator": {"all_reduce": 0, "all_gather": 0, "permute": 1},
            "residual": {"all_reduce": 0, "all_gather": 1, "permute": 0},
            "stats": {"all_reduce": 2, "all_gather": 0, "permute": 0}}
    for rank, r in enumerate(runs):
        b = r["b_mcl"]
        if b["counts"] != want:
            fail(f"phase 15b rank {rank}: collectives {b['counts']}, expected {want}")
        if b["shifts"] != [1]:
            fail(f"phase 15b rank {rank}: shifts {b['shifts']}")
        for step, kernels in (("update", ("K3r", "K1")), ("bvh", ("K5",))):
            for k in kernels:
                if b["launches"][step][k] < 1:
                    fail(f"phase 15b rank {rank}: the {step} update never launched {k}")
        if not b["checkpoint_bitwise"]:
            fail(f"phase 15b rank {rank}: the sharded checkpoint did not round-trip bitwise")
        p15_close(f"phase 15b rank {rank} binned likelihoods", b["mean"],
                  rb["mean"][rank * n_local:(rank + 1) * n_local], 2e-4, 1e-6)
        s = MCL_SLICE // 4
        p15_close(f"phase 15b rank {rank} bvh likelihoods", b["bvh_mean"],
                  rb["bvh_mean"][rank * s:(rank + 1) * s], 2e-4, 1e-6)
        if (float(b["lik_sum"]), float(b["lik_max"])) != (float(runs[0]["b_mcl"]["lik_sum"]),
                                                          float(runs[0]["b_mcl"]["lik_max"])):
            fail(f"phase 15b rank {rank}: the likelihood statistics differ from rank 0's")
    alive = [int(r["b_mcl"]["alive"]) for r in runs]
    if sum(alive) != MCL_PARTICLES // 2:
        fail(f"phase 15b: the residual shares {alive} do not sum to {MCL_PARTICLES // 2}")
    peak = [round(float(r["b_mcl"]["peak_bytes"]) / 1e9, 3) for r in runs]
    ms = statistics.median(max(r["b_mcl"]["ms"][i] for r in runs) for i in range(3))
    out["b"] = dict(backend="gloo", ranks=4, particles_per_rank=n_local, ms=ms,
                    unsharded_ms=rb["ms"], shares=alive, peak_gb=peak,
                    launches=[r["b_mcl"]["launches"] for r in runs],
                    lik_sum=float(runs[0]["b_mcl"]["lik_sum"]))
    log(f"phase 15b: 4 gloo ranks x {n_local} particles: likelihoods within rtol 2e-4 of the "
        f"unsharded chunks (binned) and slice (bvh), no collective in either update; one permute "
        f"(shift 1), one all-gather (shares {alive}, sum {sum(alive)}), two all-reduces "
        f"(sum {out['b']['lik_sum']:.6g}); checkpoint bitwise; binned update {ms:.3f} ms "
        f"(slowest rank, median of 3) against {rb['ms']:.3f} unsharded for all four chunks; "
        f"peak memory a rank {peak} GB; launches {out['b']['launches'][0]}")

    # (d)
    rd = ref["d"]
    exact, fb = rd["exact"], rd["face_bin"]
    t_ref, hit_ref, n_ref = rd["t"], rd["hit"], rd["normal"]
    # every ray the exact cast hits finds its winner's bin in its block's
    # list: the unsharded cast's, and each shard's (the cull keeps flat wall
    # bins)
    hit_rays = torch.nonzero(exact.hit).squeeze(1)
    gbin_all = fb[exact.prim_id[hit_rays].long()]
    missing = {"unsharded": torch.nonzero(~listed(rd["flat_lists"], hit_rays, gbin_all))
               .squeeze(1)}
    for k, lists_k in rd["shard_lists"].items():
        shard = gbin_all // rd["bins_per_shard"][k]
        local = gbin_all - shard * rd["bins_per_shard"][k]
        absent = torch.zeros_like(gbin_all, dtype=torch.bool)
        for s_ in range(k):
            m = shard == s_
            absent[m] = ~listed(lists_k[s_], hit_rays[m], local[m])
        missing[f"{k} shards"] = torch.nonzero(absent).squeeze(1)
    missing = {k: hit_rays[v].tolist() for k, v in missing.items()}
    log(f"phase 15d: rays whose exact winner's bin is missing from their block's list: "
        + ", ".join(f"{k} {len(v)} {v[:20]}" for k, v in missing.items()))
    if any(missing.values()):
        fail(f"phase 15d: block lists leave out exact winners' bins: {missing}")
    for name in [k for k in runs[0] if k.startswith("d_")]:
        forwarded = name.endswith("forwarded")
        two_d = "_2d_" in name
        label = f"phase 15d {name[2:]}"
        want_c = {"all_reduce": 3 if forwarded else 2, "all_gather": 0, "permute": 0}
        for rank, r in enumerate(runs):
            if r[name]["counts"] != want_c:
                fail(f"{label} rank {rank}: collectives {r[name]['counts']}, expected {want_c}")
            casts = 2 if forwarded else 1
            if r[name]["launches"]["K3r"] != casts or r[name]["launches"]["K1"] != casts:
                fail(f"{label} rank {rank}: launches {r[name]['launches']}")
        if two_d:
            h = {k: pg.assemble([r[name] for r in runs], k, ranks=[0, 2])
                 for k in ("t", "hit", "normal")}
        else:
            h = runs[0][name]
            for rank, r in enumerate(runs[1:], 1):
                if not all(np.array_equal(r[name][k], h[k]) for k in ("t", "hit", "normal")):
                    fail(f"{label}: rank {rank}'s hits differ from rank 0's")
        both = h["hit"] & hit_ref
        t_bad = both & (np.abs(h["t"] - t_ref) > 1e-5 + 1e-5 * np.abs(t_ref))
        n_bad = both & (np.abs(h["normal"] - n_ref).max(-1) > 1e-5)
        differ = np.nonzero((h["hit"] != hit_ref) | t_bad | n_bad)[0]
        k = 2 if two_d else 4
        rays_t = torch.from_numpy(differ).cuda()
        explained = torch.zeros(len(differ), dtype=torch.bool, device="cuda")
        if len(differ):
            face = exact.prim_id[rays_t].long()
            gbin = fb[face.clamp(min=0)]
            ok = exact.hit[rays_t] & (gbin >= 0)
            shard = gbin // rd["bins_per_shard"][k]
            local = gbin - shard * rd["bins_per_shard"][k]
            in_flat = listed(rd["flat_lists"], rays_t, gbin)
            if forwarded:
                # the forwarded cast's own blocks: each half of the rays a
                # rank holds (two on the 2 x 2 mesh) routed and cast round by
                # round as its ranks do
                halves = 2 if two_d else 1
                n_half = rd["n"] // halves
                in_shard = torch.ones_like(in_flat)
                for hv in range(halves):
                    m = rays_t // n_half == hv
                    in_shard[m] = forwarded_listed(
                        rd, k, slice(hv * n_half, (hv + 1) * n_half), rays_t[m] - hv * n_half,
                        shard[m], local[m])
            else:
                in_shard = torch.ones_like(in_flat)
                for s in range(k):
                    m = shard == s
                    in_shard[m] = listed(rd["shard_lists"][k][s], rays_t[m], local[m])
            explained = ok & (~in_flat | ~in_shard)
        unexplained = differ
        ms = statistics.median(max(r[name]["ms"][i] for r in runs) for i in range(3))
        out.setdefault("d", {})[name[2:]] = dict(
            backend="gloo", differ=len(differ), explained=int(explained.sum()),
            rays=differ[:20].tolist(), collectives=want_c["all_reduce"], ms=ms,
            unsharded_ms=rd["ms"], budgets=rd["budgets"])
        log(f"{label}: {len(differ)} of {rd['n']} rays differ from the unsharded cast "
            f"(hits, t within 1e-5, normals within 1e-5): {differ[:20].tolist()}"
            f"{' ...' if len(differ) > 20 else ''}; {int(explained.sum())} of them have their exact "
            f"winner's bin absent from a block list (unsharded, shard or round); "
            f"{want_c['all_reduce']} all-reduces a cast (JAX's election: 7); {ms:.3f} ms a cast "
            f"(slowest rank, median of 3) against {rd['ms']:.3f} unsharded")
        if len(unexplained):
            fail(f"{label}: rays {unexplained[:20].tolist()} differ from the unsharded cast "
                 f"({int(explained.sum())} of them with their exact winner's bin absent from a "
                 f"block list)")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test drives the port on the card")
    smi = phase_device()
    phase_build()

    from rmcl_tpu_torch.bvh.bins import build_bins
    from rmcl_tpu_torch.geom.mesh import make_sphere

    t0 = time.perf_counter()
    sphere_mesh = make_sphere(SPHERE_LAT_LON, SPHERE_LAT_LON, radius=50.0)
    sphere = build_bins(sphere_mesh, bin_size=64)
    torch.cuda.synchronize()
    log(f"sphere map: {sphere.n_bins} bins of {sphere.bin_size} ({bin_order_note()}), "
        f"{sphere.tri.numel() * 4 / 1e6:.1f} MB packed, built in {time.perf_counter() - t0:.2f} s")

    phase_kernel_vs_plain(sphere)
    main_r = phase_main_path()
    r16 = phase_gauss_newton(main_r)
    phase_reference_cast(sphere)
    phase_tracking(main_r)
    sweep_r = phase_sweep()
    exact_r = phase_exact_main_path(main_r)
    ref_r = phase_exact_reference_size(sphere_mesh, sphere)
    mcl_r = phase_mcl_cast(main_r)
    del main_r["bmap"]
    r10b = phase_mcl_walk_score()
    r11 = phase_mcl_cycle()
    r11b = phase_mcl_engines(r11)
    r11c = phase_mcl_node(r11)
    r12 = phase_node_and_tools()
    r13 = phase_groups_and_sah(sweep_r, main_r)
    r14a = phase_backward(sphere_mesh)
    r14b = phase_scene_graph()
    r14c = phase_map_formats()
    r15 = phase_multi_device(sphere_mesh, sphere, ref_r.pop("bvh"), r14a)

    k4 = sweep_r["k4"]
    row = lambda name, source, replaces, r: {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "roofline": r["bound_ms"] / r["ms"], "library_ms": None}
    k3_row = lambda name, replaces, r: dict(
        row(name, "rmcl_tpu_torch/csrc/cull_blocks.cu", replaces, r), bitwise=r["bitwise"],
        call_ms=r["call_ms"], cull_e2e_ms=r["e2e_ms"], back_end_ms=r["back_ms"],
        back_end_bound_ms=r["back_bound_ms"])
    log(json.dumps({"kernels": [
        dict(row("intersect_bins", "rmcl_tpu_torch/csrc/intersect_bins.cu",
                 "rmcl_tpu/ops/raycast_pallas.py:35", main_r),
             phase11=sub_row(r11["k1"], order="count", block_order_ms=r11["k1"]["unsorted_ms"]),
             phase14a=sub_row(r14a["k1"], timed_by="device trace", order="count",
                              block_order_ms=r14a["k1"]["unsorted_ms"])),
        dict(k3_row("cull_rays", "rmcl_tpu/ops/raycast_binned.py:751", main_r["k3"]),
             phase11_hyper=sub_row(r11["k3"], timed_by="device trace",
                                   bitwise=r11["k3"]["bitwise"],
                                   registers=r11["k3"]["registers"]),
             phase11_mid=sub_row(r11b["kmid"], timed_by="device trace", bitwise=True,
                                 replaces="rmcl_tpu/ops/raycast_binned.py:644",
                                 c_mid=r11b["kmid"]["cm"],
                                 two_level_ms=r11b["kmid"]["two_level_ms"],
                                 registers=r11["k3"]["registers"]),
             phase14a=sub_row(r14a["k3"], timed_by="device trace",
                              bitwise=r14a["k3"]["bitwise"]),
             past_cap=exact_r["k7"]["k3_wide_levels"]),
        k3_row("cull_factored", "rmcl_tpu/ops/raycast_binned.py:1370", sweep_r["k3"]),
        row("intersect_factored", "rmcl_tpu_torch/csrc/intersect_factored.cu",
            "rmcl_tpu/ops/raycast_binned.py:1650", k4),
        dict(row("intersect_groups", "rmcl_tpu_torch/csrc/intersect_bins.cu",
                 "rmcl_tpu/ops/raycast_binned.py:967", r13["k2g"]), bitwise=True,
             timed_by=r13["k2g"]["timed_by"], call_ms=r13["k2g"]["call_ms"],
             plain_blocks=r13["k2g"]["plain_blocks"], k1_same_inputs_ms=r13["k2g"]["k1_ms"],
             registers=r13["k2g"]["registers"]),
        dict(row("traverse_rays", "rmcl_tpu_torch/csrc/traverse_bvh.cu",
                 "rmcl_tpu/ops/raycast.py:73", exact_r["k5"]), bitwise=True,
             timed_by=exact_r["k5"]["timed_by"], registers=exact_r["registers"]["K5"][0],
             phases={ph: {k: r[k] for k in ("ms", "bound_ms", "bound_by", "launches")}
                     for ph, r in (("8", exact_r["k5"]), ("9", ref_r["k5"]), ("10", mcl_r),
                                   ("11", r11b["k5"]))},
             phase14b=sub_row(r14b["k5"], bitwise=True),
             phase10_angular_ms=mcl_r["angular_ms"]),
        {"name": "walk_score_rc", "route": "cuda", "source": "rmcl_tpu_torch/csrc/traverse_bvh.cu",
         "replaces": "none: K5 (rmcl_tpu/ops/raycast.py:73) with the XLA ops of "
                     "rmcl_tpu/mcl/sensor_update.py's RC score and fold",
         "launches": 1, "kernels": {
             "K5 ScoreRC": {"ms": r10b["k5_score_ms"], "timed_by": "device trace",
                            "bound_ms": r10b["k5_score_bound_ms"],
                            "bound_by": r10b["k5_score_bound_by"],
                            "registers": r10b["registers"]["K5 ScoreRC"][0]},
             "fold": {"ms": r10b["fold_ms"], "timed_by": "device trace",
                      "bound_ms": r10b["fold_bound_ms"], "bound_by": r10b["fold_bound_by"],
                      "registers": r10b["registers"]["fold"][0]}},
         "update_ms": r10b["fused_ms"], "composed_update_ms": r10b["composed_ms"],
         "composed_k5_ms": r10b["k5_store_ms"], "visits": r10b["visits"],
         "lik_rel_p75": r10b["lik_rel_p75"], "library_ms": None},
        dict(row("closest_bvh", "rmcl_tpu_torch/csrc/closest_bvh.cu",
                 "rmcl_tpu/ops/closest_point.py:154", exact_r["k6"]), bitwise=True,
             split=exact_r["k6"]["split"],
             registers=exact_r["registers"][f"K6 P={exact_r['k6']['split']}"][0],
             phase14b=sub_row(r14b["k6"], bitwise=True, split=r14b["k6"]["split"])),
        dict(row("closest_bins", "rmcl_tpu_torch/csrc/closest_bins.cu",
                 "rmcl_tpu/ops/closest_point.py:445", exact_r["k6b"]), bitwise=True,
             groups=exact_r["k6b"]["groups"], registers=exact_r["registers"]["K6b"][0]),
        dict(row("cp_candidates", "rmcl_tpu_torch/csrc/cull_boxes.cu",
                 "rmcl_tpu/ops/closest_point.py:305", exact_r["k7"]), bitwise=True,
             timed_by=exact_r["k7"]["timed_by"], registers=exact_r["registers"]["K7"][0],
             registers_wide=exact_r["registers"]["K7 wide"][0],
             threads=exact_r["k7"]["threads"], shared_bytes=exact_r["k7"]["shared_bytes"],
             floor_ms=exact_r["k7"]["floor_ms"],
             phases={ph: {k: r[k] for k in ("ms", "timed_by", "call_ms", "plain_ms", "bound_ms",
                                            "bound_by", "launches", "blocks", "plain_blocks",
                                            "threads", "shared_bytes", "floor_ms")}
                     for ph, r in (("8", exact_r["k7"]), ("9", ref_r["k7"]), ("12", r12["k7"]))},
             wide_levels=exact_r["k7"]["wide_levels"]),
        dict(row("p2l_gauss_newton", "rmcl_tpu_torch/csrc/p2l_gauss_newton.cu",
                 "none: the XLA-fused loop of rmcl_tpu/micp/pipeline.py::correct_once_jit "
                 "(:349-548)", r16),
             **{k: r16[k] for k in ("timed_by", "call_ms", "host_us", "registers", "chunk",
                                    "static_shared_bytes", "gaps", "phase16_3x")}),
        dict(row("batch_epilogue", "rmcl_tpu_torch/csrc/batch_epilogue.cu",
                 "none: the XLA ops of the JAX bench's batch correction", sweep_r["ep"]),
             **{k: sweep_r["ep"][k] for k in ("timed_by", "call_ms", "winner_cast_ms",
                                              "correction_ms", "bytes", "rows", "registers",
                                              "static_shared_bytes", "gaps", "pairs")}),
    ]}))
    log("phase 13 the SAH BVH: " + json.dumps(r13["sah"]))
    log("phase 14 the differentiable cast, the scene graph and the map formats: " + json.dumps(
        {"14a": {k: r14a[k] for k in ("ms", "hit_frac", "t_rel", "budgets", "bvh_agree",
                                      "bvh_t_rel", "bench")},
         "14b": {k: r14b[k] for k in ("ms", "budgets", "faces", "hit_frac", "tlas_vs", "flat_vs",
                                      "refine_err", "grads")},
         "14c": r14c}))
    log("phase 15 multi-device (ranks sharing the card; NCCL at world size 1, gloo at 2 "
        "and 4): " + json.dumps(r15))
    log("phase 12 ms per correction (median, host clock): " + json.dumps(
        {k: round(v["ms"], 4) for k, v in r12["runs"].items()}))
    log(f"card: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
