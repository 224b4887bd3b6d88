// Block cull for the binned ray casters: per ray block, its cone bounds and
// then its nearest-first candidate bins, in one kernel.
//
// Replaces the cull that the JAX package runs as XLA device code inside its
// casts, rmcl_tpu/ops/raycast_binned.py: the bounds of _block_bounds,
// _subblock_bounds and the factored cull's fact_bounds / margin_sb_bounds
// with the scene-exit cap of _chunk_level0, then the box tests and
// selections of _chunk_level0 (level 0 over all supers, or its c_hyper
// branch), _group_box_tests, _chunk_cull_tests, _chunk_select and
// _chunk_candidates. Per block:
//
//   bounds:  R sub-block cones from the block's rays (origin box, unit mean
//            direction, half-angle, reach), dead sub-blocks parked, every
//            reach capped at the scene's exit; with the hyper level also
//            one fat cone over all the block's rays. Four front ends: the
//            cones precomputed (the back end alone), dense rays, factored
//            blocks in expanded order (ray i = origin i % P, direction
//            i / P, read by index, never materialised) and factored blocks
//            whose sub-blocks are whole direction groups;
//   level 0: the R cones x every super (a super passes if any cone passes,
//            its entry distance the least over passing cones), the cs
//            nearest by the key (bits(tn), index); or the fat cone x every
//            hyper, the ch nearest by the packed key (bits(tn) & ~idm) | id,
//            then the fat cone x those hypers' supers, the cs nearest;
//   mid:     with the mid level (cm > 0), the R cones x the S / M mid boxes
//            of each kept super (mids made only of padding bins skipped),
//            the cm nearest by the packed key when the mid ids fit 20 bits,
//            else by the key (bits(tn), position) (_chunk_cull_tests3);
//   level 1: the R cones x the S bins of each kept super (or the M bins of
//            each kept mid), the cb nearest by the packed key; tnear = the
//            key's truncated tn / n_hi;
//   sat:     whether any level had more passing boxes than its budget.
//
// Every sum runs in the plain version's fixed order (ops/cull_cuda.py): the
// three components left to right, the sums over rays as a halving tree over
// a zero-padded power of two; 1/sqrt is a correctly rounded square root and
// division, never rsqrtf. Built with --fmad=false, the kernel and the plain
// version round alike and pick the same lists.
//
// What bounds it on an H100: the cone-box tests, ~90 float instructions
// each, R x (bins of the kept supers) per block at level 1 (the pose sweep:
// 128 cones x up to 384 bins); a block reads a few KB of rays and boxes
// (the boxes L2-resident), so it is bound by float32 instruction
// throughput. The design:
//   * one CTA per block, 128 threads when the grid is big (several CTAs an
//     SM, so one CTA's barriers and selections overlap another's tests),
//     256 when it is not; the bounds fold by warp shuffles, strides of 32
//     slots and more through shared memory;
//   * the tests spread over (box, cone) pairs: L lanes share a box, each
//     lane holds its R / L cones in registers for the whole level and runs
//     their tests without branches, so they interleave; a test reads only
//     the box (a broadcast); the OR and the least tn over cones meet by one
//     redux (or shuffles) on tn's bits (tn >= +0.0, canonical, so the
//     unsigned order is the float order). Where a lane's cones share one
//     origin box (the factored front end; the expanded one when L x W is a
//     multiple of P), a build forms a box's offsets and distances (33 of
//     the ~90 instructions, both square roots) once for them and holds
//     one origin box;
//   * each level's keys go through key_sort.cuh (shared with K7):
//     compacted by ballot and popcount into a stage in shared memory; where
//     more pass than the level keeps, a radix select of the kept-th key and
//     a compaction of the kept keys; then a bitonic sort of the kept keys
//     alone, in warps' registers with only the wide strides in shared
//     memory. Keys are unique, so the order is the plain version's. Shared
//     memory holds the kept lists and a stage of up to 16,384 keys
//     (ops/cull_cuda.py::cull_launch_plan sizes it); a level that passes
//     more than its stage is streamed, each radix pass recomputing its
//     tests, so no level width is refused. Only launches whose plan lets a
//     level outgrow its stage take the builds with the streamed passes;
//   * the tests and barriers hide behind other CTAs, so each build's
//     registers are capped (min_blocks) for as many resident CTAs as the
//     build fits without spilling.
//
// The cone-box test is the plain version's (ops/cull_cuda.py::
// _cone_box_test): JAX's, except that the slab's axial interval is held
// against d_near * cos(theta_max), not the Euclidean d_near, and the reach
// compared with the entry distance is a ray length (t_len), so a flat box
// seen off-axis is not dropped; keys and radii are JAX's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "key_sort.cuh"

// the kernel's arguments, mirrored field for field by ops/cull_cuda.py::_CullArgs
// (outside the anonymous namespace: the exported entry point takes it)
struct CullArgs {
  const float* cones;  // kCones: (Cb, R, 12), fat (Cb, 12), n_hi (Cb,)
  const float* fat;
  const float* n_hi;
  const float* o;  // kRays: (Cb, Rb, 3); factored: (Cb, P, 3)
  const float* d;  // kRays: (Cb, Rb, 3); factored: (Cb, G, 3)
  const float* t_min;  // kRays: (Cb, Rb)
  const float* t_max;
  const float* alive;  // factored: (Cb,)
  const float* scene_min;
  const float* scene_max;
  const float* bin_aabb;
  const float* super_aabb;
  const float* hyper_aabb;
  const float* mid_aabb;
  int* cand_bin;
  int* cand_count;
  float* cand_tnear;
  unsigned char* sat;
  int mode, Cb, R, Rb, P, G;
  int n_bins, n_super, n_hyper, S, H, ch, cs, cb;
  int M, Sm, cm, n_mid_ids;  // the mid level: M bins a mid, S / M mids a super, budget cm
  int threads, key_slots;    // the launch plan: a CTA's threads (128 or 256), shared key slots,
  int smem_bytes, stream;    // dynamic shared bytes, whether a level may outgrow its stage
  unsigned idm_hyp, idm_sup, idm_bin, idm_mid;
  int hyp_packed, sup_packed, bin_packed, mid_packed;
  float t_min_s, t_max_s, origin_margin, tan_dm;
};

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kNoPass = 0xffffffffu;
constexpr int kThreads = 256;        // the largest CTA
constexpr int kBigGridThreads = 128; // the CTA when the grid fills the card many times over
constexpr int kTestRepeat = 1;       // tests a (box, cone) pair; 2 measures their cost
constexpr int kConeIn = 12;  // oc(3) oh(3) axis(3) tan_th t_hi t_len
constexpr int kSortItems = 4;    // keys a lane holds in a sort tile (registers beside the cones)
constexpr int kSortSpread = 512; // lists of 33 to this many keys sorted by every warp at once

enum Mode { kCones = 0, kRays = 1, kExpanded = 2, kFactored = 3 };

// launch shape, worked out by the host entry
struct Shape {
  int L;         // lanes that share a box in the R-cone levels
  int n_slots;   // bounds tree slots
};

struct Cone {
  float oc[3], oh[3], inv[3], sp[3], tan_th, t_hi, t_len, cos_th;
};

// the plain version's cone record: 1/axis, sqrt(1 - axis^2), cos(theta_max)
__device__ Cone make_cone(const float* oc, const float* oh, const float* a, float tan_th,
                          float t_hi, float t_len) {
  Cone c;
  for (int k = 0; k < 3; ++k) {
    const float a_safe = fabsf(a[k]) < 1e-30f ? 1e-30f : a[k];
    c.oc[k] = oc[k];
    c.oh[k] = oh[k];
    c.inv[k] = 1.0f / a_safe;
    c.sp[k] = sqrtf(fmaxf(1.0f - a[k] * a[k], 0.0f));
  }
  c.tan_th = tan_th;
  c.t_hi = t_hi;
  c.t_len = t_len;
  c.cos_th = 1.0f / sqrtf(1.0f + tan_th * tan_th);
  return c;
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// max over axes of min(t0, t1) and min over axes of max(t0, t1)
__device__ __forceinline__ void slab(const Cone& c, const float* b0, const float* b1, float r,
                                     float& tn, float& tf) {
  float mn[3], mx[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rk = r * c.sp[k];
    const float t0 = (b0[k] - rk) * c.inv[k];
    const float t1 = (b1[k] + rk) * c.inv[k];
    mn[k] = fminf(t0, t1);
    mx[k] = fmaxf(t0, t1);
  }
  tn = fmaxf(fmaxf(mn[0], mn[1]), mn[2]);
  tf = fminf(fminf(mx[0], mx[1]), mx[2]);
}

// the part of _cone_box_test that reads only the origin box: the target box
// grown by it (b0, b1) and the boxes' least and greatest distances
struct Gap {
  float b0[3], b1[3], d_near, d_far;
};

__device__ __forceinline__ Gap box_gap(const Cone& c, const float* bmin, const float* bmax) {
  Gap q;
  float g[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.b0[k] = (bmin[k] - c.oh[k]) - c.oc[k];
    q.b1[k] = (bmax[k] + c.oh[k]) - c.oc[k];
    g[k] = fmaxf(fmaxf(q.b0[k], -q.b1[k]), 0.0f);
    s[k] = fmaxf(q.b1[k], -q.b0[k]);
  }
  q.d_near = norm3(g[0], g[1], g[2]);
  q.d_far = norm3(s[0], s[1], s[2]);
  return q;
}

// the rest of _cone_box_test, operation for operation; tn canonical (+0.0
// for <= 0)
__device__ __forceinline__ bool cone_test(const Cone& c, const Gap& q, float& tn_out,
                                          float& tf_out) {
  const float *b0 = q.b0, *b1 = q.b1;
  const float d_near = q.d_near, d_far = q.d_far;
  float tn, tf;
  slab(c, b0, b1, c.t_hi * c.tan_th, tn, tf);
  const float r1 = fminf(fmaxf(tf, 0.0f), c.t_hi) * c.tan_th;
  slab(c, b0, b1, r1, tn, tf);
  const float entry = fmaxf(tn, d_near);
  tf = fminf(tf, d_far);
  tn_out = entry > 0.0f ? entry : 0.0f;
  tf_out = tf;
  return (fmaxf(tn, d_near * c.cos_th) <= tf) & (tf >= 0.0f) & (entry <= c.t_len);
}

__device__ __forceinline__ bool cone_box(const Cone& c, const float* bmin, const float* bmax,
                                         float& tn_out, float& tf_out) {
  return cone_test(c, box_gap(c, bmin, bmax), tn_out, tf_out);
}

// --- bounds ---

// channels of the bounds tree, each n_slots floats
enum Channel { kSum = 0, kLo = 3, kHi = 6, kNrm = 9, kThi = 10, kAny = 11, kCa = 12, kChannels };

struct Ray {
  float o[3], d[3];
  float t_max;
  bool live;
};

// ray i of block blk; kFactored: direction i, every direction counted (the
// block's liveness applies to the cone afterwards, as in fact_bounds)
__device__ Ray fetch_ray(const CullArgs& A, int blk, int i) {
  Ray r;
  const float *o, *d;
  if (A.mode == kRays) {
    const size_t ray = (size_t)blk * A.Rb + i;
    o = A.o + ray * 3;
    d = A.d + ray * 3;
    r.t_max = A.t_max[ray];
    r.live = r.t_max > A.t_min[ray];
  } else {
    d = A.d + ((size_t)blk * A.G + (A.mode == kExpanded ? i / A.P : i)) * 3;
    o = A.o + ((size_t)blk * A.P + (A.mode == kExpanded ? i % A.P : 0)) * 3;
    r.t_max = A.alive[blk] * A.t_max_s;
    r.live = A.mode == kFactored || r.t_max > A.t_min_s;
  }
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[k];
    r.d[k] = d[k];
  }
  return r;
}

// |d| and the unit direction, as the plain version forms them
__device__ __forceinline__ float unit_dir(const float* d, float* dn) {
  const float nrm = sqrtf(fmaxf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2], 1e-30f));
  const float inv = 1.0f / nrm;
  for (int k = 0; k < 3; ++k) dn[k] = d[k] * inv;
  return nrm;
}

// a channel's fold: sums for the direction, least origins and cosine,
// greatest otherwise
__device__ __forceinline__ float fold_op(int c, float a, float b) {
  return c < kLo ? a + b : (c < kHi || c == kCa ? fminf(a, b) : fmaxf(a, b));
}

// fold channels [c0, c1) of every sub-block's W2 slots onto its first slot:
// the halving tree (slot j takes slot j + w), one barrier a step
__device__ void tree_fold(float* chn, int n_slots, int Rp, int W2, int c0, int c1) {
  for (int w = W2 >> 1; w > 0; w >>= 1) {
    __syncthreads();
    for (int t = threadIdx.x; t < Rp * w; t += blockDim.x) {
      const int s = (t / w) * W2 + t % w;
      for (int c = c0; c < c1; ++c) {
        float* x = chn + c * n_slots;
        x[s] = fold_op(c, x[s], x[s + w]);
      }
    }
  }
  __syncthreads();
}

// the same tree when every slot is a thread's (slot s = threadIdx.x, Rp W2
// slots at most blockDim.x): thread s holds channels [c0, c0 + C) of its
// slot in v; strides of 32 and more go through shared memory, one barrier
// a step, the rest by shuffles within the warp, no barrier; each
// sub-block's first slot lands in chn
template <int c0, int C>
__device__ void warp_fold(float (&v)[C], float* chn, int N, int Rp, int W2) {
  const int s = threadIdx.x, j = s % W2;
  const bool mine = s < Rp * W2;
  if (W2 > 32) {
    if (mine)
      for (int c = 0; c < C; ++c) chn[(c0 + c) * N + s] = v[c];
    for (int w = W2 >> 1; w >= 32; w >>= 1) {
      __syncthreads();
      if (mine && j < w) {
        for (int c = 0; c < C; ++c) {
          float* x = chn + (c0 + c) * N;
          x[s] = fold_op(c0 + c, x[s], x[s + w]);
        }
      }
    }
    __syncthreads();
    if (mine && j < 32)
      for (int c = 0; c < C; ++c) v[c] = chn[(c0 + c) * N + s];
  }
  for (int w = (W2 < 32 ? W2 : 32) >> 1; w > 0; w >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = fold_op(c0 + c, v[c], __shfl_down_sync(0xffffffffu, v[c], w));
  }
  if (mine && j == 0)
    for (int c = 0; c < C; ++c) chn[(c0 + c) * N + s] = v[c];
  __syncthreads();
}

// the channels of ray i of block blk (its unit direction in dn), as the
// plain version forms them
__device__ __forceinline__ void ray_channels(const CullArgs& A, int blk, int i, float (&v)[kCa],
                                             float (&dn)[3], bool& live) {
  const Ray r = fetch_ray(A, blk, i);
  const float nrm = unit_dir(r.d, dn);
  for (int k = 0; k < 3; ++k) {
    v[kSum + k] = r.live ? dn[k] : 0.0f;
    v[kLo + k] = r.live ? r.o[k] : kBig;
    v[kHi + k] = r.live ? r.o[k] : -kBig;
  }
  v[kNrm] = r.live ? nrm : 1e-30f;
  v[kThi] = r.live ? r.t_max * nrm : 0.0f;
  v[kAny] = r.live ? 1.0f : 0.0f;
  live = r.live;
}

// Rp sub-block cones of block blk into cones_out (and their n_hi into
// nhi_out when given): the plain version's bounds, margins and scene cap.
__device__ void bounds_pass(const CullArgs& A, const Shape& sh, int blk, int Rp, float* chn,
                            float* s_a, const float* s_obox, Cone* cones_out, float* nhi_out) {
  const int n_rays = A.mode == kFactored ? A.G : A.Rb;
  const int W = n_rays / Rp;
  const int W2 = pow2_at_least(W);
  const int N = sh.n_slots;
  const float inf = __int_as_float(0x7f800000);
  // a slot a thread: the ray's unit direction stays in registers for the
  // cosine pass
  const bool one_slot = Rp * W2 <= (int)blockDim.x;
  float dn[3] = {0.0f, 0.0f, 0.0f};
  bool live_ray = false;
  if (one_slot) {
    const int s = threadIdx.x, j = s % W2;
    float v[kCa] = {0.0f, 0.0f, 0.0f, inf, inf, inf, -inf, -inf, -inf, -inf, -inf, 0.0f};
    if (s < Rp * W2 && j < W) ray_channels(A, blk, (s / W2) * W + j, v, dn, live_ray);
    warp_fold<0>(v, chn, N, Rp, W2);
  } else {
    for (int s = threadIdx.x; s < Rp * W2; s += blockDim.x) {
      float v[kCa] = {0.0f, 0.0f, 0.0f, inf, inf, inf, -inf, -inf, -inf, -inf, -inf, 0.0f};
      const int j = s % W2;
      float d3[3];
      bool live;
      if (j < W) ray_channels(A, blk, (s / W2) * W + j, v, d3, live);
      for (int c = 0; c < kCa; ++c) chn[c * N + s] = v[c];
    }
    tree_fold(chn, N, Rp, W2, 0, kCa);
  }

  // the unit mean direction of each sub-block
  for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
    const float* x = chn + r * W2;
    const float sx = x[(kSum + 0) * N], sy = x[(kSum + 1) * N], sz = x[(kSum + 2) * N];
    const float ainv = 1.0f / sqrtf(fmaxf((sx * sx + sy * sy) + sz * sz, 1e-30f));
    s_a[r * 3 + 0] = sx * ainv;
    s_a[r * 3 + 1] = sy * ainv;
    s_a[r * 3 + 2] = sz * ainv;
  }
  __syncthreads();
  // the least cosine to it over the sub-block's live rays
  if (one_slot) {
    const int s = threadIdx.x, j = s % W2;
    float ca[1] = {inf};
    if (s < Rp * W2 && j < W) {
      const float* a = s_a + (s / W2) * 3;
      ca[0] = live_ray ? (dn[0] * a[0] + dn[1] * a[1]) + dn[2] * a[2] : 1.0f;
    }
    warp_fold<kCa>(ca, chn, N, Rp, W2);
  } else {
    for (int s = threadIdx.x; s < Rp * W2; s += blockDim.x) {
      const int j = s % W2;
      float ca = inf;
      if (j < W) {
        const float* a = s_a + (s / W2) * 3;
        const Ray r = fetch_ray(A, blk, (s / W2) * W + j);
        float d3[3];
        unit_dir(r.d, d3);
        ca = r.live ? (d3[0] * a[0] + d3[1] * a[1]) + d3[2] * a[2] : 1.0f;
      }
      chn[kCa * N + s] = ca;
    }
    tree_fold(chn, N, Rp, W2, kCa, kCa + 1);
  }

  for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
    const float* x = chn + r * W2;
    const bool factored = A.mode == kFactored;
    const bool live = factored ? A.alive[blk] > 0.0f : x[kAny * N] > 0.0f;
    float oc[3], oh[3], axis[3];
    for (int k = 0; k < 3; ++k) {
      const float lo = factored ? s_obox[k] : (live ? x[(kLo + k) * N] : 0.0f);
      const float hi = factored ? s_obox[3 + k] : (live ? x[(kHi + k) * N] : 0.0f);
      oc[k] = 0.5f * (lo + hi);
      oh[k] = 0.5f * (hi - lo);
      oh[k] = oh[k] + (live ? A.origin_margin : 0.0f);  // oh >= +0.0: + 0.0 is exact
      axis[k] = live ? s_a[r * 3 + k] : (k == 0 ? 1.0f : 0.0f);
    }
    const float ca = fminf(fmaxf(x[kCa * N], 0.05f), 1.0f);
    float tan_th = sqrtf(fmaxf(1.0f - ca * ca, 0.0f)) / ca;
    if (A.tan_dm != 0.0f) {
      const float den = 1.0f - tan_th * A.tan_dm;
      tan_th = den > 1e-4f ? (tan_th + A.tan_dm) / fmaxf(den, 1e-4f) : 1e4f;
    }
    const float n_hi = x[kNrm * N];
    float t_hi = factored ? (live ? A.t_max_s : 0.0f) * n_hi : x[kThi * N];
    t_hi = live ? t_hi : 0.0f;
    // the scene-exit cap: one cone-box test against the scene box
    float sc[3], sh3[3], dc[3];
    for (int k = 0; k < 3; ++k) {
      sc[k] = 0.5f * (A.scene_min[k] + A.scene_max[k]);
      sh3[k] = 0.5f * (A.scene_max[k] - A.scene_min[k]);
      dc[k] = oc[k] - sc[k];
    }
    const float t_cap = (norm3(dc[0], dc[1], dc[2]) + norm3(sh3[0], sh3[1], sh3[2]))
                        + norm3(oh[0], oh[1], oh[2]);
    float tn, tf;
    cone_box(make_cone(oc, oh, axis, tan_th, t_cap, t_cap), A.scene_min, A.scene_max, tn, tf);
    const float sec = sqrtf(1.0f + tan_th * tan_th);
    const float t_len = fminf(t_hi, ((tf > 0.0f ? tf : 0.0f) * sec) * 1.0001f + 1e-3f);
    t_hi = fminf(t_hi, tf * 1.0001f + 1e-3f);
    cones_out[r] = make_cone(oc, oh, axis, tan_th, t_hi, t_len);
    if (nhi_out) nhi_out[r] = n_hi;
  }
  __syncthreads();
}

// --- box tests and selection ---

// cone t of a lane's registers (kRegs), else cone c of shared memory
template <bool kRegs, int N>
__device__ __forceinline__ const Cone& cone_at(const Cone (&cn)[N], const Cone* cones, int t,
                                               int c) {
  if constexpr (kRegs)
    return cn[t];
  else
    return cones[c];
}

// A level's tests as key_sort.cuh's `each`: slot i of n is box i, or with
// group_sel member i % Gs of group group_sel[i / Gs]. L lanes share a slot;
// lane q holds the cones q + L*t of the R in shared memory (t < CPL); every
// test runs, failures masked. With kShared every cone has the same origin
// box (the factored front end's), so a lane forms the box's gap once for
// its CPL cones and holds one origin box. The slot's key goes to visit at
// its first lane: packed (bits(tn) & ~idm) | id, else (bits(tn) << sh) | i.
template <int T, int CPL, bool kShared, bool kRegs = true>
__device__ __forceinline__ auto box_tests(const Cone* cones, int R, int L, int n,
                                          const float* boxes, const int* group_sel, int Gs,
                                          int n_ids, int packed, unsigned idm, int sh) {
  return [cones, R, L, n, boxes, group_sel, Gs, n_ids, packed, idm, sh](auto&& visit) {
    const int lane = threadIdx.x & 31;
    // this lane's cones q + L t, in registers for the level (kRegs), else
    // read from shared memory a test; a lane's spare cones are tested and
    // masked
    const int q = lane % L;
    Cone cn[kRegs ? CPL : 1];
    unsigned cmask = 0;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = q + L * t;
      if constexpr (kRegs) cn[t] = cones[c < R ? c : 0];
      if (c < R) cmask |= 1u << t;
    }
    const int per = 32 / L;
    const int stride = (T >> 5) * per;
    const bool leader = lane % L == 0;
    // slot i = g * Gs + r, stepped without a division a step
    int i = (threadIdx.x >> 5) * per + lane / L;
    int g = i / Gs, r = i % Gs;
    const int step_g = stride / Gs, step_r = stride % Gs;
    for (int base = i - lane / L; base < n; base += stride) {
      int id = i;
      bool in_range = i < n;
      if (in_range && group_sel) {
        const int grp = group_sel[g];
        id = grp * Gs + r;
        in_range = grp >= 0 && id < n_ids;
      }
      unsigned bits = kNoPass;
      if (in_range) {
        const float* b = boxes + (size_t)id * 6;
        const float bmin0[3] = {b[0], b[1], b[2]};
        const float bmax0[3] = {b[3], b[4], b[5]};
        Gap shared_gap;
        if constexpr (kShared)
          shared_gap = box_gap(cone_at<kRegs>(cn, cones, 0, q < R ? q : 0), bmin0, bmax0);
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          for (int rep = 0; rep < kTestRepeat; ++rep) {
            float bmin[3], bmax[3], tn, tf;
            for (int k = 0; k < 3; ++k) {
              bmin[k] = bmin0[k];
              bmax[k] = bmax0[k];
              if (rep) asm volatile("" : "+f"(bmin[k]), "+f"(bmax[k]));  // no reuse of rep 0
            }
            const int c = q + L * t;
            const Cone& cone = cone_at<kRegs>(cn, cones, t, c < R ? c : 0);
            Gap gap;
            if constexpr (kShared)
              gap = shared_gap;
            else
              gap = box_gap(cone, bmin, bmax);
            const bool ok = cone_test(cone, gap, tn, tf) & ((cmask >> t) & 1u);
            bits = ok ? min(bits, __float_as_uint(tn)) : bits;
          }
        }
      }
      if (L == 32) {
        bits = __reduce_min_sync(0xffffffffu, bits);
      } else {
        for (int off = L >> 1; off > 0; off >>= 1)
          bits = min(bits, __shfl_xor_sync(0xffffffffu, bits, off));
      }
      const u64 key =
          packed ? (u64)((bits & ~idm) | (unsigned)id) : (((u64)bits << sh) | (unsigned)i);
      visit(leader && bits != kNoPass, key);
      i += stride;
      g += step_g;
      r += step_r;
      if (r >= Gs) {
        r -= Gs;
        ++g;
      }
    }
  };
}

// id and tn of a kept key (see box_tests)
__device__ __forceinline__ int decode(u64 key, int packed, unsigned idm, int sh,
                                      const int* group_sel, int Gs, float* tn) {
  if (packed) {
    const unsigned k32 = (unsigned)key;
    *tn = __uint_as_float(k32 & ~idm);
    return (int)(k32 & idm);
  }
  const int pos = (int)(key & ((1ULL << sh) - 1ULL));
  *tn = __uint_as_float((unsigned)(key >> sh));
  return group_sel ? group_sel[pos / Gs] * Gs + pos % Gs : pos;
}

// floats of the shared region that holds the keys, or the bounds tree
// (even: the cone records after it stay 8-byte aligned)
__host__ __device__ int region_floats(const CullArgs& A, const Shape& sh) {
  const int keys = A.key_slots * 2, tree = sh.n_slots * kChannels;
  return ((keys > tree ? keys : tree) + 1) & ~1;
}

// the dynamic shared bytes that the kernel's layout needs; the launch takes
// ops/cull_cuda.py::cull_launch_plan's and is refused where the two differ
__host__ __device__ size_t shared_bytes(const CullArgs& A, const Shape& sh) {
  return (size_t)region_floats(A, sh) * sizeof(float) + (size_t)(A.R + 1) * sizeof(Cone) +
         (size_t)4 * A.R * sizeof(float) +
         (size_t)((A.ch > 0 ? A.ch : 1) + A.cs + (A.cm > 0 ? A.cm : 1)) * sizeof(int);
}

// CTAs an SM that each build's registers must allow without spilling (T
// threads a CTA, CPL cones a lane, the streamed passes built or not): the
// cap is 65,536 / (T x blocks) registers
constexpr int min_blocks(int T, int cpl, bool stream) {
  return cpl == 1 ? (T == 128 ? (stream ? 6 : 7) : 2)
                  : cpl == 2 ? 512 / T : (T == 128 ? (stream ? 3 : 4) : 1);
}

template <int T, int CPL, bool kShared, bool kStream>
__global__ void __launch_bounds__(T, min_blocks(T, CPL, kStream))
    cull_kernel(const CullArgs A, const Shape sh) {
  extern __shared__ u64 smem[];
  // keys, or the bounds tree before the first level
  const int region = region_floats(A, sh);
  u64* s_keys = smem;
  float* s_chn = reinterpret_cast<float*>(smem);
  Cone* s_cones = reinterpret_cast<Cone*>(reinterpret_cast<float*>(smem) + region);  // R
  Cone* s_fat = s_cones + A.R;
  float* s_nhi = reinterpret_cast<float*>(s_fat + 1);  // R
  float* s_a = s_nhi + A.R;                            // 3 R
  int* s_hyp = reinterpret_cast<int*>(s_a + 3 * A.R);  // max(ch, 1)
  int* s_sup = s_hyp + (A.ch > 0 ? A.ch : 1);          // cs
  int* s_mid = s_sup + A.cs;                            // max(cm, 1)
  __shared__ Scratch s;
  __shared__ float s_obox[6];
  __shared__ int s_sat;
  __shared__ float s_scale;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) s_sat = 0;
  if (A.mode == kCones) {
    for (int r = tid; r <= A.R; r += T) {
      if (r == A.R && A.ch == 0) break;
      const float* in = r < A.R ? A.cones + ((size_t)blk * A.R + r) * kConeIn
                                : A.fat + (size_t)blk * kConeIn;
      s_cones[r] = make_cone(in, in + 3, in + 6, in[9], in[10], in[11]);  // s_cones[R] is s_fat
    }
    if (tid == 0) s_scale = A.n_hi[blk];
    __syncthreads();
  } else {
    if (A.mode == kFactored && tid < 3) {
      const bool live = A.alive[blk] > 0.0f;
      float lo = kBig, hi = -kBig;
      for (int p = 0; p < A.P; ++p) {
        const float v = A.o[((size_t)blk * A.P + p) * 3 + tid];
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      s_obox[tid] = live ? lo : 0.0f;
      s_obox[3 + tid] = live ? hi : 0.0f;
    }
    __syncthreads();
    bounds_pass(A, sh, blk, A.R, s_chn, s_a, s_obox, s_cones, s_nhi);
    if (A.ch > 0) {
      if (A.R > 1) {
        bounds_pass(A, sh, blk, 1, s_chn, s_a, s_obox, s_fat, nullptr);
      } else if (tid == 0) {
        *s_fat = s_cones[0];
      }
    }
    if (tid < 32) {
      float m = -__int_as_float(0x7f800000);
      for (int r = tid; r < A.R; r += 32) m = fmaxf(m, s_nhi[r]);
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (tid == 0) s_scale = m;
    }
    __syncthreads();
  }

  const int L = sh.L;
  // level 0 -> s_sup: the supers, or the hypers and then their supers
  u64* kept;
  float tn;
  int m, sh_pos;
  if (A.ch > 0) {
    sh_pos = bit_width(A.n_hyper - 1);
    m = cull_level<T, kSortItems, kSortSpread, kStream>(
        box_tests<T, 1, false>(s_fat, 1, 1, A.n_hyper, A.hyper_aabb, nullptr, 1, A.n_hyper,
                               A.hyp_packed, A.idm_hyp, sh_pos),
        box_tests<T, 1, false, false>(s_fat, 1, 1, A.n_hyper, A.hyper_aabb, nullptr, 1,
                                      A.n_hyper, A.hyp_packed, A.idm_hyp, sh_pos),
        A.n_hyper, A.ch, A.hyp_packed ? 31 : 31 + sh_pos, s_keys, A.key_slots, s, &kept);
    const int n_hyp = min(m, A.ch);
    for (int k = tid; k < n_hyp; k += T)
      s_hyp[k] = decode(kept[k], A.hyp_packed, A.idm_hyp, sh_pos, nullptr, 1, &tn);
    if (tid == 0) s_sat |= m > A.ch;
    __syncthreads();
    const int n = n_hyp * A.H;
    sh_pos = bit_width(n - 1);
    m = cull_level<T, kSortItems, kSortSpread, kStream>(
        box_tests<T, 1, false>(s_fat, 1, 1, n, A.super_aabb, s_hyp, A.H, A.n_super,
                               A.sup_packed, A.idm_sup, sh_pos),
        box_tests<T, 1, false, false>(s_fat, 1, 1, n, A.super_aabb, s_hyp, A.H, A.n_super,
                                      A.sup_packed, A.idm_sup, sh_pos),
        n, A.cs, A.sup_packed ? 31 : 31 + sh_pos, s_keys, A.key_slots, s, &kept);
    for (int k = tid; k < min(m, A.cs); k += T)
      s_sup[k] = decode(kept[k], A.sup_packed, A.idm_sup, sh_pos, s_hyp, A.H, &tn);
  } else {
    sh_pos = bit_width(A.n_super - 1);
    m = cull_level<T, kSortItems, kSortSpread, kStream>(
        box_tests<T, CPL, kShared>(s_cones, A.R, L, A.n_super, A.super_aabb, nullptr, 1,
                                   A.n_super, 0, 0u, sh_pos),
        box_tests<T, CPL, kShared, false>(s_cones, A.R, L, A.n_super, A.super_aabb, nullptr, 1,
                                          A.n_super, 0, 0u, sh_pos),
        A.n_super, A.cs, 31 + sh_pos, s_keys, A.key_slots, s, &kept);
    for (int k = tid; k < min(m, A.cs); k += T)
      s_sup[k] = decode(kept[k], 0, 0u, sh_pos, nullptr, 1, &tn);
  }
  if (tid == 0) s_sat |= m > A.cs;
  __syncthreads();

  // the groups whose bins level 1 tests: the kept supers, or the kept mids
  const int* groups = s_sup;
  int group_size = A.S;
  int n_groups = min(m, A.cs);
  if (A.cm > 0) {
    const int n = n_groups * A.Sm;
    sh_pos = bit_width(n - 1);
    m = cull_level<T, kSortItems, kSortSpread, kStream>(
        box_tests<T, CPL, kShared>(s_cones, A.R, L, n, A.mid_aabb, s_sup, A.Sm, A.n_mid_ids,
                                   A.mid_packed, A.idm_mid, sh_pos),
        box_tests<T, CPL, kShared, false>(s_cones, A.R, L, n, A.mid_aabb, s_sup, A.Sm,
                                          A.n_mid_ids, A.mid_packed, A.idm_mid, sh_pos),
        n, A.cm, A.mid_packed ? 31 : 31 + sh_pos, s_keys, A.key_slots, s, &kept);
    for (int k = tid; k < min(m, A.cm); k += T)
      s_mid[k] = decode(kept[k], A.mid_packed, A.idm_mid, sh_pos, s_sup, A.Sm, &tn);
    if (tid == 0) s_sat |= m > A.cm;
    __syncthreads();
    groups = s_mid;
    group_size = A.M;
    n_groups = min(m, A.cm);
  }

  // level 1: the kept groups' bins; tnear = the key's tn / n_hi
  const int n = n_groups * group_size;
  const int sh_b = bit_width(n - 1);
  m = cull_level<T, kSortItems, kSortSpread, kStream>(
      box_tests<T, CPL, kShared>(s_cones, A.R, L, n, A.bin_aabb, groups, group_size, A.n_bins,
                                 A.bin_packed, A.idm_bin, sh_b),
      box_tests<T, CPL, kShared, false>(s_cones, A.R, L, n, A.bin_aabb, groups, group_size,
                                        A.n_bins, A.bin_packed, A.idm_bin, sh_b),
      n, A.cb, A.bin_packed ? 31 : 31 + sh_b, s_keys, A.key_slots, s, &kept);
  const int n_kept = min(m, A.cb);
  for (int k = tid; k < A.cb; k += T) {
    const int id = k < n_kept ? decode(kept[k], A.bin_packed, A.idm_bin, sh_b, groups,
                                       group_size, &tn)
                              : -1;
    A.cand_bin[(size_t)blk * A.cb + k] = id;
    A.cand_tnear[(size_t)blk * A.cb + k] = id >= 0 ? tn / s_scale : kBig;
  }
  if (tid == 0) {
    A.cand_count[blk] = n_kept;
    A.sat[blk] = (unsigned char)(s_sat | (m > A.cb));
  }
}

// K3's builds, (threads, cones a lane, origin box shared, streamed passes):
// every width and cone count with the streamed passes, which runs any
// launch; at the big grids' width also one cone a lane without them (64
// registers: 8 CTAs an SM) and four sharing their origin box without them
// (the pose sweep's per-ray cones). A launch runs the first build that can
// take it.
using Kernel = void (*)(const CullArgs, const Shape);

struct Build {
  int threads, cpl, shared, stream;
  Kernel kernel;
};

const Build kBuilds[] = {
    {kBigGridThreads, 1, 0, 0, cull_kernel<kBigGridThreads, 1, false, false>},
    {kBigGridThreads, 4, 1, 0, cull_kernel<kBigGridThreads, 4, true, false>},
    {kBigGridThreads, 1, 0, 1, cull_kernel<kBigGridThreads, 1, false, true>},
    {kBigGridThreads, 2, 0, 1, cull_kernel<kBigGridThreads, 2, false, true>},
    {kBigGridThreads, 4, 0, 1, cull_kernel<kBigGridThreads, 4, false, true>},
    {kThreads, 1, 0, 1, cull_kernel<kThreads, 1, false, true>},
    {kThreads, 2, 0, 1, cull_kernel<kThreads, 2, false, true>},
    {kThreads, 4, 0, 1, cull_kernel<kThreads, 4, false, true>},
};
constexpr int kNumBuilds = sizeof(kBuilds) / sizeof(kBuilds[0]);

}  // namespace

// Plain C entry point (loaded with ctypes). The launch plan (threads, key
// slots, shared bytes, whether a level may outgrow its stage) comes from
// ops/cull_cuda.py::cull_launch_plan; it runs the first of kBuilds that
// can take it. A lane's cones have one origin box in the factored front end
// (every sub-block spans the block's origins) and in the expanded one when
// L x W (W rays a sub-block) is a multiple of P (sub-block r spans origins
// (r W + j) % P, the same for r + L).
// Returns cudaGetLastError() after the launch: 0 on success;
// cudaErrorInvalidValue for more than 128 cones a block, a width other than
// 128 or 256, key slots below a kept list, or shared bytes other than the
// layout's; the attribute's error for shared memory beyond what a CTA may
// hold.
extern "C" int rmcl_cull(const CullArgs* args, void* stream) {
  const CullArgs& A = *args;
  if (A.Cb == 0) return 0;
  if (A.key_slots < std::max(std::max(A.ch, A.cs), std::max(A.cm, A.cb)))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.L = A.R <= 32 ? pow2_at_least(A.R) : 32;
  const int cpl = (A.R + sh.L - 1) / sh.L;
  sh.n_slots = 0;
  if (A.mode != kCones) {
    const int n_rays = A.mode == kFactored ? A.G : A.Rb;
    sh.n_slots = std::max(A.R * pow2_at_least(n_rays / A.R), pow2_at_least(n_rays));
  }
  if (shared_bytes(A, sh) != (size_t)A.smem_bytes) return (int)cudaErrorInvalidValue;
  const size_t smem = A.smem_bytes;
  const bool shared = A.mode == kFactored ||
                      (A.mode == kExpanded && (sh.L * (A.Rb / A.R)) % A.P == 0);
  for (const Build& b : kBuilds) {
    if (b.threads != A.threads || b.cpl != (cpl == 3 ? 4 : cpl) || (b.shared && !shared) ||
        (A.stream && !b.stream))
      continue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          b.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) {
        cudaGetLastError();  // not left for the next launch's check
        return (int)err;
      }
    }
    b.kernel<<<A.Cb, A.threads, smem, (cudaStream_t)stream>>>(A, sh);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Build i of K3's builds: its threads, cones a lane, whether its lane's
// cones share their origin box and whether it holds the streamed passes;
// its registers, local-memory bytes (spills show as local memory) and
// static shared bytes. Returns cudaErrorInvalidValue past the last build,
// else the cudaFuncGetAttributes error.
extern "C" int rmcl_cull_attrs(int i, int* flags, int* regs, int* local_bytes,
                               int* static_smem) {
  if (i < 0 || i >= kNumBuilds) return (int)cudaErrorInvalidValue;
  const Build& b = kBuilds[i];
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, b.kernel);
  if (err != cudaSuccess) return (int)err;
  flags[0] = b.threads;
  flags[1] = b.cpl;
  flags[2] = b.shared;
  flags[3] = b.stream;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  return 0;
}
