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
// What bounds it on an H100: the cone-box tests, ~89 float instructions
// each, R x (bins of the kept supers) per block at level 1 (the pose sweep:
// 128 cones x up to 384 bins); a block reads a few KB of rays and boxes
// (the boxes L2-resident), so it is bound by float32 instruction
// throughput. The design:
//   * one CTA per block, 128 threads when the grid is big (several CTAs an
//     SM, so one CTA's barriers and selections overlap another's tests),
//     256 when it is not; the bounds are reduced in shared memory,
//     channel-major, one halving step per barrier;
//   * the tests spread over (box, cone) pairs: L lanes share a box, each
//     lane holds its R / L cones in registers for the whole level and runs
//     their tests without branches, so they interleave; a test reads only
//     the box (a broadcast); the OR and the least tn over cones meet by one
//     redux (or shuffles) on tn's bits (tn >= +0.0, canonical, so the
//     unsigned order is the float order);
//   * passing boxes are compacted by ballot and popcount (one shared atomic
//     per warp step with a pass), and only the compacted keys are sorted:
//     up to 32 by one warp's shuffles, more by a bitonic sort in shared
//     memory; keys are unique, so the order is the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "key_sort.cuh"

// the kernel's arguments, mirrored field for field by ops/cull_cuda.py::_CullArgs
// (outside the anonymous namespace: the exported entry point takes it)
struct CullArgs {
  const float* cones;  // kCones: (Cb, R, 11), fat (Cb, 11), n_hi (Cb,)
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
  unsigned idm_hyp, idm_sup, idm_bin, idm_mid;
  int hyp_packed, sup_packed, bin_packed, mid_packed;
  float t_min_s, t_max_s, origin_margin, tan_dm;
};

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kNoPass = 0xffffffffu;
constexpr int kThreads = 256;        // the largest CTA (its launch bounds)
constexpr int kBigGridThreads = 128; // the CTA when the grid fills the card many times over
constexpr int kBigGrid = 1024;       // blocks from which a grid counts as big
constexpr int kMinBlocks = 2;        // CTAs of kThreads an SM with 2-4 cones a lane (no spills)
constexpr int kTestRepeat = 1;       // tests a (box, cone) pair; 2 measures their cost
constexpr int kConeIn = 11;  // oc(3) oh(3) axis(3) tan_th t_hi

enum Mode { kCones = 0, kRays = 1, kExpanded = 2, kFactored = 3 };

// launch shape, worked out by the host entry
struct Shape {
  int L;         // lanes that share a box in the R-cone levels
  int n_slots;   // bounds tree slots
  int key_cap;   // key slots (a power of two)
};

struct Cone {
  float oc[3], oh[3], inv[3], sp[3], tan_th, t_hi, r0;
};

// the plain version's cone record: 1/axis, sqrt(1 - axis^2), t_hi * tan
__device__ Cone make_cone(const float* oc, const float* oh, const float* a, float tan_th,
                          float t_hi) {
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
  c.r0 = t_hi * tan_th;
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

// _cone_box_test operation for operation; tn canonical (+0.0 for <= 0)
__device__ __forceinline__ bool cone_box(const Cone& c, const float* bmin, const float* bmax,
                                         float& tn_out, float& tf_out) {
  float b0[3], b1[3], g[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b0[k] = (bmin[k] - c.oh[k]) - c.oc[k];
    b1[k] = (bmax[k] + c.oh[k]) - c.oc[k];
    g[k] = fmaxf(fmaxf(b0[k], -b1[k]), 0.0f);
    s[k] = fmaxf(b1[k], -b0[k]);
  }
  const float d_near = norm3(g[0], g[1], g[2]);
  const float d_far = norm3(s[0], s[1], s[2]);
  float tn, tf;
  slab(c, b0, b1, c.r0, tn, tf);
  const float r1 = fminf(fmaxf(tf, 0.0f), c.t_hi) * c.tan_th;
  slab(c, b0, b1, r1, tn, tf);
  tn = fmaxf(tn, d_near);
  tf = fminf(tf, d_far);
  tn_out = tn > 0.0f ? tn : 0.0f;
  tf_out = tf;
  return (tn <= tf) & (tf >= 0.0f) & (tn <= c.t_hi) & (d_near <= c.t_hi);
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

// fold channels [c0, c1) of every sub-block's W2 slots onto its first slot:
// the halving tree (slot j takes slot j + w), one barrier a step
__device__ void tree_fold(float* chn, int n_slots, int Rp, int W2, int c0, int c1) {
  for (int w = W2 >> 1; w > 0; w >>= 1) {
    __syncthreads();
    for (int t = threadIdx.x; t < Rp * w; t += blockDim.x) {
      const int s = (t / w) * W2 + t % w;
      for (int c = c0; c < c1; ++c) {
        float* x = chn + c * n_slots;
        const float a = x[s], b = x[s + w];
        x[s] = c < kLo ? a + b : (c < kHi || c == kCa ? fminf(a, b) : fmaxf(a, b));
      }
    }
  }
  __syncthreads();
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
  for (int s = threadIdx.x; s < Rp * W2; s += blockDim.x) {
    float v[kCa] = {0.0f, 0.0f, 0.0f, inf, inf, inf, -inf, -inf, -inf, -inf, -inf, 0.0f};
    const int j = s % W2;
    if (j < W) {
      const Ray r = fetch_ray(A, blk, (s / W2) * W + j);
      float dn[3];
      const float nrm = unit_dir(r.d, dn);
      for (int k = 0; k < 3; ++k) {
        v[kSum + k] = r.live ? dn[k] : 0.0f;
        v[kLo + k] = r.live ? r.o[k] : kBig;
        v[kHi + k] = r.live ? r.o[k] : -kBig;
      }
      v[kNrm] = r.live ? nrm : 1e-30f;
      v[kThi] = r.live ? r.t_max * nrm : 0.0f;
      v[kAny] = r.live ? 1.0f : 0.0f;
    }
    for (int c = 0; c < kCa; ++c) chn[c * N + s] = v[c];
  }
  tree_fold(chn, N, Rp, W2, 0, kCa);

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
  for (int s = threadIdx.x; s < Rp * W2; s += blockDim.x) {
    const int j = s % W2;
    float ca = inf;
    if (j < W) {
      const float* a = s_a + (s / W2) * 3;
      const Ray r = fetch_ray(A, blk, (s / W2) * W + j);
      float dn[3];
      unit_dir(r.d, dn);
      ca = r.live ? (dn[0] * a[0] + dn[1] * a[1]) + dn[2] * a[2] : 1.0f;
    }
    chn[kCa * N + s] = ca;
  }
  tree_fold(chn, N, Rp, W2, kCa, kCa + 1);

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
    cone_box(make_cone(oc, oh, axis, tan_th, t_cap), A.scene_min, A.scene_max, tn, tf);
    t_hi = fminf(t_hi, tf * 1.0001f + 1e-3f);
    cones_out[r] = make_cone(oc, oh, axis, tan_th, t_hi);
    if (nhi_out) nhi_out[r] = n_hi;
  }
  __syncthreads();
}

// --- box tests and selection ---

// Test the n slots of one level and append the passing ones' keys to keys[]
// (s_count counts them). Slot i is box i, or with group_sel member i % Gs of
// group group_sel[i / Gs]. L lanes share a slot; lane q holds the cones
// q + L*t (t < CPL, those set in cmask).
// Test the n slots of one level and append the passing ones' keys to keys[]
// (s_count counts them). Slot i is box i, or with group_sel member i % Gs of
// group group_sel[i / Gs]. L lanes share a slot; lane q holds the cones
// q + L*t (t < CPL, those set in cmask); every test runs, failures masked.
template <int CPL>
__device__ void test_level(const Cone (&cn)[CPL], unsigned cmask, int L, int n,
                           const float* __restrict__ boxes, const int* group_sel, int Gs,
                           int n_ids, int packed, unsigned idm, unsigned long long* keys,
                           int* s_count) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / L;
  const int stride = (blockDim.x >> 5) * per;
  const unsigned below = (1u << lane) - 1u;
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
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        for (int rep = 0; rep < kTestRepeat; ++rep) {
          float bmin[3], bmax[3], tn, tf;
          for (int k = 0; k < 3; ++k) {
            bmin[k] = bmin0[k];
            bmax[k] = bmax0[k];
            if (rep) asm volatile("" : "+f"(bmin[k]), "+f"(bmax[k]));  // no reuse of rep 0
          }
          const bool ok = cone_box(cn[t], bmin, bmax, tn, tf) & ((cmask >> t) & 1u);
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
    const bool pass = leader && bits != kNoPass;
    const unsigned ballot = __ballot_sync(0xffffffffu, pass);
    if (ballot) {
      int at = 0;
      if (lane == 0) at = atomicAdd(s_count, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (pass) {
        keys[at + __popc(ballot & below)] =
            packed ? (unsigned long long)((bits & ~idm) | (unsigned)id)
                   : (((unsigned long long)bits << 32) | (unsigned)i);
      }
    }
    i += stride;
    g += step_g;
    r += step_r;
    if (r >= Gs) {
      r -= Gs;
      ++g;
    }
  }
}

// id and tn of sorted key k of m (id -1 and tn 3e38 past m)
__device__ void decode(const unsigned long long* keys, int k, int m, int packed, unsigned idm,
                       const int* group_sel, int Gs, int* id, float* tn) {
  if (k >= m) {
    *id = -1;
    *tn = kBig;
    return;
  }
  const unsigned long long key = keys[k];
  if (packed) {
    const unsigned k32 = (unsigned)key;
    *id = (int)(k32 & idm);
    *tn = __uint_as_float(k32 & ~idm);
  } else {
    const int pos = (int)(key & 0xffffffffu);
    *id = group_sel ? group_sel[pos / Gs] * Gs + pos % Gs : pos;
    *tn = __uint_as_float((unsigned)(key >> 32));
  }
}

// floats of the shared region that holds the keys, or the bounds tree
__host__ __device__ int region_floats(const Shape& sh) {
  const int keys = sh.key_cap * 2, tree = sh.n_slots * kChannels;
  return keys > tree ? keys : tree;
}

template <int CPL>
// one cone a lane fits three CTAs an SM without spills
__global__ void __launch_bounds__(kThreads, CPL == 1 ? 3 : kMinBlocks)
    cull_kernel(const CullArgs A, const Shape sh) {
  extern __shared__ unsigned long long smem[];
  // keys, or the bounds tree before the first level
  const int region = region_floats(sh);
  unsigned long long* s_keys = smem;
  float* s_chn = reinterpret_cast<float*>(smem);
  Cone* s_cones = reinterpret_cast<Cone*>(reinterpret_cast<float*>(smem) + region);  // R
  Cone* s_fat = s_cones + A.R;
  float* s_nhi = reinterpret_cast<float*>(s_fat + 1);  // R
  float* s_a = s_nhi + A.R;                            // 3 R
  int* s_hyp = reinterpret_cast<int*>(s_a + 3 * A.R);  // max(ch, 1)
  int* s_sup = s_hyp + (A.ch > 0 ? A.ch : 1);          // cs
  int* s_mid = s_sup + A.cs;                            // max(cm, 1)
  __shared__ float s_obox[6];
  __shared__ int s_count;
  __shared__ int s_sat;
  __shared__ float s_scale;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_count = 0;
    s_sat = 0;
  }
  if (A.mode == kCones) {
    for (int r = tid; r <= A.R; r += blockDim.x) {
      if (r == A.R && A.ch == 0) break;
      const float* in = r < A.R ? A.cones + ((size_t)blk * A.R + r) * kConeIn
                                : A.fat + (size_t)blk * kConeIn;
      s_cones[r] = make_cone(in, in + 3, in + 6, in[9], in[10]);  // s_cones[R] is s_fat
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

  // this lane's sub-block cones, in registers for the R-cone levels
  const int L = sh.L;
  const int q = (tid & 31) % L;
  Cone cn[CPL];
  unsigned cmask = 0;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int c = q + L * t;
    cn[t] = s_cones[c < A.R ? c : 0];  // a lane's spare cones are tested and masked
    if (c < A.R) cmask |= 1u << t;
  }

  // level 0 -> s_sup
  int m;
  if (A.ch > 0) {
    const Cone fat[1] = {*s_fat};
    test_level<1>(fat, 1u, 1, A.n_hyper, A.hyper_aabb, nullptr, 1, A.n_hyper, A.hyp_packed,
                  A.idm_hyp, s_keys, &s_count);
    m = take_count(&s_count);
    sort_keys(s_keys, m);
    for (int k = tid; k < A.ch; k += blockDim.x) {
      float tn;
      decode(s_keys, k, m, A.hyp_packed, A.idm_hyp, nullptr, 1, s_hyp + k, &tn);
    }
    if (tid == 0) s_sat |= m > A.ch;
    __syncthreads();
    test_level<1>(fat, 1u, 1, min(m, A.ch) * A.H, A.super_aabb, s_hyp, A.H, A.n_super,
                  A.sup_packed, A.idm_sup, s_keys, &s_count);
    m = take_count(&s_count);
    sort_keys(s_keys, m);
    for (int k = tid; k < A.cs; k += blockDim.x) {
      float tn;
      decode(s_keys, k, m, A.sup_packed, A.idm_sup, s_hyp, A.H, s_sup + k, &tn);
    }
  } else {
    test_level<CPL>(cn, cmask, L, A.n_super, A.super_aabb, nullptr, 1, A.n_super, 0, 0u,
                    s_keys, &s_count);
    m = take_count(&s_count);
    sort_keys(s_keys, m);
    for (int k = tid; k < A.cs; k += blockDim.x) {
      float tn;
      decode(s_keys, k, m, 0, 0u, nullptr, 1, s_sup + k, &tn);
    }
  }
  if (tid == 0) s_sat |= m > A.cs;
  __syncthreads();

  // the groups whose bins level 1 tests: the kept supers, or the kept mids
  const int* groups = s_sup;
  int group_size = A.S;
  int n_groups = min(m, A.cs);
  if (A.cm > 0) {
    test_level<CPL>(cn, cmask, L, n_groups * A.Sm, A.mid_aabb, s_sup, A.Sm, A.n_mid_ids,
                    A.mid_packed, A.idm_mid, s_keys, &s_count);
    m = take_count(&s_count);
    sort_keys(s_keys, m);
    for (int k = tid; k < A.cm; k += blockDim.x) {
      float tn;
      decode(s_keys, k, m, A.mid_packed, A.idm_mid, s_sup, A.Sm, s_mid + k, &tn);
    }
    if (tid == 0) s_sat |= m > A.cm;
    __syncthreads();
    groups = s_mid;
    group_size = A.M;
    n_groups = min(m, A.cm);
  }

  // level 1: the kept groups' bins
  test_level<CPL>(cn, cmask, L, n_groups * group_size, A.bin_aabb, groups, group_size, A.n_bins,
                  A.bin_packed, A.idm_bin, s_keys, &s_count);
  m = take_count(&s_count);
  sort_keys(s_keys, m);
  for (int k = tid; k < A.cb; k += blockDim.x) {
    int id;
    float tn;
    decode(s_keys, k, m, A.bin_packed, A.idm_bin, groups, group_size, &id, &tn);
    A.cand_bin[(size_t)blk * A.cb + k] = id;
    A.cand_tnear[(size_t)blk * A.cb + k] = id >= 0 ? tn / s_scale : kBig;
  }
  if (tid == 0) {
    A.cand_count[blk] = min(m, A.cb);
    A.sat[blk] = (unsigned char)(s_sat | (m > A.cb));
  }
}

template <int CPL>
int launch(const CullArgs& A, const Shape& sh, size_t smem, cudaStream_t stream) {
  // small CTAs for big grids: more of them an SM, so one CTA's barriers and
  // selections overlap another's box tests; big CTAs fill small grids
  const int threads = A.Cb >= kBigGrid ? kBigGridThreads : kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cull_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cull_kernel<CPL><<<A.Cb, threads, smem, stream>>>(A, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success; cudaErrorInvalidValue for more than 128 cones a
// block.
extern "C" int rmcl_cull(const CullArgs* args, void* stream) {
  const CullArgs& A = *args;
  if (A.Cb == 0) return 0;
  Shape sh;
  sh.L = A.R <= 32 ? pow2_at_least(A.R) : 32;
  const int cpl = (A.R + sh.L - 1) / sh.L;
  sh.n_slots = 0;
  if (A.mode != kCones) {
    const int n_rays = A.mode == kFactored ? A.G : A.Rb;
    sh.n_slots = std::max(A.R * pow2_at_least(n_rays / A.R), pow2_at_least(n_rays));
  }
  // level 1's keys (and the mid level's), then level 0's
  int slots = A.cm > 0 ? std::max(A.cs * A.Sm, A.cm * A.M) : A.cs * A.S;
  if (A.ch > 0) {
    slots = std::max(slots, std::max(A.n_hyper, A.ch * A.H));
  } else {
    slots = std::max(slots, A.n_super);
  }
  sh.key_cap = pow2_at_least(std::max(slots, 32));  // the warp sort writes 32
  const size_t smem = (size_t)region_floats(sh) * sizeof(float) + (size_t)(A.R + 1) * sizeof(Cone) +
                      (size_t)4 * A.R * sizeof(float) +
                      (size_t)((A.ch > 0 ? A.ch : 1) + A.cs + (A.cm > 0 ? A.cm : 1)) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  switch (cpl) {
    case 1: return launch<1>(A, sh, smem, s);
    case 2: return launch<2>(A, sh, smem, s);
    case 3:
    case 4: return launch<4>(A, sh, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers and local-memory bytes a thread (spills show as local memory) of
// the kernel built for `cpl` cones a lane (1, 2 or 4). Returns the
// cudaFuncGetAttributes error.
extern "C" int rmcl_cull_attrs(int cpl, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (cpl) {
    case 1: err = cudaFuncGetAttributes(&a, cull_kernel<1>); break;
    case 2: err = cudaFuncGetAttributes(&a, cull_kernel<2>); break;
    case 4: err = cudaFuncGetAttributes(&a, cull_kernel<4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
