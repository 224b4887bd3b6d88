// The exact closest-hit walk of the preorder-threaded BVH (K5), shared by
// the epilogues of traverse_bvh.cu: one thread a ray, the serial walk in
// while-while loops. traverse_bvh.cu's header states the function, what
// bounds it on an H100 and what the design does about it.
//
// Built with --fmad=false so every product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/ops/traverse_cuda.py).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSent = (int)0x80000000;  // SENTINEL_LINK
constexpr float kEps = 1e-7f;
constexpr float kOnePlusEps = 1.0000001f;

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > 1e-20f ? v : 1e-20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// A ray from its origin, unit direction and t_min (the reciprocal
// direction of the slab test derived here).
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz, float tmin) {
  Ray a;
  a.ox = ox;
  a.oy = oy;
  a.oz = oz;
  a.dx = dx;
  a.dy = dy;
  a.dz = dz;
  a.ix = safe_inv(dx);
  a.iy = safe_inv(dy);
  a.iz = safe_inv(dz);
  a.tmin = tmin;
  return a;
}

// A slot's words as the walk reads them: 0-7 and the links 12-15 always,
// 8-11 for a leaf (its last edge component, word 8). The loads are issued
// together before any of them is used, so a warp whose lanes hold both
// kinds waits for one round trip a visit, not one a kind.
struct Slot {
  int4 w0, w1, w2, w3;
};

__device__ __forceinline__ Slot read_slot(const int4* __restrict__ nodes, int idx, bool leaf) {
  const int4* row = nodes + (size_t)idx * 4;
  Slot s;
  s.w0 = __ldg(row);
  s.w1 = __ldg(row + 1);
  s.w3 = __ldg(row + 3);
  if (leaf) s.w2 = __ldg(row + 2);  // a box never reads it
  return s;
}

// Moller-Trumbore on a leaf slot's inline triangle (words 0-8): t, and
// whether the hit passes every gate but the compare with the best.
__device__ __forceinline__ bool leaf_hit(const Slot& s, const Ray& a, float& t) {
  const float v0x = __int_as_float(s.w0.x), v0y = __int_as_float(s.w0.y);
  const float v0z = __int_as_float(s.w0.z), e1x = __int_as_float(s.w0.w);
  const float e1y = __int_as_float(s.w1.x), e1z = __int_as_float(s.w1.y);
  const float e2x = __int_as_float(s.w1.z), e2y = __int_as_float(s.w1.w);
  const float e2z = __int_as_float(s.w2.x);
  // the operation order below is the plain version's, term for term
  const float pvx = a.dy * e2z - a.dz * e2y;
  const float pvy = a.dz * e2x - a.dx * e2z;
  const float pvz = a.dx * e2y - a.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = a.ox - v0x, tvy = a.oy - v0y, tvz = a.oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (a.dx * qvx + a.dy * qvy + a.dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return det_ok && u >= -kEps && v >= -kEps && u + v <= kOnePlusEps && t > a.tmin;
}

// Slab test of an internal slot's box (words 0-5): descend?
__device__ __forceinline__ bool box_enter(const Slot& s, const Ray& a, float t_best) {
  const float tx0 = (__int_as_float(s.w0.x) - a.ox) * a.ix;
  const float tx1 = (__int_as_float(s.w0.w) - a.ox) * a.ix;
  const float ty0 = (__int_as_float(s.w0.y) - a.oy) * a.iy;
  const float ty1 = (__int_as_float(s.w1.x) - a.oy) * a.iy;
  const float tz0 = (__int_as_float(s.w0.z) - a.oz) * a.iz;
  const float tz1 = (__int_as_float(s.w1.y) - a.oz) * a.iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= a.tmin && t_near <= t_best;
}

// One visit of the serial walk at link cur (leaf: cur < 0).
__device__ __forceinline__ void serial_visit(const int4* __restrict__ nodes, const Ray& a,
                                             int& cur, float& t_best, int& best,
                                             int& n_internal, int& n_leaf) {
  const bool leaf = cur < 0;
  const int idx = leaf ? ~cur : cur;
  const Slot s = read_slot(nodes, idx, leaf);
  if (leaf) {
    float t;
    if (leaf_hit(s, a, t) && t < t_best) {
      t_best = t;
      best = idx;
    }
    cur = s.w3.y;  // miss link, word 13
    ++n_leaf;
  } else {
    cur = box_enter(s, a, t_best) ? s.w3.x : s.w3.y;  // hit link (word 12) or miss link (13)
    ++n_internal;
  }
}

// The serial walk of ray a from t_best = its t_max, in while-while loops: a
// lane steps boxes while it holds one, then leaves while it holds one, and
// the warp reconverges between the two loops, so its lanes test boxes
// together and leaves together. Leaves t_best (t_max where nothing was
// hit), the winning leaf's slot in best (-1) and the visits.
__device__ __forceinline__ void walk(const int4* __restrict__ nodes,
                                     const int* __restrict__ root_link, const Ray& a,
                                     int n_slots, float& t_best, int& best, int& n_internal,
                                     int& n_leaf) {
  int cur = t_best > a.tmin ? __ldg(root_link) : kSent;
  int c = 0;
  while (c < n_slots && cur != kSent) {
    while (c < n_slots && cur >= 0) {
      serial_visit(nodes, a, cur, t_best, best, n_internal, n_leaf);
      ++c;
    }
    while (c < n_slots && cur < 0 && cur != kSent) {
      serial_visit(nodes, a, cur, t_best, best, n_internal, n_leaf);
      ++c;
    }
  }
}

}  // namespace
