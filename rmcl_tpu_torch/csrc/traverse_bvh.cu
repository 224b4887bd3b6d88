// Exact closest-hit traversal of the preorder-threaded BVH (K5).
//
// Replaces the XLA device loop of the JAX package's exact engine,
// rmcl_tpu/ops/raycast.py::_traverse_batch (:73, loop :131-211), and its
// capped-round scheduler _traverse_rounds (:226), whose rounds only
// reschedule that lockstep loop and leave every ray's result bitwise as one
// uncapped run (:240-243). The function, per ray:
//
//   cur = root if t_max > t_min else SENTINEL (the entry rule: a zero-length
//   or inverted segment visits nothing); t_best = t_max; slot = -1;
//   at most n_slots times, while cur != SENTINEL: read slot |cur| (~cur for a
//   leaf link). A leaf is an inline triangle: Moller-Trumbore with the
//   Pallas-form test |det| > 1e-12, u >= -eps, v >= -eps, u + v <= 1 + eps
//   (eps = 1e-7), t > t_min and the strict t < t_best; then follow its miss
//   link. An internal node is an AABB: slab test against the reciprocal
//   direction (1 / (|v| > 1e-20 ? v : 1e-20), so a tiny negative component
//   becomes +1e20, as in the JAX code); descend (hit link) when
//   t_near <= t_far, t_far >= t_min and t_near <= t_best, else skip (miss
//   link).
//
// Outputs: t_best (t_max where nothing was hit) and the winning leaf's slot
// (-1), and on request each ray's visits (internal, leaf).
//
// What bounds it on an H100: memory latency. A visit reads one 64-byte slot
// (four 16-byte loads) whose address depends on the previous visit, then
// does ~30-60 float operations; the building map's table is 62 MB and the
// 1M-face sphere's 128 MB, both above the 50 MB L2, so the dependent loads
// of neighbouring rays are what the kernel waits on. The design is the
// simple one: one thread per ray, 128-thread CTAs, each thread walks its ray
// to completion (no lockstep, so no round scheduling is needed); the slot is
// read as four int4 loads through the read-only path; the leaf/internal
// interpretation branches per thread, and a warp whose rays disagree runs
// both sides (accepted for now). Rays stay in the caller's order: scan rays
// come in coherent runs, so neighbouring threads walk near-identical paths.
// Built with --fmad=false so every product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/ops/traverse_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSent = (int)0x80000000;  // SENTINEL_LINK
constexpr float kEps = 1e-7f;
constexpr float kOnePlusEps = 1.0000001f;
constexpr int kThreads = 128;

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > 1e-20f ? v : 1e-20f);
}

__global__ void __launch_bounds__(kThreads) traverse_bvh_kernel(
    const int4* __restrict__ nodes,     // (n_slots, 16) words as 4 int4 a slot
    const int* __restrict__ root_link,  // ()
    const float* __restrict__ o,        // (R, 3)
    const float* __restrict__ d,        // (R, 3)
    const float* __restrict__ t_min,    // (R,)
    const float* __restrict__ t_max,    // (R,)
    float* __restrict__ t_best_out,     // (R,)
    int* __restrict__ slot_out,         // (R,)
    int* __restrict__ visits_out,       // (R, 2) or null
    int R, int n_slots) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tmin = t_min[r];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = t_max[r];
  int best = -1;
  int cur = t_best > tmin ? __ldg(root_link) : kSent;
  int n_internal = 0, n_leaf = 0;

  for (int c = 0; c < n_slots && cur != kSent; ++c) {
    const bool leaf = cur < 0;
    const int idx = leaf ? ~cur : cur;
    const int4* row = nodes + (size_t)idx * 4;
    const int4 w0 = __ldg(row), w1 = __ldg(row + 1), w3 = __ldg(row + 3);
    if (leaf) {
      const int4 w2 = __ldg(row + 2);
      const float v0x = __int_as_float(w0.x), v0y = __int_as_float(w0.y),
                  v0z = __int_as_float(w0.z);
      const float e1x = __int_as_float(w0.w), e1y = __int_as_float(w1.x),
                  e1z = __int_as_float(w1.y);
      const float e2x = __int_as_float(w1.z), e2y = __int_as_float(w1.w),
                  e2z = __int_as_float(w2.x);
      // the operation order below is the plain version's, term for term
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool det_ok = fabsf(det) > 1e-12f;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      if (det_ok && u >= -kEps && v >= -kEps && u + v <= kOnePlusEps && t > tmin && t < t_best) {
        t_best = t;
        best = idx;
      }
      cur = w3.y;  // miss link, word 13
      ++n_leaf;
    } else {
      const float tx0 = (__int_as_float(w0.x) - ox) * ix;
      const float tx1 = (__int_as_float(w0.w) - ox) * ix;
      const float ty0 = (__int_as_float(w0.y) - oy) * iy;
      const float ty1 = (__int_as_float(w1.x) - oy) * iy;
      const float tz0 = (__int_as_float(w0.z) - oz) * iz;
      const float tz1 = (__int_as_float(w1.y) - oz) * iz;
      const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
      const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      const bool box_hit = t_near <= t_far && t_far >= tmin && t_near <= t_best;
      cur = box_hit ? w3.x : w3.y;  // hit link (word 12) or miss link (13)
      ++n_internal;
    }
  }
  t_best_out[r] = t_best;
  slot_out[r] = best;
  if (visits_out) {
    visits_out[2 * r + 0] = n_internal;
    visits_out[2 * r + 1] = n_leaf;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). nodes must be 16-byte aligned;
// visits may be null. Returns cudaGetLastError() after the launch: 0 on
// success.
extern "C" int rmcl_traverse_bvh(
    const float* nodes, const int* root_link, const float* o, const float* d,
    const float* t_min, const float* t_max, float* t_best, int* slot, int* visits,
    int R, int n_slots, void* stream) {
  if (R == 0) return 0;
  if (((uintptr_t)nodes) % 16) return (int)cudaErrorMisalignedAddress;
  const int grid = (R + kThreads - 1) / kThreads;
  traverse_bvh_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(nodes), root_link, o, d, t_min, t_max, t_best, slot,
      visits, R, n_slots);
  return (int)cudaGetLastError();
}
