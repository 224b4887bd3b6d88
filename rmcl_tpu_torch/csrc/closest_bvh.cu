// Exact closest point on the mesh over the preorder-threaded BVH (K6).
//
// Replaces the XLA device loop of rmcl_tpu/ops/closest_point.py::_query_batch
// (:154, loop :172-225). The function, per query q with bound max_d2:
//
//   cur = root; best_d2 = max_d2; best point 0; slot = -1;
//   at most n_slots times, while cur != SENTINEL: read slot |cur|. A leaf is
//   an inline triangle: its closest point p = a + v * ab + w * ac (Ericson,
//   ericson.cuh) and d2 = |q - p|^2, taken when d2 < best_d2 (strict); then
//   its miss link. An internal node is an AABB: descend (hit link) when the
//   squared distance from q to the box is < best_d2, else skip (miss link).
//
// Outputs: best_d2, the best point (0 where none), the winning leaf's slot
// (-1), and on request each query's visits (internal, leaf).
//
// What bounds it on an H100: as K5 (traverse_bvh.cu), the latency of
// dependent 64-byte slot reads from tables above the L2's size; a leaf costs
// ~90 float operations, an internal node ~15. The design is K5's: one thread
// per query, 128-thread CTAs, a query walked to completion, a slot read as
// four int4 loads through the read-only path, the leaf/internal branch taken
// per thread. Queries stay in the caller's order (closest_points_seeded
// sorts them by their bound first, so a warp's queries do similar work).
// Built with --fmad=false so every product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/ops/closest_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ericson.cuh"

namespace {

constexpr int kSent = (int)0x80000000;  // SENTINEL_LINK
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) closest_bvh_kernel(
    const int4* __restrict__ nodes,     // (n_slots, 16) words as 4 int4 a slot
    const int* __restrict__ root_link,  // ()
    const float* __restrict__ q,        // (R, 3)
    const float* __restrict__ max_d2,   // (R,)
    float* __restrict__ best_d2_out,    // (R,)
    float* __restrict__ point_out,      // (R, 3)
    int* __restrict__ slot_out,         // (R,)
    int* __restrict__ visits_out,       // (R, 2) or null
    int R, int n_slots) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float qx = q[3 * r + 0], qy = q[3 * r + 1], qz = q[3 * r + 2];
  float best_d2 = max_d2[r];
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  int best = -1;
  int cur = __ldg(root_link);
  int n_internal = 0, n_leaf = 0;

  for (int c = 0; c < n_slots && cur != kSent; ++c) {
    const bool leaf = cur < 0;
    const int idx = leaf ? ~cur : cur;
    const int4* row = nodes + (size_t)idx * 4;
    const int4 w0 = __ldg(row), w1 = __ldg(row + 1), w3 = __ldg(row + 3);
    if (leaf) {
      const int4 w2 = __ldg(row + 2);
      const float ax = __int_as_float(w0.x), ay = __int_as_float(w0.y), az = __int_as_float(w0.z);
      const float abx = __int_as_float(w0.w), aby = __int_as_float(w1.x),
                  abz = __int_as_float(w1.y);
      const float acx = __int_as_float(w1.z), acy = __int_as_float(w1.w),
                  acz = __int_as_float(w2.x);
      float v, w;
      ericson_vw(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz, v, w);
      const float px = ax + v * abx + w * acx;
      const float py = ay + v * aby + w * acy;
      const float pz = az + v * abz + w * acz;
      const float ex = qx - px, ey = qy - py, ez = qz - pz;
      const float d2 = ex * ex + ey * ey + ez * ez;
      if (d2 < best_d2) {
        best_d2 = d2;
        bx = px;
        by = py;
        bz = pz;
        best = idx;
      }
      cur = w3.y;  // miss link, word 13
      ++n_leaf;
    } else {
      const float cx = fminf(fmaxf(qx, __int_as_float(w0.x)), __int_as_float(w0.w)) - qx;
      const float cy = fminf(fmaxf(qy, __int_as_float(w0.y)), __int_as_float(w1.x)) - qy;
      const float cz = fminf(fmaxf(qz, __int_as_float(w0.z)), __int_as_float(w1.y)) - qz;
      const float d2_box = cx * cx + cy * cy + cz * cz;
      cur = d2_box < best_d2 ? w3.x : w3.y;  // hit link (word 12) or miss link (13)
      ++n_internal;
    }
  }
  best_d2_out[r] = best_d2;
  point_out[3 * r + 0] = bx;
  point_out[3 * r + 1] = by;
  point_out[3 * r + 2] = bz;
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
extern "C" int rmcl_closest_bvh(
    const float* nodes, const int* root_link, const float* q, const float* max_d2,
    float* best_d2, float* point, int* slot, int* visits, int R, int n_slots, void* stream) {
  if (R == 0) return 0;
  if (((uintptr_t)nodes) % 16) return (int)cudaErrorMisalignedAddress;
  const int grid = (R + kThreads - 1) / kThreads;
  closest_bvh_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(nodes), root_link, q, max_d2, best_d2, point, slot, visits,
      R, n_slots);
  return (int)cudaGetLastError();
}
