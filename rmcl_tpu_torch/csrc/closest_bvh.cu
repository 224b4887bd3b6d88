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
// ~90 float operations, an internal node ~15. A slot is read as four int4
// loads through the read-only path. Two walks, by the wrapper's split P
// (ops/closest_cuda.py::walk_split):
//
// * P = 1, the serial walk above, one thread a query (where queries are
//   many and fill the card), stepped in the two-loop form (Aila and Laine's
//   while-while on a stackless walk): a warp steps the lanes that hold an
//   internal node until at least kLeafBatch of its 32 lanes, or all its
//   walking ones, hold a leaf, and then tests the leaves together, so one
//   lane at a leaf no longer stalls the others at boxes every step. Each
//   lane visits the same slots in the same order as the one-loop walk, so
//   the results and visits are the same (on an H100 the two-loop form
//   walked 14.4M queries in 8.75 ms against the one-loop form's 9.04;
//   PERF.md).
//
// * P = 2, 4 or 8: P adjacent lanes share a query (where queries are few).
//   Lane p walks one subtree of a frontier of P subtrees that covers the BVH
//   in preorder: from the root, lane p's bits, highest first, pick the first
//   (0) or second (1) child for log2(P) levels; a leaf met above that depth
//   goes to the lane whose remaining bits are 0, and the others get nothing.
//   A subtree ends at its root's miss link (every skip inside it lands
//   there). Each lane derives its subtree from the top links (two slot reads
//   a level, L2-resident) when it starts, so nothing is cached on the host.
//   The best is the pair (d2, slot), from (max_d2, -1): a leaf is taken when
//   its pair is lexicographically smaller, a box is entered when d2_box <=
//   best_d2, and after every step the P lanes meet by __shfl_xor_sync (lanes
//   that have finished keep joining). The walk is then the plain version's
//   step for step. It returns the first leaf in preorder at the least d2
//   (an equal-distance leaf of a lower slot is never pruned), which is the
//   serial walk's winner wherever every leaf's d2 is at least its
//   ancestors' box d2, since those boxes then lie at d2_box <= min <
//   best_d2 until it is found. Float rounding breaks that premise at
//   near-ties, where a leaf's point rounds outside its box; there the two
//   walks may prune differently and return different leaves. On an H100
//   (PERF.md) that happened for 5 of phase 8's first 14,400 queries
//   (0.035%) at every P > 1, with distances within 15 float32 spacings,
//   and for none of phase 9's 14.4M; the tests allow at most 1% of the
//   queries and 1e-5 relative (tests/test_torch_closest_point.py
//   characterises each such query). The winner's point is recomputed from
//   its slot with the serial walk's arithmetic.
//
// Built with --fmad=false so every product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/ops/closest_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ericson.cuh"

namespace {

constexpr int kSent = (int)0x80000000;  // SENTINEL_LINK
constexpr int kThreads = 128;
constexpr int kLeafBatch = 16;

// The closest point on the leaf triangle in slot row (words 0-8) and its d2.
__device__ __forceinline__ float leaf_point(const int4* row, float qx, float qy, float qz,
                                            float& px, float& py, float& pz) {
  const int4 w0 = __ldg(row), w1 = __ldg(row + 1), w2 = __ldg(row + 2);
  const float ax = __int_as_float(w0.x), ay = __int_as_float(w0.y), az = __int_as_float(w0.z);
  const float abx = __int_as_float(w0.w), aby = __int_as_float(w1.x), abz = __int_as_float(w1.y);
  const float acx = __int_as_float(w1.z), acy = __int_as_float(w1.w), acz = __int_as_float(w2.x);
  float v, w;
  ericson_vw(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz, v, w);
  px = ax + v * abx + w * acx;
  py = ay + v * aby + w * acy;
  pz = az + v * abz + w * acz;
  const float ex = qx - px, ey = qy - py, ez = qz - pz;
  return ex * ex + ey * ey + ez * ez;
}

// Squared distance from q to the internal node's box (words 0-5).
__device__ __forceinline__ float box_d2(const int4* row, float qx, float qy, float qz) {
  const int4 w0 = __ldg(row), w1 = __ldg(row + 1);
  const float cx = fminf(fmaxf(qx, __int_as_float(w0.x)), __int_as_float(w0.w)) - qx;
  const float cy = fminf(fmaxf(qy, __int_as_float(w0.y)), __int_as_float(w1.x)) - qy;
  const float cz = fminf(fmaxf(qz, __int_as_float(w0.z)), __int_as_float(w1.y)) - qz;
  return cx * cx + cy * cy + cz * cz;
}

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
  const int t = blockIdx.x * kThreads + threadIdx.x;
  // threads past the last query walk nothing, but stay for the warp votes
  const bool live = t < R;
  const int r = min(t, R - 1);
  const float qx = q[3 * r + 0], qy = q[3 * r + 1], qz = q[3 * r + 2];
  float best_d2 = max_d2[r];
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  int best = -1;
  int cur = live ? __ldg(root_link) : kSent;
  int n_internal = 0, n_leaf = 0;

  for (int c = 0;;) {
    const bool walking = c < n_slots && cur != kSent;
    const bool leaf = cur < 0;
    const unsigned act = __ballot_sync(0xffffffffu, walking);
    if (!act) break;
    const unsigned leaves = __ballot_sync(0xffffffffu, walking && leaf);
    // this step tests leaves only, or steps boxes only
    const bool leaf_step = leaves == act || __popc(leaves) >= kLeafBatch;
    if (!walking || leaf != leaf_step) continue;
    const int idx = leaf ? ~cur : cur;
    const int4* row = nodes + (size_t)idx * 4;
    const int4 w3 = __ldg(row + 3);
    if (leaf) {
      float px, py, pz;
      const float d2 = leaf_point(row, qx, qy, qz, px, py, pz);
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
      cur = box_d2(row, qx, qy, qz) < best_d2 ? w3.x : w3.y;  // hit (12) or miss (13)
      ++n_internal;
    }
    ++c;
  }
  if (!live) return;
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

template <int P>
__global__ void __launch_bounds__(kThreads) closest_bvh_split_kernel(
    const int4* __restrict__ nodes, const int* __restrict__ root_link,
    const float* __restrict__ q, const float* __restrict__ max_d2,
    float* __restrict__ best_d2_out, float* __restrict__ point_out, int* __restrict__ slot_out,
    int* __restrict__ visits_out, int R, int n_slots) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int p = t & (P - 1);
  // lanes past the last query walk nothing, but stay for the shuffles
  const bool live = t / P < R;
  const int r = min(t / P, R - 1);
  const float qx = q[3 * r + 0], qy = q[3 * r + 1], qz = q[3 * r + 2];
  float best_d2 = max_d2[r];
  int best = -1;

  // this lane's subtree of the frontier: [cur, end) in preorder
  int cur = __ldg(root_link), end = kSent;
  for (int bit = P >> 1; bit > 0 && cur != end; bit >>= 1) {
    if (cur < 0) {  // a leaf above the frontier's depth
      if (p & bit) cur = end;
      continue;
    }
    const int hit = __ldg(reinterpret_cast<const int*>(nodes + (size_t)cur * 4) + 12);
    const int first = hit < 0 ? ~hit : hit;
    const int second = __ldg(reinterpret_cast<const int*>(nodes + (size_t)first * 4) + 13);
    if (p & bit) {
      cur = second;
    } else {
      cur = hit;
      end = second;
    }
  }
  if (!live) cur = end;

  int n_internal = 0, n_leaf = 0;
  for (int c = 0; c < n_slots; ++c) {
    const bool walking = cur != end;
    if (!__any_sync(0xffffffffu, walking)) break;
    if (walking) {
      const bool leaf = cur < 0;
      const int idx = leaf ? ~cur : cur;
      const int4* row = nodes + (size_t)idx * 4;
      const int4 w3 = __ldg(row + 3);
      if (leaf) {
        float px, py, pz;
        const float d2 = leaf_point(row, qx, qy, qz, px, py, pz);
        if (d2 < best_d2 || (d2 == best_d2 && idx < best)) {
          best_d2 = d2;
          best = idx;
        }
        cur = w3.y;
        ++n_leaf;
      } else {
        cur = box_d2(row, qx, qy, qz) <= best_d2 ? w3.x : w3.y;
        ++n_internal;
      }
    }
#pragma unroll
    for (int off = 1; off < P; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d2, off);
      const int os = __shfl_xor_sync(0xffffffffu, best, off);
      if (od < best_d2 || (od == best_d2 && os < best)) {
        best_d2 = od;
        best = os;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < P; off <<= 1) {
    n_internal += __shfl_xor_sync(0xffffffffu, n_internal, off);
    n_leaf += __shfl_xor_sync(0xffffffffu, n_leaf, off);
  }
  if (!live || p != 0) return;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (best >= 0) leaf_point(nodes + (size_t)best * 4, qx, qy, qz, px, py, pz);
  best_d2_out[r] = best_d2;
  point_out[3 * r + 0] = px;
  point_out[3 * r + 1] = py;
  point_out[3 * r + 2] = pz;
  slot_out[r] = best;
  if (visits_out) {
    visits_out[2 * r + 0] = n_internal;
    visits_out[2 * r + 1] = n_leaf;
  }
}

template <typename K>
int launch(K kernel, int P, const float* nodes, const int* root_link, const float* q,
           const float* max_d2, float* best_d2, float* point, int* slot, int* visits, int R,
           int n_slots, void* stream) {
  const long long threads = (long long)R * P;
  const int grid = (int)((threads + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(nodes), root_link, q, max_d2, best_d2, point, slot, visits,
      R, n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). P lanes a query (1, 2, 4 or 8,
// from ops/closest_cuda.py::walk_split). nodes must be 16-byte aligned;
// visits may be null. Returns cudaGetLastError() after the launch: 0 on
// success.
extern "C" int rmcl_closest_bvh(
    const float* nodes, const int* root_link, const float* q, const float* max_d2,
    float* best_d2, float* point, int* slot, int* visits, int R, int n_slots, int P,
    void* stream) {
  if (R == 0) return 0;
  if (((uintptr_t)nodes) % 16) return (int)cudaErrorMisalignedAddress;
  switch (P) {
    case 1:
      return launch(closest_bvh_kernel, 1, nodes, root_link, q, max_d2, best_d2, point, slot,
                    visits, R, n_slots, stream);
    case 2:
      return launch(closest_bvh_split_kernel<2>, 2, nodes, root_link, q, max_d2, best_d2, point,
                    slot, visits, R, n_slots, stream);
    case 4:
      return launch(closest_bvh_split_kernel<4>, 4, nodes, root_link, q, max_d2, best_d2, point,
                    slot, visits, R, n_slots, stream);
    case 8:
      return launch(closest_bvh_split_kernel<8>, 8, nodes, root_link, q, max_d2, best_d2, point,
                    slot, visits, R, n_slots, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Registers and local-memory bytes a thread (spills show as local memory)
// of the kernel that P selects. Returns the cudaError of the query.
extern "C" int rmcl_closest_bvh_attrs(int P, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (P) {
    case 1: err = cudaFuncGetAttributes(&a, closest_bvh_kernel); break;
    case 2: err = cudaFuncGetAttributes(&a, closest_bvh_split_kernel<2>); break;
    case 4: err = cudaFuncGetAttributes(&a, closest_bvh_split_kernel<4>); break;
    case 8: err = cudaFuncGetAttributes(&a, closest_bvh_split_kernel<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
