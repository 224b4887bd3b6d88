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
// What bounds it on an H100: the chain of dependent slot reads. A visit
// reads one 64-byte slot (16-byte loads through the read-only path) whose
// address depends on the previous visit, then does 25 (box) or 53 (leaf)
// float operations; the building map's table is 62 MB and the 1M-face
// sphere's 128 MB, both above the 50 MB L2. Where rays are few (one scan's
// 14,400 on 132 SMs) the kernel lasts as long as its longest ray's chain:
// at phase 8 of chip_smoke.py 149 visits for the longest ray against 64 on
// average, and a tenth of the scan's rays take nearly as long as the whole
// scan (PERF.md). Where rays are many (14.4M, 104.9M) other warps hide the
// latency, and the time goes into the SMs' loads and issue: a warp's lanes
// read up to 32 different slots a step, three or four 16-byte loads each
// (9-15% of the operations bound in PERF.md). The design:
//
// * One thread a ray, the serial walk above, in while-while loops (Aila and
//   Laine): a lane steps boxes while it holds one, then leaves while it
//   holds one, and the warp reconverges between the two loops, so that its
//   lanes test boxes together and leaves together instead of running both
//   branches every step. A slot's words 0-7 and 12-15 (and 8-11 for a leaf)
//   are loaded together before any is used, so a step waits for one round
//   trip. Each lane visits the same slots in the same order as the one-loop
//   walk: t, slot and visits are the serial walk's bitwise.
//
// A split walk (P lanes a ray, each walking one subtree of a frontier that
// covers the BVH, meeting by shuffles every step, as K6's closest_bvh.cu)
// was built and measured slower than this one at every size from 1,440 to
// 104.9M rays: a ray's visits follow its path through one subtree, so more
// lanes barely shorten its chain of dependent reads (149 visits at P = 1,
// 131 at P = 8 at phase 8) while every step pays the lanes' meeting
// (PERF.md). So were persistent warps refilled from a ray counter.
//
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

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ t_min, int r) {
  Ray a;
  a.ox = o[3 * r + 0];
  a.oy = o[3 * r + 1];
  a.oz = o[3 * r + 2];
  a.dx = d[3 * r + 0];
  a.dy = d[3 * r + 1];
  a.dz = d[3 * r + 2];
  a.ix = safe_inv(a.dx);
  a.iy = safe_inv(a.dy);
  a.iz = safe_inv(a.dz);
  a.tmin = t_min[r];
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

__device__ __forceinline__ void store(float* __restrict__ t_best_out, int* __restrict__ slot_out,
                                      int* __restrict__ visits_out, int r, float t_best,
                                      int best, int n_internal, int n_leaf) {
  t_best_out[r] = t_best;
  slot_out[r] = best;
  if (visits_out) {
    visits_out[2 * r + 0] = n_internal;
    visits_out[2 * r + 1] = n_leaf;
  }
}

// The serial walk, one thread a ray, in while-while loops: a lane steps
// boxes while it holds one, then leaves while it holds one, and the warp
// reconverges between the two loops, so its lanes test boxes together and
// leaves together.
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
  const Ray a = load_ray(o, d, t_min, r);
  float t_best = t_max[r];
  int best = -1;
  int cur = t_best > a.tmin ? __ldg(root_link) : kSent;
  int n_internal = 0, n_leaf = 0;
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
  store(t_best_out, slot_out, visits_out, r, t_best, best, n_internal, n_leaf);
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
      reinterpret_cast<const int4*>(nodes), root_link, o, d, t_min, t_max, t_best, slot, visits,
      R, n_slots);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread (spills show as local memory)
// of the kernel as built. Returns the cudaError of the query.
extern "C" int rmcl_traverse_bvh_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, traverse_bvh_kernel);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
