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
// Two epilogues share that walk (csrc/bvh_walk.cuh), as two instantiations
// of one kernel template, traverse_bvh_kernel<Epilogue>:
//
// * StoreHits, the cast's: t_best (t_max where nothing was hit) and the
//   winning leaf's slot (-1), and on request each ray's visits (internal,
//   leaf). Every exact cast (ops/raycast.py) runs it.
// * ScoreRC, MCL's ray-cast sensor update (mcl/sensor_update.py, engine
//   "bvh"): ray r is (particle r / S, beam r % S in angular order); the
//   thread builds its ray from the particle's sensor pose and the beam, and
//   after the walk scores it as ops/raycast.py::cast_rays, score_rc and
//   fold's Gaussian would (t re-derived from the winner's plane, the
//   signed point-to-plane error and the hit/miss penalties,
//   N(error; 0, dist_sigma)), and writes that one float at the beam's
//   sampled index: no per-ray ray, hit or error tensor is ever written.
//   mcl_fold_kernel then folds each particle's S evals (one warp a
//   particle, two passes in a fixed order, no atomics). So the update moves
//   one 4-byte eval a ray through device memory, where the cast's outputs,
//   its winner-row gather and torch's scoring moved over 100 bytes a ray;
//   the winner's row, read again after the walk, is mostly in L2. At
//   chip_smoke.py's phase 10b (1M particles x 100 beams) the evals and
//   folds equalled the torch composition's on the card bit for bit.
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
// PyTorch version's (rmcl_tpu_torch/ops/traverse_cuda.py); the cross
// products of a quaternion rotation are the explicit fused multiply-adds
// that PyTorch's CPU kernel compiles them to.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFoldThreads = 256;  // 8 particles a CTA, one a warp
constexpr float kNoHitT = 3.0e38f;  // ops/raycast.py::NO_HIT_T

// The cast's epilogue: each ray's t_best and winning slot, and its visits
// on request (visits null: none). Rays are read from (R, 3) origins and
// directions and (R,) t_min, t_max.
struct StoreHits {
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* t_best;
  int* slot;
  int* visits;

  __device__ __forceinline__ Ray ray(int r, float& t_max_r) const {
    t_max_r = __ldg(t_max + r);
    return make_ray(__ldg(o + 3 * r), __ldg(o + 3 * r + 1), __ldg(o + 3 * r + 2),
                    __ldg(d + 3 * r), __ldg(d + 3 * r + 1), __ldg(d + 3 * r + 2),
                    __ldg(t_min + r));
  }

  __device__ __forceinline__ void finish(const int4* __restrict__, int r, const Ray&,
                                         float t_best_r, int best, int n_internal,
                                         int n_leaf) const {
    t_best[r] = t_best_r;
    slot[r] = best;
    if (visits) {
      visits[2 * r + 0] = n_internal;
      visits[2 * r + 1] = n_leaf;
    }
  }
};

// fma(a, b, -(c d)): a product difference of a cross product, rounded as
// PyTorch's CPU kernel (torch.linalg.cross) rounds it.
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// MCL's ray-cast scoring epilogue. Ray r = (particle p = r / S, beam b = r
// % S): origin the translation of the particle's sensor pose tsm[p] (w, x,
// y, z, tx, ty, tz), direction its quaternion applied to the beam's
// sensor-frame direction (math/se3.py::Quaternion.rotate, term for term),
// t_min 0, t_max the beam's cap. beams holds two float4 a beam, in angular
// order: (dx, dy, dz, range), (t_max, real hit 1/0, sampled index, 0).
struct ScoreRC {
  const float* tsm;
  const float4* beams;
  float* evals;  // (N, S), each particle's row in the beams' sampled order
  int S;
  float range_min;
  float hit_miss;   // real hit, simulated miss
  float miss_hit;   // real miss, simulated hit
  float miss_miss;  // real miss, simulated miss
  float inv_s;      // 1 / dist_sigma, rounded as math/stats.py::gaussian_pdf
  float coef;       // 0.3989422804014327 * inv_s, rounded likewise

  __device__ __forceinline__ Ray ray(int r, float& t_max_r) const {
    const int p = r / S;
    const int b = r - p * S;
    const float* q = tsm + (size_t)p * 7;
    const float qw = __ldg(q), qx = __ldg(q + 1), qy = __ldg(q + 2), qz = __ldg(q + 3);
    const float4 b0 = __ldg(beams + 2 * b);
    t_max_r = __ldg(beams + 2 * b + 1).x;
    // v' = v + qw t + qv x t, t = 2 qv x v
    const float tx = 2.0f * cross_term(qy, b0.z, qz, b0.y);
    const float ty = 2.0f * cross_term(qz, b0.x, qx, b0.z);
    const float tz = 2.0f * cross_term(qx, b0.y, qy, b0.x);
    const float dx = (b0.x + qw * tx) + cross_term(qy, tz, qz, ty);
    const float dy = (b0.y + qw * ty) + cross_term(qz, tx, qx, tz);
    const float dz = (b0.z + qw * tz) + cross_term(qx, ty, qy, tx);
    return make_ray(__ldg(q + 4), __ldg(q + 5), __ldg(q + 6), dx, dy, dz, 0.0f);
  }

  // The winner's row is read again here (words 0-2, v0, and 9-11, the
  // normal), so the walk's loop holds neither; the beam is read again too.
  __device__ __forceinline__ void finish(const int4* __restrict__ nodes, int r, const Ray& a,
                                         float, int best, int, int) const {
    const int p = r / S;
    const int b = r - p * S;
    const float4 b0 = __ldg(beams + 2 * b);
    const float4 b1 = __ldg(beams + 2 * b + 1);
    const bool real = b1.y > 0.0f;
    float error;
    if (best >= 0) {
      const int4 w0 = __ldg(nodes + (size_t)best * 4);
      const int4 w2 = __ldg(nodes + (size_t)best * 4 + 2);
      const float v0x = __int_as_float(w0.x), v0y = __int_as_float(w0.y);
      const float v0z = __int_as_float(w0.z);
      const float nx = __int_as_float(w2.y), ny = __int_as_float(w2.z);
      const float nz = __int_as_float(w2.w);
      // ops/raycast.py::cast_rays: t from the winner's plane
      const float denom = nx * a.dx + ny * a.dy + nz * a.dz;
      const float safe_denom = fabsf(denom) > 1e-12f ? denom : 1e-12f;
      const float t = (nx * (v0x - a.ox) + ny * (v0y - a.oy) + nz * (v0z - a.oz)) / safe_denom;
      if (t > range_min) {
        // score_rc: the signed distance of the measured point to the plane
        const float sx = nx * ((a.ox + t * a.dx) - (a.ox + a.dx * b0.w));
        const float sy = ny * ((a.oy + t * a.dy) - (a.oy + a.dy * b0.w));
        const float sz = nz * ((a.oz + t * a.dz) - (a.oz + a.dz * b0.w));
        error = real ? fabsf((sx + sy) + sz) : miss_hit;
      } else {
        error = real ? hit_miss : miss_miss;
      }
    } else {
      error = real ? hit_miss : miss_miss;
    }
    // math/stats.py::gaussian_pdf
    const float z = error * inv_s;
    evals[(size_t)p * S + (int)b1.z] = coef * expf((-0.5f * z) * z);
  }
};

// The walk, one thread a ray, and the epilogue's use of its result.
template <class Epilogue>
__global__ void __launch_bounds__(kThreads) traverse_bvh_kernel(
    const int4* __restrict__ nodes,     // (n_slots, 16) words as 4 int4 a slot
    const int* __restrict__ root_link,  // ()
    const Epilogue e, int R, int n_slots) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  float t_best;
  const Ray a = e.ray(r, t_best);
  int best = -1;
  int n_internal = 0, n_leaf = 0;
  walk(nodes, root_link, a, n_slots, t_best, best, n_internal, n_leaf);
  e.finish(nodes, r, a, t_best, best, n_internal, n_leaf);
}

// The sum of v over a warp's lanes, in one fixed order, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Each particle's S evals folded as one batch Gaussian (mcl/sensor_update.py
// ::fold): the mean, then the mean squared deviation from it, each a sum in
// a fixed order (a lane's beams lane, lane + 32, ..., then the warp's tree).
__global__ void __launch_bounds__(kFoldThreads) mcl_fold_kernel(
    const float* __restrict__ evals,  // (N, S)
    float* __restrict__ e_mean,       // (N,)
    float* __restrict__ e_var,        // (N,)
    int N, int S) {
  const int p = (int)((blockIdx.x * (unsigned)kFoldThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= N) return;  // a whole warp
  const float* e = evals + (size_t)p * S;
  float s = 0.0f;
  for (int j = lane; j < S; j += 32) s += __ldg(e + j);
  const float mean = warp_sum(s) / (float)S;
  float v = 0.0f;
  for (int j = lane; j < S; j += 32) {
    const float x = __ldg(e + j) - mean;
    v += x * x;
  }
  v = warp_sum(v);
  if (lane == 0) {
    e_mean[p] = mean;
    e_var[p] = v / (float)S;
  }
}

int attrs(const void* fn, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

}  // namespace

// Plain C entry points (loaded with ctypes). nodes must be 16-byte aligned.
// Each returns cudaGetLastError() after its launch: 0 on success.

// The cast (StoreHits); visits may be null.
extern "C" int rmcl_traverse_bvh(
    const float* nodes, const int* root_link, const float* o, const float* d,
    const float* t_min, const float* t_max, float* t_best, int* slot, int* visits,
    int R, int n_slots, void* stream) {
  if (R == 0) return 0;
  if (((uintptr_t)nodes) % 16) return (int)cudaErrorMisalignedAddress;
  const int grid = (R + kThreads - 1) / kThreads;
  const StoreHits e{o, d, t_min, t_max, t_best, slot, visits};
  traverse_bvh_kernel<StoreHits><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(nodes), root_link, e, R, n_slots);
  return (int)cudaGetLastError();
}

// MCL's scored walk (ScoreRC) on N x S rays, then the fold: evals (N, S),
// e_mean and e_var (N,). beams must be 16-byte aligned.
extern "C" int rmcl_walk_score_rc(
    const float* nodes, const int* root_link, const float* tsm, const float* beams,
    float* evals, float* e_mean, float* e_var, int N, int S, int n_slots, float range_min,
    float hit_miss, float miss_hit, float miss_miss, float inv_s, float coef, void* stream) {
  if (N == 0 || S == 0) return 0;
  if (((uintptr_t)nodes) % 16 || ((uintptr_t)beams) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int R = N * S;  // the wrapper refuses N * S past 2^31 - 1
  const ScoreRC e{tsm, reinterpret_cast<const float4*>(beams), evals, S, range_min,
                  hit_miss, miss_hit, miss_miss, inv_s, coef};
  traverse_bvh_kernel<ScoreRC><<<(R + kThreads - 1) / kThreads, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(nodes), root_link, e, R, n_slots);
  const cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  const int warps = kFoldThreads / 32;
  mcl_fold_kernel<<<(N + warps - 1) / warps, kFoldThreads, 0, (cudaStream_t)stream>>>(
      evals, e_mean, e_var, N, S);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread (spills show as local memory)
// of each kernel as built. Returns the cudaError of the query.
extern "C" int rmcl_traverse_bvh_attrs(int* regs, int* local_bytes) {
  return attrs((const void*)traverse_bvh_kernel<StoreHits>, regs, local_bytes);
}

extern "C" int rmcl_walk_score_rc_attrs(int* regs, int* local_bytes) {
  return attrs((const void*)traverse_bvh_kernel<ScoreRC>, regs, local_bytes);
}

extern "C" int rmcl_mcl_fold_attrs(int* regs, int* local_bytes) {
  return attrs((const void*)mcl_fold_kernel, regs, local_bytes);
}
