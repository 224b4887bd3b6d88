// Candidate-bin closest-hit intersection for the dense binned ray caster.
//
// Replaces the TPU kernel rmcl_tpu/ops/raycast_pallas.py::_intersect_kernel
// (wrapper intersect_bins_pallas) and the XLA chunk loop that the JAX
// package runs in its place (rmcl_tpu/ops/raycast_binned.py:951-1114, index
// payload). Both compute the same per-ray winner; so does this kernel:
//
//   for each ray block, walk its candidate bins nearest-first; for every
//   (ray, triangle) pair run Moller-Trumbore with the strict t > t_min gate
//   and eps = 1e-7 barycentric slack; fold each bin by an int min over the
//   packed key (bits(t) & ~(B-1)) | j; take the bin's winner when
//   (key_min | (B-1)) as float < t_best (strict: an earlier, nearer
//   candidate wins ties); stop once the next candidate's conservative entry
//   distance tnear exceeds the block's worst t_best.
//
// Outputs per ray: t_best (the packed, rounded-up t — the caller re-derives
// the exact t from the winner's plane) and ref = bin * B + j, or -1.
//
// What bounds it on an H100: the pair arithmetic. Each candidate bin costs
// Rb * B pairs of ~47 float operations but only 9 * B * 4 bytes of triangle
// data (v0, e1, e2), which every ray of the block reuses; so the kernel is
// bound by float32 instruction throughput, not by memory. The design:
//   * one CTA per ray block; each ray is served by S adjacent lane groups
//     (S from the wrapper's rule, ops/raycast_cuda.py::lane_split): lane s
//     of a ray tests triangles j = s, s + S, ..., and the S partial key
//     minima meet by __shfl_xor_sync. The packed key is unique per triangle
//     and the min is associative, so the split changes no result; it gives
//     the few blocks of a single scan (113 at 128 rays) S times the warps;
//   * the next candidate's 9 x B floats are copied into the second of two
//     shared buffers by cp.async while the current one is tested; a copy is
//     started only for a slot < count (no sentinel slot is ever read). The
//     copies are 4-byte ones that scatter the planar (9, B) rows into three
//     float4s a triangle (v0, e1, e2, each padded), so a pair costs three
//     128-bit shared loads instead of nine 32-bit ones;
//   * one barrier per visit: it publishes the arrived tile and the warps'
//     maxima of t_best for the block-wide early exit (positive floats order
//     like ints; the maxima alternate between two shared arrays, so a warp
//     that runs ahead never overwrites words another warp still reads);
//   * B is a runtime power of two; shared memory is 2 * 48 * B bytes;
//   * an optional launch order (int32, one entry a block): CTA i works on
//     block order[i] and writes it in place, so the caller may launch the
//     blocks in candidate-count order (the dense engine's sort_blocks) and
//     read the outputs unpermuted. It changes no result.
// Built with --fmad=false so that every product and sum rounds like the
// plain PyTorch version's (rmcl_tpu_torch/ops/raycast_cuda.py), which keeps
// the packed-key winners identical at shared edges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;        // t of "no candidate hit"
constexpr float kEps = 1e-7f;          // barycentric slack
constexpr float kOnePlusEps = 1.0000001f;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of one bin's v0/e1/e2 planes (9 * B floats, plane k =
// component k % 3 of vector k / 3) into float4 [j][vector] in shared memory;
// neighbouring threads read neighbouring global words.
__device__ __forceinline__ void stage_tile(float4* dst, const float* src, int B, int log2B, int tid,
                                           int nt) {
  for (int i = tid; i < 9 * B; i += nt) {
    const int k = i >> log2B, j = i & (B - 1);
    cp_async4(reinterpret_cast<float*>(dst + 3 * j + k / 3) + k % 3, src + i);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(1024) intersect_bins_kernel(
    const float* __restrict__ tri,       // (n_rows, 14, B)
    const float* __restrict__ ob,        // (n_blk, Rb, 3)
    const float* __restrict__ db,        // (n_blk, Rb, 3)
    const float* __restrict__ t_min_b,   // (n_blk, Rb)
    const float* __restrict__ t_max_b,   // (n_blk, Rb)
    const int* __restrict__ cand_bin,    // (n_blk, cb)
    const int* __restrict__ cand_count,  // (n_blk,)
    const float* __restrict__ cand_tnear,// (n_blk, cb)
    const int* __restrict__ order,       // (n_blk,) launch order, or null
    float* __restrict__ t_best_out,      // (n_blk, Rb)
    int* __restrict__ ref_out,           // (n_blk, Rb)
    int Rb, int cb, int B, int S) {
  extern __shared__ float4 s_tri[];  // 2 x [j][3]: v0, e1, e2 (.w unused)
  __shared__ __align__(16) int s_warp_max[2][kMaxWarps];

  // CTA i works on block order[i]; outputs stay in block order
  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int rays_per_warp = 32 / S;
  // lane = s * rays_per_warp + (ray within the warp); lanes past the last
  // ray repeat it (same t_best, so the block maximum is unchanged) and
  // write nothing
  const int s = lane / rays_per_warp;
  const int ray = warp * rays_per_warp + lane % rays_per_warp;
  const bool writer = s == 0 && ray < Rb;
  const int jmask = B - 1;
  const int tile = 3 * B;
  const int log2B = __ffs(B) - 1;

  for (int i = tid; i < 2 * kMaxWarps; i += nt) (&s_warp_max[0][0])[i] = (int)0x80000000;

  const size_t r = (size_t)blk * Rb + min(ray, Rb - 1);
  const float ox = ob[3 * r + 0], oy = ob[3 * r + 1], oz = ob[3 * r + 2];
  const float dx = db[3 * r + 0], dy = db[3 * r + 1], dz = db[3 * r + 2];
  const float tmin = t_min_b[r];
  float t_best = t_max_b[r];
  int ref = -1;

  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* tnear = cand_tnear + (size_t)blk * cb;
  if (count > 0) stage_tile(s_tri, tri + (size_t)cands[0] * 14 * B, B, log2B, tid, nt);
  // the INT_MIN fill above must land before any warp publishes its maximum
  __syncthreads();

  for (int c = 0; c < count; ++c) {
    const int par = c & 1;
    // block-wide worst t_best: the warp's max, published for the others
    int bits = __float_as_int(t_best);
    for (int off = 16; off > 0; off >>= 1)
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
    if (lane == 0) s_warp_max[par][warp] = bits;
    cp_async_wait_all();  // this thread's share of tile c has landed
    // publishes tile c and the maxima; every thread's reads of tile c - 1
    // ended before it, so its buffer may take tile c + 1 below
    __syncthreads();
    const int4* wm = reinterpret_cast<const int4*>(s_warp_max[par]);
    int worst = (int)0x80000000;
    for (int w = 0; w < n_warps; w += 4) {
      const int4 q = wm[w >> 2];
      worst = max(max(worst, q.x), max(q.y, max(q.z, q.w)));
    }
    // nearest-first early exit: no later candidate can improve any ray
    if (tnear[c] > __int_as_float(worst)) break;

    if (c + 1 < count)
      stage_tile(s_tri + (par ^ 1) * tile, tri + (size_t)cands[c + 1] * 14 * B, B, log2B, tid, nt);

    const float4* st = s_tri + par * tile;
    int key_min = 0x7fffffff;
#pragma unroll 4
    for (int j = s; j < B; j += S) {
      const float4 v0 = st[3 * j], e1 = st[3 * j + 1], e2 = st[3 * j + 2];
      const float v0x = v0.x, v0y = v0.y, v0z = v0.z;
      const float e1x = e1.x, e1y = e1.y, e1z = e1.z;
      const float e2x = e2.x, e2y = e2.y, e2z = e2.z;
      // the operation order below is the plain version's, term for term
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      // a degenerate triangle (padding) gives inv_det = 0 -> t = 0, which
      // only the strict t > t_min gate rejects
      const bool ok = fminf(fminf(u, v), kOnePlusEps - (u + v)) >= -kEps && t > tmin;
      const int key = (__float_as_int(ok ? t : kBig) & ~jmask) | j;
      key_min = min(key_min, key);
    }
    // the S lanes of a ray meet: every one of them then holds the bin's min
    for (int off = rays_per_warp; off < 32; off <<= 1)
      key_min = min(key_min, __shfl_xor_sync(0xffffffffu, key_min, off));
    const float t_bin = __int_as_float(key_min | jmask);
    if (t_bin < t_best) {
      t_best = t_bin;
      ref = cands[c] * B + (key_min & jmask);
    }
  }
  cp_async_wait_all();  // a copy started before the exit must land before the CTA ends

  if (writer) {
    const size_t w = (size_t)blk * Rb + ray;
    t_best_out[w] = t_best;
    ref_out[w] = ref;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). S lanes per ray (a power of two
// <= 32, from ops/raycast_cuda.py::lane_split). Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int rmcl_intersect_bins(
    const float* tri, const float* ob, const float* db,
    const float* t_min_b, const float* t_max_b,
    const int* cand_bin, const int* cand_count, const float* cand_tnear,
    const int* order, float* t_best, int* ref,
    int n_blk, int Rb, int cb, int B, int S, void* stream) {
  if (n_blk == 0) return 0;
  if (S < 1 || S > 32 || (S & (S - 1))) return (int)cudaErrorInvalidValue;
  const int rays_per_warp = 32 / S;
  const int threads = ((Rb + rays_per_warp - 1) / rays_per_warp) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)2 * 3 * B * sizeof(float4);
  // dynamic beyond 48 KB, static (the maxima) included, must be allowed
  if (smem + 2 * kMaxWarps * sizeof(int) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        intersect_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  intersect_bins_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, order,
      t_best, ref, Rb, cb, B, S);
  return (int)cudaGetLastError();
}
