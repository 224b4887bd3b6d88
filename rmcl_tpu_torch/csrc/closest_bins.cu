// Closest point over each query block's candidate bins (K6b), the dense
// engine's distance query.
//
// Replaces the XLA chunk loop of rmcl_tpu/ops/closest_point.py::
// closest_points_binned (:445-511), fed by _cp_candidates (:305). Per query
// block (one CTA) and its nearest-first candidate bins (by the box-box
// squared-distance lower bound dlb, ascending):
//
//   best_key = bits(max_d2) | jmask for each query (jmask = B - 1);
//   for each candidate c < count: stop once dlb[c] > float(max over the
//   block of best_key | jmask); for every (query, triangle j) pair take the
//   Ericson closest point (ericson.cuh) and d2 = |(q - a) - v ab - w ac|^2,
//   3e38 for a padding triangle (ab = ac = 0: the sum of the six |edge
//   components| < 1e-30); fold the bin by an int min over the packed key
//   (bits(d2) & ~jmask) | j, and take key_min (and the bin) when it is <
//   best_key.
//
// Outputs: best_key (the truncated d2 with the winner's j in its low bits)
// and best_bin (-1) per query. The caller recomputes the winner's exact
// closest point.
//
// The exit is per block, not per XLA chunk, and still gives the chunk loop's
// result exactly. The chunk loop runs while any block of its chunk may
// improve (jnp.any, :506) and up to the chunk's largest count (limit,
// :451), so a block that this kernel has left may visit more candidates
// there. It gains nothing from them: the lists are ascending in dlb, so
// every later candidate c' has dlb[c'] >= dlb[c] > float(max_key | jmask);
// each triangle in it lies at d2 >= dlb[c'] (a box-box distance bounds every
// point-triangle distance between the boxes' contents), so bits(d2) >
// (max_key | jmask), hence bits(d2) & ~jmask > max_key & ~jmask and its key
// exceeds max_key >= every query's best_key: the strict key_min < best_key
// keeps the old winner. A slot past the count holds bin -1, whose keys are
// those of 3e38, above any best_key (max_d2 is clamped to 1.7e19^2 < 3e38).
//
// What bounds it on an H100: the pair arithmetic. A candidate bin costs
// Rq * B pairs of ~90 float operations against 9 * B * 4 bytes of triangle
// data that every query of the block reuses. The design:
//   * one CTA per query block; G adjacent lanes share one query (G from the
//     wrapper's rule, ops/closest_cuda.py::bins_groups): lane g tests the
//     triangles j = g, g + G, ... and the G partial key minima meet by
//     __shfl_xor_sync. The packed key is unique per triangle of a bin and
//     the integer min is exact in any order, so G changes no result; it
//     gives the few blocks of one scan (113 at 128 queries) G = 8 times the
//     warps; G = 2 where the grid fills the card already, since a second
//     lane halves each visit's chain of pairs (on an H100, 112,500 blocks:
//     16.3 ms at G = 1, 14.6 at 2, 15.1 at 4);
//   * the Ericson point divides only for the region it takes (ericson.cuh);
//   * the next candidate's 9 x B floats are copied into the second of two
//     shared buffers by cp.async while the current one is tested (only for a
//     slot < count), scattered into three float4s a triangle (v0, e1, e2),
//     so a pair reads three 128-bit shared words;
//   * the padding test runs once per triangle and warp, not per pair: a lane
//     tests one triangle of each 32 and __ballot_sync hands the warp the
//     mask (the rows arrive by cp.async, so no thread sees a whole triangle
//     while staging); a padding triangle's key is formed without its point;
//   * one barrier per visit: it publishes the arrived tile and the warps'
//     maxima of best_key for the block-wide exit (non-negative floats order
//     like their bits; the maxima alternate between two shared arrays, so a
//     warp that runs ahead never overwrites words another warp still reads).
// On an H100 the cp.async staging beat plain loads and stores by 1-3% at
// 112,500 blocks and came within 3% either way at 113 (PERF.md). Built with
// --fmad=false so every product and sum rounds like the plain PyTorch
// version's (rmcl_tpu_torch/ops/closest_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ericson.cuh"

namespace {

constexpr float kBig = 3.0e38f;
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

// Start the copy of one bin's a/ab/ac planes (9 * B floats, plane k =
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

__global__ void __launch_bounds__(1024) closest_bins_kernel(
    const float* __restrict__ tri,        // (n_rows, 14, B)
    const float* __restrict__ q,          // (n_blk, Rq, 3)
    const float* __restrict__ max_d2,     // (n_blk, Rq)
    const int* __restrict__ cand_bin,     // (n_blk, cb)
    const int* __restrict__ cand_count,   // (n_blk,)
    const float* __restrict__ cand_dlb,   // (n_blk, cb)
    int* __restrict__ best_key_out,       // (n_blk, Rq)
    int* __restrict__ best_bin_out,       // (n_blk, Rq)
    int Rq, int cb, int B, int G) {
  extern __shared__ float4 s_tri[];  // 2 x [j][3]: a, ab, ac (.w unused)
  __shared__ __align__(16) int s_warp_max[2][kMaxWarps];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  // lane = (query within the warp) * G + g; lanes past the block's last
  // query repeat it (same best_key, so the block maximum is unchanged) and
  // write nothing
  const int g = lane & (G - 1);
  const int query = warp * (32 / G) + lane / G;
  const bool writer = g == 0 && query < Rq;
  const int jmask = B - 1;
  const int tile = 3 * B;
  const int log2B = __ffs(B) - 1;
  const int big_key = __float_as_int(kBig) & ~jmask;

  for (int i = tid; i < 2 * kMaxWarps; i += nt) (&s_warp_max[0][0])[i] = 0;

  const int r = blk * Rq + min(query, Rq - 1);
  const float qx = q[3 * r + 0], qy = q[3 * r + 1], qz = q[3 * r + 2];
  int best_key = __float_as_int(max_d2[r]) | jmask;
  int best_bin = -1;

  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* dlb = cand_dlb + (size_t)blk * cb;
  if (count > 0) stage_tile(s_tri, tri + (size_t)cands[0] * 14 * B, B, log2B, tid, nt);
  // the zero fill above must land before any warp publishes its maximum
  __syncthreads();

  for (int c = 0; c < count; ++c) {
    const int par = c & 1;
    // block-wide worst key: the warp's max, published for the others
    int bits = best_key;
    for (int off = 16; off > 0; off >>= 1)
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
    if (lane == 0) s_warp_max[par][warp] = bits;
    cp_async_wait_all();  // this thread's share of tile c has landed
    // publishes tile c and the maxima; every thread's reads of tile c - 1
    // ended before it, so its buffer may take tile c + 1 below
    __syncthreads();
    const int4* wm = reinterpret_cast<const int4*>(s_warp_max[par]);
    int worst = 0;
    for (int w = 0; w < n_warps; w += 4) {
      const int4 m = wm[w >> 2];
      worst = max(max(worst, m.x), max(m.y, max(m.z, m.w)));
    }
    // nearest-first early exit: no later candidate can improve any query
    if (!(dlb[c] <= __int_as_float(worst | jmask))) break;

    const int bin = cands[c];
    if (c + 1 < count)
      stage_tile(s_tri + (par ^ 1) * tile, tri + (size_t)cands[c + 1] * 14 * B, B, log2B, tid, nt);

    const float4* st = s_tri + par * tile;
    int key_min = 0x7fffffff;
    for (int j0 = 0; j0 < B; j0 += 32) {
      // the padding rows of triangles j0 .. j0 + 31, one a lane
      bool pad = false;
      if (j0 + lane < B) {
        const float4 e1 = st[3 * (j0 + lane) + 1], e2 = st[3 * (j0 + lane) + 2];
        pad = fabsf(e1.x) + fabsf(e1.y) + fabsf(e1.z) + fabsf(e2.x) + fabsf(e2.y) +
                  fabsf(e2.z) < 1e-30f;
      }
      const unsigned pad_mask = __ballot_sync(0xffffffffu, pad);
      const int j_end = min(j0 + 32, B);
#pragma unroll 2
      for (int j = j0 + g; j < j_end; j += G) {
        int key = big_key | j;
        if (!((pad_mask >> (j - j0)) & 1u)) {
          const float4 a = st[3 * j], ab = st[3 * j + 1], ac = st[3 * j + 2];
          float v, w;
          ericson_vw(qx, qy, qz, a.x, a.y, a.z, ab.x, ab.y, ab.z, ac.x, ac.y, ac.z, v, w);
          // the operation order below is the plain version's, term for term
          const float ex = (qx - a.x) - v * ab.x - w * ac.x;
          const float ey = (qy - a.y) - v * ab.y - w * ac.y;
          const float ez = (qz - a.z) - v * ab.z - w * ac.z;
          const float d2 = ex * ex + ey * ey + ez * ez;
          key = (__float_as_int(d2) & ~jmask) | j;
        }
        key_min = min(key_min, key);
      }
    }
    // the G lanes of a query meet: every one of them then holds the bin's min
    for (int off = 1; off < G; off <<= 1)
      key_min = min(key_min, __shfl_xor_sync(0xffffffffu, key_min, off));
    if (key_min < best_key) {
      best_key = key_min;
      best_bin = bin;
    }
  }
  cp_async_wait_all();  // a copy started before the exit must land first

  if (writer) {
    best_key_out[blk * Rq + query] = best_key;
    best_bin_out[blk * Rq + query] = best_bin;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). G lanes per query (a power of two
// <= min(B, 32), from ops/closest_cuda.py::bins_groups). Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int rmcl_closest_bins(
    const float* tri, const float* q, const float* max_d2,
    const int* cand_bin, const int* cand_count, const float* cand_dlb,
    int* best_key, int* best_bin, int n_blk, int Rq, int cb, int B, int G, void* stream) {
  if (n_blk == 0) return 0;
  if (G < 1 || G > 32 || (G & (G - 1)) || G > B) return (int)cudaErrorInvalidValue;
  const int per_warp = 32 / G;
  const int threads = ((Rq + per_warp - 1) / per_warp) * 32;
  if (Rq < 1 || threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)2 * 3 * B * sizeof(float4);
  // dynamic beyond 48 KB, static (the maxima) included, must be allowed
  if (smem + 2 * kMaxWarps * sizeof(int) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        closest_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  closest_bins_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, q, max_d2, cand_bin, cand_count, cand_dlb, best_key, best_bin, Rq, cb, B, G);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread (spills show as local memory)
// of the kernel as built. Returns the cudaError of the query.
extern "C" int rmcl_closest_bins_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, closest_bins_kernel);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
