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
// Rq * B pairs of ~100 float operations against 9 * B * 4 bytes of triangle
// data that every query of the block reuses. The design (the simple one, on
// K1's skeleton, csrc/intersect_bins.cu): one CTA per 128-query block, one
// thread per query; each candidate bin's rows 0-8 are staged in shared
// memory; the block-wide exit reads the warps' maxima of best_key (warp
// shuffles, then one word a warp in shared memory); two barriers a visit.
// Built with --fmad=false so every product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/ops/closest_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ericson.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxWarps = 32;

__global__ void __launch_bounds__(1024) closest_bins_kernel(
    const float* __restrict__ tri,        // (n_rows, 14, B)
    const float* __restrict__ q,          // (n_blk, Rq, 3)
    const float* __restrict__ max_d2,     // (n_blk, Rq)
    const int* __restrict__ cand_bin,     // (n_blk, cb)
    const int* __restrict__ cand_count,   // (n_blk,)
    const float* __restrict__ cand_dlb,   // (n_blk, cb)
    int* __restrict__ best_key_out,       // (n_blk, Rq)
    int* __restrict__ best_bin_out,       // (n_blk, Rq)
    int Rq, int cb, int B) {
  extern __shared__ float s_tri[];  // rows 0-8 of the bin: [k][j]
  __shared__ int s_warp_max[kMaxWarps];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int jmask = B - 1;
  const bool live = tid < Rq;
  // threads past the block's last query repeat it and write nothing
  const int r = blk * Rq + min(tid, Rq - 1);
  const float qx = q[3 * r + 0], qy = q[3 * r + 1], qz = q[3 * r + 2];
  int best_key = __float_as_int(max_d2[r]) | jmask;
  int best_bin = -1;

  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* dlb = cand_dlb + (size_t)blk * cb;
  for (int c = 0; c < count; ++c) {
    // block-wide worst key (non-negative floats order like their bits)
    int bits = best_key;
    for (int off = 16; off > 0; off >>= 1)
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
    if (lane == 0) s_warp_max[warp] = bits;
    // publishes the maxima; every thread's reads of the previous tile ended
    // before it, so the tile may be overwritten below
    __syncthreads();
    int worst = s_warp_max[0];
    for (int w = 1; w < n_warps; ++w) worst = max(worst, s_warp_max[w]);
    // nearest-first early exit: no later candidate can improve any query
    if (!(dlb[c] <= __int_as_float(worst | jmask))) break;

    const int bin = cands[c];
    const float* src = tri + (size_t)bin * 14 * B;
    for (int i = tid; i < 9 * B; i += nt) s_tri[i] = src[i];
    __syncthreads();

    int key_min = 0x7fffffff;
    for (int j = 0; j < B; ++j) {
      const float ax = s_tri[j], ay = s_tri[B + j], az = s_tri[2 * B + j];
      const float abx = s_tri[3 * B + j], aby = s_tri[4 * B + j], abz = s_tri[5 * B + j];
      const float acx = s_tri[6 * B + j], acy = s_tri[7 * B + j], acz = s_tri[8 * B + j];
      float v, w;
      ericson_vw(qx, qy, qz, ax, ay, az, abx, aby, abz, acx, acy, acz, v, w);
      // the operation order below is the plain version's, term for term
      const float ex = (qx - ax) - v * abx - w * acx;
      const float ey = (qy - ay) - v * aby - w * acy;
      const float ez = (qz - az) - v * abz - w * acz;
      float d2 = ex * ex + ey * ey + ez * ez;
      const float edges = fabsf(abx) + fabsf(aby) + fabsf(abz) + fabsf(acx) + fabsf(acy) +
                          fabsf(acz);
      if (edges < 1e-30f) d2 = kBig;  // a padding row of the bin
      key_min = min(key_min, (__float_as_int(d2) & ~jmask) | j);
    }
    if (key_min < best_key) {
      best_key = key_min;
      best_bin = bin;
    }
  }
  if (live) {
    best_key_out[blk * Rq + tid] = best_key;
    best_bin_out[blk * Rq + tid] = best_bin;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int rmcl_closest_bins(
    const float* tri, const float* q, const float* max_d2,
    const int* cand_bin, const int* cand_count, const float* cand_dlb,
    int* best_key, int* best_bin, int n_blk, int Rq, int cb, int B, void* stream) {
  if (n_blk == 0) return 0;
  const int threads = ((Rq + 31) / 32) * 32;
  if (Rq < 1 || threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)9 * B * sizeof(float);
  if (smem + kMaxWarps * sizeof(int) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        closest_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  closest_bins_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, q, max_d2, cand_bin, cand_count, cand_dlb, best_key, best_bin, Rq, cb, B);
  return (int)cudaGetLastError();
}
