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
// bound by float32 instruction throughput, not by memory. The design keeps the data
// movement out of the way and does nothing clever about the arithmetic yet:
//   * one CTA per ray block, one thread per ray (the ray's state lives in
//     registers; threads beyond Rb in the last warp idle);
//   * each candidate bin's 9 x B floats are staged once into shared memory
//     with plain coalesced loads and read back as warp-wide broadcasts;
//   * the block-wide early exit takes the max over the int bits of the
//     threads' t_best (positive floats order like ints): a warp shuffle
//     reduction, one shared word per warp, and every thread reads the few
//     words back after the barrier;
//   * B is a runtime power of two; shared memory is 36 * B bytes.
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

__global__ void intersect_bins_kernel(
    const float* __restrict__ tri,       // (n_rows, 14, B)
    const float* __restrict__ ob,        // (n_blk, Rb, 3)
    const float* __restrict__ db,        // (n_blk, Rb, 3)
    const float* __restrict__ t_min_b,   // (n_blk, Rb)
    const float* __restrict__ t_max_b,   // (n_blk, Rb)
    const int* __restrict__ cand_bin,    // (n_blk, cb)
    const int* __restrict__ cand_count,  // (n_blk,)
    const float* __restrict__ cand_tnear,// (n_blk, cb)
    float* __restrict__ t_best_out,      // (n_blk, Rb)
    int* __restrict__ ref_out,           // (n_blk, Rb)
    int Rb, int cb, int B) {
  extern __shared__ float s_tri[];       // 9 * B: v0, e1, e2 planes
  __shared__ int s_warp_max[kMaxWarps];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const bool live = tid < Rb;
  const int jmask = B - 1;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tmin = 0.f;
  float t_best = 0.f;
  int ref = -1;
  if (live) {
    const int r = blk * Rb + tid;
    ox = ob[3 * r + 0]; oy = ob[3 * r + 1]; oz = ob[3 * r + 2];
    dx = db[3 * r + 0]; dy = db[3 * r + 1]; dz = db[3 * r + 2];
    tmin = t_min_b[r];
    t_best = t_max_b[r];
  }

  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* tnear = cand_tnear + (size_t)blk * cb;
  const int tile = 9 * B;

  for (int c = 0; c < count; ++c) {
    // block-wide worst t_best (idle threads contribute INT_MIN)
    int bits = live ? __float_as_int(t_best) : (int)0x80000000;
    for (int off = 16; off > 0; off >>= 1)
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
    if (lane == 0) s_warp_max[warp] = bits;
    // this barrier also ends every thread's reads of the previous tile
    __syncthreads();
    int worst = s_warp_max[0];
    for (int w = 1; w < n_warps; ++w) worst = max(worst, s_warp_max[w]);
    // nearest-first early exit: no later candidate can improve any ray
    if (tnear[c] > __int_as_float(worst)) break;

    const float* src = tri + (size_t)cands[c] * 14 * B;
    for (int i = tid; i < tile; i += blockDim.x) s_tri[i] = src[i];
    __syncthreads();

    if (live) {
      int key_min = 0x7fffffff;
      for (int j = 0; j < B; ++j) {
        const float v0x = s_tri[0 * B + j], v0y = s_tri[1 * B + j], v0z = s_tri[2 * B + j];
        const float e1x = s_tri[3 * B + j], e1y = s_tri[4 * B + j], e1z = s_tri[5 * B + j];
        const float e2x = s_tri[6 * B + j], e2y = s_tri[7 * B + j], e2z = s_tri[8 * B + j];
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
      const float t_bin = __int_as_float(key_min | jmask);
      if (t_bin < t_best) {
        t_best = t_bin;
        ref = cands[c] * B + (key_min & jmask);
      }
    }
  }

  if (live) {
    const int r = blk * Rb + tid;
    t_best_out[r] = t_best;
    ref_out[r] = ref;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int rmcl_intersect_bins(
    const float* tri, const float* ob, const float* db,
    const float* t_min_b, const float* t_max_b,
    const int* cand_bin, const int* cand_count, const float* cand_tnear,
    float* t_best, int* ref,
    int n_blk, int Rb, int cb, int B, void* stream) {
  if (n_blk == 0) return 0;
  const int threads = ((Rb + 31) / 32) * 32;
  const size_t smem = (size_t)9 * B * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        intersect_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  intersect_bins_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear,
      t_best, ref, Rb, cb, B);
  return (int)cudaGetLastError();
}
