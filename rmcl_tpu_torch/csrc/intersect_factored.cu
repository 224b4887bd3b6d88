// Factored closest-hit pair loop: Baldwin-Weber over (P pose origins x G
// shared directions) ray blocks.
//
// Replaces the TPU engine's device loop in
// rmcl_tpu/ops/raycast_binned.py::cast_rays_binned_factored (the
// while_loop body at :1650-1771). Per ray block it walks the block's
// candidate bins nearest-first and, per bin:
//
//   per triangle:        ng = e1 x e2, c0 = ng.v0, m1 = e2 x ng / |ng|^2,
//                        m2 = ng x e1 / |ng|^2, cu = v0.m1, cv = v0.m2;
//   per (tri, dir):      invNd = 1 / (ng.d) (0 when |ng.d| <= 1e-30),
//                        Bu = m1.d, Bv = m2.d;
//   per (tri, pose):     No = c0 - ng.o, Au = m1.o - cu, Av = m2.o - cv;
//   per pair:            t = No * invNd, u = Au + t Bu, v = Av + t Bv, a
//                        hit when min(u, v, 1 + eps - (u + v)) >= -eps and
//                        t > t_min;
//
// folds the bin with an int min over the packed key (bits(t) & ~(B-1)) | j,
// takes the bin's winner when (key_min | (B-1)) as float < t_best (strict:
// earlier, nearer candidates win ties), and stops once the next
// candidate's tnear exceeds the block's worst t_best. A block's t_best
// starts at alive * t_max (0 for a dead block). Outputs per ray: t_best
// and ref = bin * B + j, or -1; the caller resolves the payload from the
// winner's row.
//
// What bounds it on an H100: the pair arithmetic, 11 float instructions a
// pair (the per-triangle, per-direction and per-pose terms amortize over
// G, P and G x P rays), against 9 * B * 4 bytes of triangle data a visit
// that every ray of the block reuses: float32 instruction throughput, not
// memory. The design is simple:
//   * one CTA per block, one thread per (g, p) ray, ray state in registers;
//   * each candidate bin's 9 x B floats are staged in shared memory; the
//     12 per-triangle rows are computed once per bin into shared memory;
//   * per-(tri, dir) terms go to shared memory when P > 1 rays share them
//     (B x G x 3 floats), per-(tri, pose) terms when G > 1 rays share them
//     (B x P x 3), laid out so that the rays of a warp read neighbouring
//     words for one triangle; otherwise (the tracking layout P = 1, the paired
//     layout) each thread forms its own in registers;
//   * the block-wide early exit is K1's: a warp-shuffle max over the int
//     bits of t_best, one shared word per warp.
// Built with --fmad=false, and with every sum in the plain version's order
// (rmcl_tpu_torch/ops/raycast_cuda.py::intersect_factored_reference), so
// both pick the same winners.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-7f;
constexpr float kOnePlusEps = 1.0000001f;
constexpr int kMaxWarps = 32;

__global__ void intersect_factored_kernel(
    const float* __restrict__ tri,        // (n_rows, 14, B)
    const float* __restrict__ o_blk,      // (n_blk, P, 3), paired (n_blk, G, 3)
    const float* __restrict__ d_blk,      // (n_blk, G, 3)
    const float* __restrict__ alive,      // (n_blk,)
    const int* __restrict__ cand_bin,     // (n_blk, cb)
    const int* __restrict__ cand_count,   // (n_blk,)
    const float* __restrict__ cand_tnear, // (n_blk, cb)
    const int* __restrict__ order,        // (n_blk,) launch order, or null
    float* __restrict__ t_best_out,       // (n_blk, G, P_eff)
    int* __restrict__ ref_out,            // (n_blk, G, P_eff)
    int G, int P, int paired, int cb, int B, float t_min, float t_max) {
  const int P_eff = paired ? 1 : P;
  const int n_orig = paired ? G : P;
  const bool dir_shared = P_eff > 1;
  const bool pose_shared = !paired && G > 1;

  extern __shared__ float smem[];
  float* s_tri = smem;                                   // 9 * B
  float* s_row = s_tri + 9 * B;                          // 12 * B
  // term arrays are [term][j][g] and [term][j][p]: for one triangle j, a
  // warp's rays read neighbouring words (no bank conflicts)
  float* s_dir = s_row + 12 * B;                         // 3 * B * G (dir_shared)
  float* s_pose = s_dir + (dir_shared ? 3 * G * B : 0);  // 3 * B * P (pose_shared)
  float* s_d = s_pose + (pose_shared ? 3 * P * B : 0);   // 3 * G
  float* s_o = s_d + 3 * G;                              // 3 * n_orig
  __shared__ int s_warp_max[kMaxWarps];

  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (nt + 31) >> 5;
  const int n_rays = G * P_eff;
  const bool live = tid < n_rays;
  const int g = live ? tid / P_eff : 0;
  const int p = live ? tid % P_eff : 0;
  const int jmask = B - 1;

  for (int i = tid; i < 3 * G; i += nt) s_d[i] = d_blk[(size_t)blk * 3 * G + i];
  for (int i = tid; i < 3 * n_orig; i += nt) s_o[i] = o_blk[(size_t)blk * 3 * n_orig + i];
  __syncthreads();
  const float dx = s_d[3 * g], dy = s_d[3 * g + 1], dz = s_d[3 * g + 2];
  const int oi = paired ? g : p;
  const float ox = s_o[3 * oi], oy = s_o[3 * oi + 1], oz = s_o[3 * oi + 2];

  float t_best = alive[blk] * t_max;
  int ref = -1;
  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* tnear = cand_tnear + (size_t)blk * cb;

  for (int c = 0; c < count; ++c) {
    // block-wide worst t_best (t_best >= 0: its bits order like ints)
    int bits = live ? __float_as_int(t_best) : (int)0x80000000;
    for (int off = 16; off > 0; off >>= 1)
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
    if (lane == 0) s_warp_max[warp] = bits;
    // this barrier also ends every thread's reads of the previous bin
    __syncthreads();
    int worst = s_warp_max[0];
    for (int w = 1; w < n_warps; ++w) worst = max(worst, s_warp_max[w]);
    if (tnear[c] > __int_as_float(worst)) break;

    const int bin = cands[c];
    const float* src = tri + (size_t)bin * 14 * B;
    for (int i = tid; i < 9 * B; i += nt) s_tri[i] = src[i];
    __syncthreads();

    for (int j = tid; j < B; j += nt) {
      const float v0x = s_tri[0 * B + j], v0y = s_tri[1 * B + j], v0z = s_tri[2 * B + j];
      const float e1x = s_tri[3 * B + j], e1y = s_tri[4 * B + j], e1z = s_tri[5 * B + j];
      const float e2x = s_tri[6 * B + j], e2y = s_tri[7 * B + j], e2z = s_tri[8 * B + j];
      const float ngx = e1y * e2z - e1z * e2y;
      const float ngy = e1z * e2x - e1x * e2z;
      const float ngz = e1x * e2y - e1y * e2x;
      const float nn = (ngx * ngx + ngy * ngy) + ngz * ngz;
      const float inv_nn = 1.0f / fmaxf(nn, 1e-30f);
      const float m1x = (e2y * ngz - e2z * ngy) * inv_nn;
      const float m1y = (e2z * ngx - e2x * ngz) * inv_nn;
      const float m1z = (e2x * ngy - e2y * ngx) * inv_nn;
      const float m2x = (ngy * e1z - ngz * e1y) * inv_nn;
      const float m2y = (ngz * e1x - ngx * e1z) * inv_nn;
      const float m2z = (ngx * e1y - ngy * e1x) * inv_nn;
      s_row[0 * B + j] = ngx;
      s_row[1 * B + j] = ngy;
      s_row[2 * B + j] = ngz;
      s_row[3 * B + j] = (ngx * v0x + ngy * v0y) + ngz * v0z;
      s_row[4 * B + j] = m1x;
      s_row[5 * B + j] = m1y;
      s_row[6 * B + j] = m1z;
      s_row[7 * B + j] = m2x;
      s_row[8 * B + j] = m2y;
      s_row[9 * B + j] = m2z;
      s_row[10 * B + j] = (v0x * m1x + v0y * m1y) + v0z * m1z;
      s_row[11 * B + j] = (v0x * m2x + v0y * m2y) + v0z * m2z;
    }
    __syncthreads();

    if (dir_shared || pose_shared) {
      if (dir_shared) {
        for (int i = tid; i < G * B; i += nt) {
          const int j = i / G, gg = i % G;
          const float ex = s_d[3 * gg], ey = s_d[3 * gg + 1], ez = s_d[3 * gg + 2];
          const float Nd = (s_row[j] * ex + s_row[B + j] * ey) + s_row[2 * B + j] * ez;
          s_dir[i] = fabsf(Nd) > 1e-30f ? 1.0f / Nd : 0.0f;
          s_dir[G * B + i] = (s_row[4 * B + j] * ex + s_row[5 * B + j] * ey) + s_row[6 * B + j] * ez;
          s_dir[2 * G * B + i] =
              (s_row[7 * B + j] * ex + s_row[8 * B + j] * ey) + s_row[9 * B + j] * ez;
        }
      }
      if (pose_shared) {
        for (int i = tid; i < P * B; i += nt) {
          const int j = i / P, pp = i % P;
          const float qx = s_o[3 * pp], qy = s_o[3 * pp + 1], qz = s_o[3 * pp + 2];
          s_pose[i] = s_row[3 * B + j] -
                      ((s_row[j] * qx + s_row[B + j] * qy) + s_row[2 * B + j] * qz);
          s_pose[P * B + i] =
              ((s_row[4 * B + j] * qx + s_row[5 * B + j] * qy) + s_row[6 * B + j] * qz) -
              s_row[10 * B + j];
          s_pose[2 * P * B + i] =
              ((s_row[7 * B + j] * qx + s_row[8 * B + j] * qy) + s_row[9 * B + j] * qz) -
              s_row[11 * B + j];
        }
      }
      __syncthreads();
    }

    if (live) {
      int key_min = 0x7fffffff;
      for (int j = 0; j < B; ++j) {
        float invNd, Bu, Bv, No, Au, Av;
        if (dir_shared) {
          invNd = s_dir[j * G + g];
          Bu = s_dir[G * B + j * G + g];
          Bv = s_dir[2 * G * B + j * G + g];
        } else {
          const float Nd = (s_row[j] * dx + s_row[B + j] * dy) + s_row[2 * B + j] * dz;
          invNd = fabsf(Nd) > 1e-30f ? 1.0f / Nd : 0.0f;
          Bu = (s_row[4 * B + j] * dx + s_row[5 * B + j] * dy) + s_row[6 * B + j] * dz;
          Bv = (s_row[7 * B + j] * dx + s_row[8 * B + j] * dy) + s_row[9 * B + j] * dz;
        }
        if (pose_shared) {
          No = s_pose[j * P + p];
          Au = s_pose[P * B + j * P + p];
          Av = s_pose[2 * P * B + j * P + p];
        } else {
          No = s_row[3 * B + j] - ((s_row[j] * ox + s_row[B + j] * oy) + s_row[2 * B + j] * oz);
          Au = ((s_row[4 * B + j] * ox + s_row[5 * B + j] * oy) + s_row[6 * B + j] * oz) -
               s_row[10 * B + j];
          Av = ((s_row[7 * B + j] * ox + s_row[8 * B + j] * oy) + s_row[9 * B + j] * oz) -
               s_row[11 * B + j];
        }
        const float t = No * invNd;
        const float u = Au + t * Bu;
        const float v = Av + t * Bv;
        const float w = kOnePlusEps - (u + v);
        // three comparisons: false on a NaN, like the plain version's
        // NaN-propagating min; a degenerate (or padding) triangle gives
        // invNd = 0 -> t = 0, which only the strict t > t_min gate rejects
        const bool ok = u >= -kEps && v >= -kEps && w >= -kEps && t > t_min;
        const int key = (__float_as_int(ok ? t : kBig) & ~jmask) | j;
        key_min = min(key_min, key);
      }
      const float t_bin = __int_as_float(key_min | jmask);
      if (t_bin < t_best) {
        t_best = t_bin;
        ref = bin * B + (key_min & jmask);
      }
    }
  }

  if (live) {
    const size_t r = (size_t)blk * n_rays + tid;
    t_best_out[r] = t_best;
    ref_out[r] = ref;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int rmcl_intersect_factored(
    const float* tri, const float* o_blk, const float* d_blk, const float* alive,
    const int* cand_bin, const int* cand_count, const float* cand_tnear, const int* order,
    float* t_best, int* ref, int n_blk, int G, int P, int paired, int cb, int B, float t_min,
    float t_max, void* stream) {
  if (n_blk == 0) return 0;
  const int P_eff = paired ? 1 : P;
  const int n_orig = paired ? G : P;
  const int threads = ((G * P_eff + 31) / 32) * 32;
  size_t floats = (size_t)21 * B + 3 * G + 3 * n_orig;
  if (P_eff > 1) floats += (size_t)3 * G * B;
  if (!paired && G > 1) floats += (size_t)3 * P * B;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        intersect_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  intersect_factored_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, o_blk, d_blk, alive, cand_bin, cand_count, cand_tnear, order, t_best, ref, G, P,
      paired, cb, B, t_min, t_max);
  return (int)cudaGetLastError();
}
