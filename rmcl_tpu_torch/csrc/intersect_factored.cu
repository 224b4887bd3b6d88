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
// memory. So the design spends as few other instructions per pair as it
// can, and keeps every lane busy:
//   * the bin's B triangles are split over S lane groups of a warp (lane s
//     tests j = s, s + S, ...); their partial key minima meet by
//     __shfl_xor_sync. The packed key is unique per triangle and the min is
//     associative, so the split changes no result;
//   * tile layout (P >= 2 poses and G >= 2 directions, not paired: the
//     pose sweep): a thread owns 2 poses x 2 directions, S = 4. The
//     per-(tri, dir) triple (invNd, Bu, Bv) and the per-(tri, pose) triple
//     (No, Au, Av) are float4s in shared memory, [j][g] and [j][p] with one
//     float4 of padding per row, so a pair costs one 128-bit shared load:
//     the 8 lanes of a quarter-warp read one j, one direction (broadcast)
//     and 8 neighbouring poses (no bank conflict), and the term phase's
//     stores spread over all banks. All threads form the terms: each
//     triangle's row is computed by the nt / B threads that share its
//     terms, straight from the staged tile (no round trip of the rows);
//   * ray layout (the tracking layout P = 1, the paired layout, and any
//     block too large for the tile layout): a thread owns one ray and forms
//     its direction terms (and, unless the block has one shared pose, its
//     pose terms) from the triangle's row, three float4s in shared memory
//     (a fourth holds the shared pose terms); S from the wrapper's rule;
//   * the next candidate's 9 x B floats are copied into the second of two
//     shared buffers by cp.async while the current one is worked on; a copy
//     is started only for a slot < count (no sentinel slot is ever read);
//   * two barriers per visit: one publishes the arrived tile and the warps'
//     maxima of t_best for the block-wide early exit (K1's warp-shuffle
//     max; the maxima alternate between two shared arrays), one publishes
//     the terms.
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
constexpr int kTileSplit = 4;  // lane groups per ray tile in the tile layout
constexpr int kRowStride = 5;  // float4s per triangle row in the ray layout (4 + padding)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

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

// Start the copy of one bin's v0/e1/e2 planes (9 * B floats): 16-byte
// copies when B % 4 == 0 (tri is 16-byte aligned, a row starts at
// bin * 56 * B bytes), else 4-byte ones.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int B, int tid, int nt) {
  if ((B & 3) == 0) {
    for (int i = tid; i < (9 * B) / 4; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < 9 * B; i += nt) cp_async4(dst + i, src + i);
  }
  cp_async_commit();
}

struct Row {
  float ngx, ngy, ngz, c0, m1x, m1y, m1z, cu, m2x, m2y, m2z, cv;
};

// Triangle j's Baldwin-Weber row from the staged v0/e1/e2 planes.
__device__ __forceinline__ Row bw_row(const float* st, int B, int j) {
  const float v0x = st[0 * B + j], v0y = st[1 * B + j], v0z = st[2 * B + j];
  const float e1x = st[3 * B + j], e1y = st[4 * B + j], e1z = st[5 * B + j];
  const float e2x = st[6 * B + j], e2y = st[7 * B + j], e2z = st[8 * B + j];
  Row r;
  r.ngx = e1y * e2z - e1z * e2y;
  r.ngy = e1z * e2x - e1x * e2z;
  r.ngz = e1x * e2y - e1y * e2x;
  const float nn = (r.ngx * r.ngx + r.ngy * r.ngy) + r.ngz * r.ngz;
  const float inv_nn = 1.0f / fmaxf(nn, 1e-30f);
  r.m1x = (e2y * r.ngz - e2z * r.ngy) * inv_nn;
  r.m1y = (e2z * r.ngx - e2x * r.ngz) * inv_nn;
  r.m1z = (e2x * r.ngy - e2y * r.ngx) * inv_nn;
  r.m2x = (r.ngy * e1z - r.ngz * e1y) * inv_nn;
  r.m2y = (r.ngz * e1x - r.ngx * e1z) * inv_nn;
  r.m2z = (r.ngx * e1y - r.ngy * e1x) * inv_nn;
  r.c0 = (r.ngx * v0x + r.ngy * v0y) + r.ngz * v0z;
  r.cu = (v0x * r.m1x + v0y * r.m1y) + v0z * r.m1z;
  r.cv = (v0x * r.m2x + v0y * r.m2y) + v0z * r.m2z;
  return r;
}

// (invNd, Bu, Bv) of a row (ng, m1, m2 in the .xyz of three float4s) and a
// direction e.
__device__ __forceinline__ float4 dir_terms(float4 ng, float4 m1, float4 m2, float4 e) {
  const float Nd = (ng.x * e.x + ng.y * e.y) + ng.z * e.z;
  return make_float4(fabsf(Nd) > 1e-30f ? 1.0f / Nd : 0.0f,
                     (m1.x * e.x + m1.y * e.y) + m1.z * e.z,
                     (m2.x * e.x + m2.y * e.y) + m2.z * e.z, 0.0f);
}

// (No, Au, Av) of a row ((ng, c0), (m1, cu), (m2, cv)) and an origin q.
__device__ __forceinline__ float4 pose_terms(float4 ng, float4 m1, float4 m2, float4 q) {
  return make_float4(ng.w - ((ng.x * q.x + ng.y * q.y) + ng.z * q.z),
                     ((m1.x * q.x + m1.y * q.y) + m1.z * q.z) - m1.w,
                     ((m2.x * q.x + m2.y * q.y) + m2.z * q.z) - m2.w, 0.0f);
}

// n packed (x, y, z) vectors from global memory into float4s in shared memory.
__device__ __forceinline__ void load_vectors(float4* dst, const float* src, int n, int tid,
                                             int nt) {
  for (int i = tid; i < n; i += nt)
    dst[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 0.0f);
}

// The packed key of one pair from its pose terms q and direction terms d.
__device__ __forceinline__ int pair_key(float4 q, float4 d, float t_min, int jmask, int j) {
  const float t = q.x * d.x;
  const float u = q.y + t * d.y;
  const float v = q.z + t * d.z;
  const float w = kOnePlusEps - (u + v);
  // three comparisons: false on a NaN, like the plain version's
  // NaN-propagating min; a degenerate (or padding) triangle gives
  // invNd = 0 -> t = 0, which only the strict t > t_min gate rejects
  const bool ok = u >= -kEps && v >= -kEps && w >= -kEps && t > t_min;
  return (__float_as_int(ok ? t : kBig) & ~jmask) | j;
}

// The block's worst t_best for the early exit: this warp's max over
// `bits`, published in s_wm[warp]; after the barrier every thread reads the
// words back with int4 loads (unused words hold INT_MIN).
__device__ __forceinline__ int block_worst(const int* s_wm, int n_warps) {
  const int4* wm = reinterpret_cast<const int4*>(s_wm);
  int worst = (int)0x80000000;
  for (int w = 0; w < n_warps; w += 4) {
    const int4 q = wm[w >> 2];
    worst = max(max(worst, q.x), max(q.y, max(q.z, q.w)));
  }
  return worst;
}

__device__ __forceinline__ int warp_max(int bits) {
  for (int off = 16; off > 0; off >>= 1)
    bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
  return bits;
}

// Tile layout: the sweep's P poses x G directions, 2 x 2 rays a thread. At
// most 64 registers a thread, so eight of the sweep's 128-thread CTAs fit an
// SM by registers (with 84, under (256, 2), it ran slower on an H100).
__global__ void __launch_bounds__(256, 4) factored_tile_kernel(
    const float* __restrict__ tri,        // (n_rows, 14, B)
    const float* __restrict__ o_blk,      // (n_blk, P, 3)
    const float* __restrict__ d_blk,      // (n_blk, G, 3)
    const float* __restrict__ alive,      // (n_blk,)
    const int* __restrict__ cand_bin,     // (n_blk, cb)
    const int* __restrict__ cand_count,   // (n_blk,)
    const float* __restrict__ cand_tnear, // (n_blk, cb)
    const int* __restrict__ order,        // (n_blk,) launch order, or null
    float* __restrict__ t_best_out,       // (n_blk, G, P)
    int* __restrict__ ref_out,            // (n_blk, G, P)
    int G, int P, int cb, int B, float t_min, float t_max) {
  extern __shared__ float4 smem4[];
  float4* s_dir = smem4;                               // [j][G + 1]
  float4* s_pose = s_dir + (size_t)B * (G + 1);        // [j][P + 1]
  float4* s_d = s_pose + (size_t)B * (P + 1);          // G directions
  float4* s_o = s_d + G;                               // P origins
  float* s_tri = reinterpret_cast<float*>(s_o + P);    // 2 x 9 * B
  __shared__ __align__(16) int s_warp_max[2][kMaxWarps];

  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int jmask = B - 1;

  // lane = s * 8 + (tile within the warp); tiles past the last repeat it
  const int s = lane >> 3;
  const int n_pt = (P + 1) >> 1, n_gt = (G + 1) >> 1;
  const int tile = warp * 8 + (lane & 7);
  const int tl = min(tile, n_pt * n_gt - 1);
  const int pt = tl % n_pt, gt = tl / n_pt;
  // poses pt and pt + n_pt, directions gt and gt + n_gt (clamped: an odd
  // count repeats the last one, which writes nothing)
  const int p0 = pt, p1 = min(pt + n_pt, P - 1);
  const int g0 = gt, g1 = min(gt + n_gt, G - 1);

  for (int i = tid; i < 2 * kMaxWarps; i += nt) (&s_warp_max[0][0])[i] = (int)0x80000000;
  load_vectors(s_d, d_blk + (size_t)blk * 3 * G, G, tid, nt);
  load_vectors(s_o, o_blk + (size_t)blk * 3 * P, P, tid, nt);

  const float t0 = alive[blk] * t_max;
  float tb[4] = {t0, t0, t0, t0};  // rays (g0,p0), (g0,p1), (g1,p0), (g1,p1)
  int ref[4] = {-1, -1, -1, -1};
  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* tnear = cand_tnear + (size_t)blk * cb;
  if (count > 0) stage_tile(s_tri, tri + (size_t)cands[0] * 14 * B, B, tid, nt);
  __syncthreads();  // s_d, s_o and the INT_MIN fill

  // term phase: nt / B threads share each triangle, each forming its row
  const int h = max(1, nt / B);
  const int part = tid % h;
  const int j_first = tid / h, j_step = nt / h;

  for (int c = 0; c < count; ++c) {
    const int par = c & 1;
    int bits = max(max(__float_as_int(tb[0]), __float_as_int(tb[1])),
                   max(__float_as_int(tb[2]), __float_as_int(tb[3])));
    bits = warp_max(bits);
    if (lane == 0) s_warp_max[par][warp] = bits;
    cp_async_wait_all();
    // barrier 1: tile c and the maxima are visible; every thread's reads of
    // tile c - 1 and of the previous terms are over
    __syncthreads();
    if (tnear[c] > __int_as_float(block_worst(s_warp_max[par], n_warps))) break;

    const int bin = cands[c];
    if (c + 1 < count)
      stage_tile(s_tri + (par ^ 1) * 9 * B, tri + (size_t)cands[c + 1] * 14 * B, B, tid, nt);

    const float* st = s_tri + par * 9 * B;
    for (int j = j_first; j < B; j += j_step) {
      const Row r = bw_row(st, B, j);
      const float4 ng = make_float4(r.ngx, r.ngy, r.ngz, r.c0);
      const float4 m1 = make_float4(r.m1x, r.m1y, r.m1z, r.cu);
      const float4 m2 = make_float4(r.m2x, r.m2y, r.m2z, r.cv);
      for (int g = part; g < G; g += h)
        s_dir[(size_t)j * (G + 1) + g] = dir_terms(ng, m1, m2, s_d[g]);
      for (int p = part; p < P; p += h)
        s_pose[(size_t)j * (P + 1) + p] = pose_terms(ng, m1, m2, s_o[p]);
    }
    __syncthreads();  // barrier 2: the terms are visible

    int km[4] = {0x7fffffff, 0x7fffffff, 0x7fffffff, 0x7fffffff};
#pragma unroll 4
    for (int j = s; j < B; j += kTileSplit) {
      const float4* dj = s_dir + (size_t)j * (G + 1);
      const float4* pj = s_pose + (size_t)j * (P + 1);
      const float4 d0 = dj[g0], d1 = dj[g1];
      const float4 q0 = pj[p0], q1 = pj[p1];
      km[0] = min(km[0], pair_key(q0, d0, t_min, jmask, j));
      km[1] = min(km[1], pair_key(q1, d0, t_min, jmask, j));
      km[2] = min(km[2], pair_key(q0, d1, t_min, jmask, j));
      km[3] = min(km[3], pair_key(q1, d1, t_min, jmask, j));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int m = km[k];
      m = min(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = min(m, __shfl_xor_sync(0xffffffffu, m, 16));
      const float t_bin = __int_as_float(m | jmask);
      if (t_bin < tb[k]) {
        tb[k] = t_bin;
        ref[k] = bin * B + (m & jmask);
      }
    }
  }
  cp_async_wait_all();  // a copy started before the exit must land before the CTA ends

  if (s == 0 && tile < n_pt * n_gt) {
    const size_t base = (size_t)blk * G * P;
    const bool p1_own = pt + n_pt < P, g1_own = gt + n_gt < G;
    t_best_out[base + g0 * P + p0] = tb[0];
    ref_out[base + g0 * P + p0] = ref[0];
    if (p1_own) {
      t_best_out[base + g0 * P + p1] = tb[1];
      ref_out[base + g0 * P + p1] = ref[1];
    }
    if (g1_own) {
      t_best_out[base + g1 * P + p0] = tb[2];
      ref_out[base + g1 * P + p0] = ref[2];
    }
    if (p1_own && g1_own) {
      t_best_out[base + g1 * P + p1] = tb[3];
      ref_out[base + g1 * P + p1] = ref[3];
    }
  }
}

// Ray layout: one ray a thread, S lane groups a ray. kSinglePose: the block
// has one origin (P = 1, not paired), whose terms are shared per triangle.
template <bool kSinglePose>
__global__ void __launch_bounds__(1024) factored_ray_kernel(
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
    int G, int P, int paired, int cb, int B, int S, float t_min, float t_max) {
  const int P_eff = paired ? 1 : P;
  const int n_orig = paired ? G : P;
  const int n_rays = G * P_eff;

  extern __shared__ float4 smem4[];
  float4* s_row = smem4;                                 // [j][kRowStride]
  float4* s_d = s_row + (size_t)kRowStride * B;          // G directions
  float4* s_o = s_d + G;                                 // n_orig origins
  float* s_tri = reinterpret_cast<float*>(s_o + n_orig); // 2 x 9 * B
  __shared__ __align__(16) int s_warp_max[2][kMaxWarps];

  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int jmask = B - 1;
  const int rays_per_warp = 32 / S;
  // lane = s * rays_per_warp + (ray within the warp); lanes past the last
  // ray repeat it and write nothing
  const int s = lane / rays_per_warp;
  const int ray = warp * rays_per_warp + lane % rays_per_warp;
  const int rr = min(ray, n_rays - 1);
  const int g = rr / P_eff, p = rr % P_eff;

  for (int i = tid; i < 2 * kMaxWarps; i += nt) (&s_warp_max[0][0])[i] = (int)0x80000000;
  load_vectors(s_d, d_blk + (size_t)blk * 3 * G, G, tid, nt);
  load_vectors(s_o, o_blk + (size_t)blk * 3 * n_orig, n_orig, tid, nt);

  float t_best = alive[blk] * t_max;
  int ref = -1;
  const int count = cand_count[blk];
  const int* cands = cand_bin + (size_t)blk * cb;
  const float* tnear = cand_tnear + (size_t)blk * cb;
  if (count > 0) stage_tile(s_tri, tri + (size_t)cands[0] * 14 * B, B, tid, nt);
  __syncthreads();  // s_d, s_o and the INT_MIN fill
  const float4 dir = s_d[g];
  const float4 org = s_o[paired ? g : p];

  for (int c = 0; c < count; ++c) {
    const int par = c & 1;
    const int bits = warp_max(__float_as_int(t_best));
    if (lane == 0) s_warp_max[par][warp] = bits;
    cp_async_wait_all();
    // barrier 1: tile c and the maxima are visible; every thread's reads of
    // tile c - 1 and of the previous rows are over
    __syncthreads();
    if (tnear[c] > __int_as_float(block_worst(s_warp_max[par], n_warps))) break;

    const int bin = cands[c];
    if (c + 1 < count)
      stage_tile(s_tri + (par ^ 1) * 9 * B, tri + (size_t)cands[c + 1] * 14 * B, B, tid, nt);

    const float* st = s_tri + par * 9 * B;
    for (int j = tid; j < B; j += nt) {
      const Row r = bw_row(st, B, j);
      float4* row = s_row + (size_t)kRowStride * j;
      row[0] = make_float4(r.ngx, r.ngy, r.ngz, r.c0);
      row[1] = make_float4(r.m1x, r.m1y, r.m1z, r.cu);
      row[2] = make_float4(r.m2x, r.m2y, r.m2z, r.cv);
      if (kSinglePose) row[3] = pose_terms(row[0], row[1], row[2], s_o[0]);
    }
    __syncthreads();  // barrier 2: the rows are visible

    int key_min = 0x7fffffff;
#pragma unroll 4
    for (int j = s; j < B; j += S) {
      const float4* row = s_row + (size_t)kRowStride * j;
      const float4 ng = row[0], m1 = row[1], m2 = row[2];
      const float4 d = dir_terms(ng, m1, m2, dir);
      const float4 q = kSinglePose ? row[3] : pose_terms(ng, m1, m2, org);
      key_min = min(key_min, pair_key(q, d, t_min, jmask, j));
    }
    for (int off = rays_per_warp; off < 32; off <<= 1)
      key_min = min(key_min, __shfl_xor_sync(0xffffffffu, key_min, off));
    const float t_bin = __int_as_float(key_min | jmask);
    if (t_bin < t_best) {
      t_best = t_bin;
      ref = bin * B + (key_min & jmask);
    }
  }
  cp_async_wait_all();

  if (s == 0 && ray < n_rays) {
    const size_t r = (size_t)blk * n_rays + ray;
    t_best_out[r] = t_best;
    ref_out[r] = ref;
  }
}

// Dynamic shared memory beyond 48 KB, static (the maxima) included, must be
// allowed per kernel.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem + 2 * kMaxWarps * sizeof(int) <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `tile` and S are the layout the
// wrapper chose (ops/raycast_cuda.py::factored_layout): tile = 1 for the
// 2 x 2 tile layout (S = 4), 0 for the ray layout with S lane groups a ray.
// tri must be 16-byte aligned. Returns cudaGetLastError() after the launch:
// 0 on success.
extern "C" int rmcl_intersect_factored(
    const float* tri, const float* o_blk, const float* d_blk, const float* alive,
    const int* cand_bin, const int* cand_count, const float* cand_tnear, const int* order,
    float* t_best, int* ref, int n_blk, int G, int P, int paired, int cb, int B, int tile, int S,
    float t_min, float t_max, void* stream) {
  if (n_blk == 0) return 0;
  if ((uintptr_t)tri & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile) {
    if (paired || P < 2 || G < 2 || S != kTileSplit) return (int)cudaErrorInvalidValue;
    const int n_tiles = ((P + 1) / 2) * ((G + 1) / 2);
    const int threads = ((n_tiles + 7) / 8) * 32;
    if (threads > 256) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)16 * (B * (G + P + 2) + G + P) + (size_t)4 * 18 * B;
    int err = allow_smem(factored_tile_kernel, smem);
    if (err) return err;
    factored_tile_kernel<<<n_blk, threads, smem, st>>>(
        tri, o_blk, d_blk, alive, cand_bin, cand_count, cand_tnear, order, t_best, ref, G, P, cb,
        B, t_min, t_max);
    return (int)cudaGetLastError();
  }
  if (S < 1 || S > 32 || (S & (S - 1))) return (int)cudaErrorInvalidValue;
  const int P_eff = paired ? 1 : P;
  const int n_orig = paired ? G : P;
  const int rays_per_warp = 32 / S;
  const int threads = ((G * P_eff + rays_per_warp - 1) / rays_per_warp) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)16 * (kRowStride * B + G + n_orig) + (size_t)4 * 18 * B;
  if (!paired && P == 1) {
    int err = allow_smem(factored_ray_kernel<true>, smem);
    if (err) return err;
    factored_ray_kernel<true><<<n_blk, threads, smem, st>>>(
        tri, o_blk, d_blk, alive, cand_bin, cand_count, cand_tnear, order, t_best, ref, G, P,
        paired, cb, B, S, t_min, t_max);
  } else {
    int err = allow_smem(factored_ray_kernel<false>, smem);
    if (err) return err;
    factored_ray_kernel<false><<<n_blk, threads, smem, st>>>(
        tri, o_blk, d_blk, alive, cand_bin, cand_count, cand_tnear, order, t_best, ref, G, P,
        paired, cb, B, S, t_min, t_max);
  }
  return (int)cudaGetLastError();
}
