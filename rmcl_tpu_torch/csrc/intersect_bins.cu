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
//
// K2g (intersect_groups_kernel) is the JAX package's dir_groups variant of
// the same chunk loop (rmcl_tpu/ops/raycast_binned.py:967-1015): each
// block's rays form G groups that share one direction, so the
// direction-dependent terms of every (triangle, group) are formed once a
// visit and a pair costs three premultiplied dot products and the test
// (24 float operations instead of 47). It shares K1's candidate walk
// (walk_bins below: launch order, staging, the tnear exit, the packed-key
// fold) and is bound by the same pair arithmetic; its design: one thread a
// ray; per visit the CTA fills a shared table of the (triangle, group)
// terms (58 operations an entry), one barrier, then every ray reads its
// group's rows, one address for all the group's threads (a broadcast). The
// table holds B x G entries of 48 bytes (24.6 KB at B = 64, G = 8); where
// that passes kTableBytes the bin's triangles are tabled Bt at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;        // t of "no candidate hit"
constexpr float kEps = 1e-7f;          // barycentric slack
constexpr float kOnePlusEps = 1.0000001f;
constexpr int kMaxWarps = 32;
// K2g's (triangle, group) table: at most this many bytes a CTA
constexpr size_t kTableBytes = 32 * 1024;

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

// The candidate walk that K1 and K2g share. Block blk's candidates are
// visited nearest-first; tile c + 1 is staged by cp.async while tile c is
// tested; one barrier a visit publishes the arrived tile and the warps'
// maxima of t_best; the walk stops once the next candidate's tnear exceeds
// the block's worst t_best; a bin's winner is taken when its packed-key
// minimum, rounded up, is below t_best. `test(st)` returns this thread's
// key minimum over the bin whose float4 triangles start at st; every thread
// of the CTA calls it on every visit (it may hold barriers), so the exit
// above, decided on CTA-wide values, is the same in every thread.
template <typename Test>
__device__ __forceinline__ void walk_bins(const float* __restrict__ tri,
                                          const int* __restrict__ cands,
                                          const float* __restrict__ tnear, int count, int B,
                                          float4* s_tri, float& t_best, int& ref, Test test) {
  __shared__ __align__(16) int s_warp_max[2][kMaxWarps];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int jmask = B - 1;
  const int tile = 3 * B;
  const int log2B = __ffs(B) - 1;

  for (int i = tid; i < 2 * kMaxWarps; i += nt) (&s_warp_max[0][0])[i] = (int)0x80000000;
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

    const int key_min = test(s_tri + par * tile);
    const float t_bin = __int_as_float(key_min | jmask);
    if (t_bin < t_best) {
      t_best = t_bin;
      ref = cands[c] * B + (key_min & jmask);
    }
  }
  cp_async_wait_all();  // a copy started before the exit must land before the CTA ends
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

  // CTA i works on block order[i]; outputs stay in block order
  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rays_per_warp = 32 / S;
  // lane = s * rays_per_warp + (ray within the warp); lanes past the last
  // ray repeat it (same t_best, so the block maximum is unchanged) and
  // write nothing
  const int s = lane / rays_per_warp;
  const int ray = warp * rays_per_warp + lane % rays_per_warp;
  const bool writer = s == 0 && ray < Rb;

  const size_t r = (size_t)blk * Rb + min(ray, Rb - 1);
  const float ox = ob[3 * r + 0], oy = ob[3 * r + 1], oz = ob[3 * r + 2];
  const float dx = db[3 * r + 0], dy = db[3 * r + 1], dz = db[3 * r + 2];
  const float tmin = t_min_b[r];
  float t_best = t_max_b[r];
  int ref = -1;

  walk_bins(tri, cand_bin + (size_t)blk * cb, cand_tnear + (size_t)blk * cb, cand_count[blk], B,
            s_tri, t_best, ref, [&](const float4* st) {
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
      const int key = (__float_as_int(ok ? t : kBig) & ~(B - 1)) | j;
      key_min = min(key_min, key);
    }
    // the S lanes of a ray meet: every one of them then holds the bin's min
    for (int off = rays_per_warp; off < 32; off <<= 1)
      key_min = min(key_min, __shfl_xor_sync(0xffffffffu, key_min, off));
    return key_min;
  });

  if (writer) {
    const size_t w = (size_t)blk * Rb + ray;
    t_best_out[w] = t_best;
    ref_out[w] = ref;
  }
}

// K2g: the same walk for blocks whose Rb rays form G contiguous groups of P
// = Rb / G rays sharing one direction, the group's first ray's (the dense
// engine's dir_groups). Per visit the CTA forms the direction-dependent
// Moller-Trumbore terms of every (triangle, group) once, as the JAX package
// hoists them (rmcl_tpu/ops/raycast_binned.py:967-1015), into a shared
// table of three float4s an entry, (pu, cu), (qv, cv), (nt, ct):
//   u = o.pu - cu,  v = cv - o.qv,  t = o.nt - ct
// and each ray (one thread) reads its group's row, a broadcast to the
// group's threads. The table covers Bt triangles at a time (Bt = B where
// B x G entries fit kTableBytes, else the largest power of two that does).
__global__ void __launch_bounds__(1024) intersect_groups_kernel(
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
    int Rb, int cb, int B, int G, int Bt) {
  extern __shared__ float4 smem[];
  float4* s_tri = smem;               // 2 x [j][3]: v0, e1, e2 (.w unused)
  float4* s_tab = smem + 6 * B;       // [j < Bt][g][3]: (pu, cu), (qv, cv), (nt, ct)
  float4* s_dir = s_tab + 3 * Bt * G; // [g]: the group's direction (.w unused)

  const int blk = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ray = min(tid, Rb - 1);  // threads past the last ray repeat it and write nothing
  const int P = Rb / G;
  const int g = ray / P;

  const size_t r = (size_t)blk * Rb + ray;
  const float ox = ob[3 * r + 0], oy = ob[3 * r + 1], oz = ob[3 * r + 2];
  const float tmin = t_min_b[r];
  float t_best = t_max_b[r];
  int ref = -1;
  // the walk's first barrier publishes these before any test reads them
  for (int i = tid; i < G; i += nt) {
    const float* d = db + 3 * ((size_t)blk * Rb + (size_t)i * P);
    s_dir[i] = make_float4(d[0], d[1], d[2], 0.0f);
  }

  walk_bins(tri, cand_bin + (size_t)blk * cb, cand_tnear + (size_t)blk * cb, cand_count[blk], B,
            s_tri, t_best, ref, [&](const float4* st) {
    int key_min = 0x7fffffff;
    for (int j0 = 0; j0 < B; j0 += Bt) {
      if (j0 > 0) __syncthreads();  // every ray is done with the table's last tile
      // the table: the operation order below is the plain version's, term for term
      for (int e = tid; e < Bt * G; e += nt) {
        const int jj = e / G, gg = e - jj * G;
        const int j = j0 + jj;
        const float4 v0 = st[3 * j], e1 = st[3 * j + 1], e2 = st[3 * j + 2];
        const float4 sd = s_dir[gg];
        const float pvx = sd.y * e2.z - sd.z * e2.y;
        const float pvy = sd.z * e2.x - sd.x * e2.z;
        const float pvz = sd.x * e2.y - sd.y * e2.x;
        const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
        const float inv = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
        const float qdx = sd.y * e1.z - sd.z * e1.y;
        const float qdy = sd.z * e1.x - sd.x * e1.z;
        const float qdz = sd.x * e1.y - sd.y * e1.x;
        const float ngx = e1.y * e2.z - e1.z * e2.y;
        const float ngy = e1.z * e2.x - e1.x * e2.z;
        const float ngz = e1.x * e2.y - e1.y * e2.x;
        const float pux = pvx * inv, puy = pvy * inv, puz = pvz * inv;
        const float qvx = qdx * inv, qvy = qdy * inv, qvz = qdz * inv;
        const float ntx = ngx * inv, nty = ngy * inv, ntz = ngz * inv;
        float4* row = s_tab + 3 * e;
        row[0] = make_float4(pux, puy, puz, v0.x * pux + v0.y * puy + v0.z * puz);
        row[1] = make_float4(qvx, qvy, qvz, v0.x * qvx + v0.y * qvy + v0.z * qvz);
        row[2] = make_float4(ntx, nty, ntz, v0.x * ntx + v0.y * nty + v0.z * ntz);
      }
      __syncthreads();
      const float4* rows = s_tab + 3 * g;
#pragma unroll 4
      for (int jj = 0; jj < Bt; ++jj) {
        const float4 a = rows[3 * G * jj], b = rows[3 * G * jj + 1], c = rows[3 * G * jj + 2];
        const float u = (ox * a.x + oy * a.y + oz * a.z) - a.w;
        const float v = b.w - (ox * b.x + oy * b.y + oz * b.z);
        const float t = (ox * c.x + oy * c.y + oz * c.z) - c.w;
        // a degenerate triangle (padding) gives inv = 0 -> u = v = t = 0,
        // which only the strict t > t_min gate rejects
        const bool ok = fminf(fminf(u, v), kOnePlusEps - (u + v)) >= -kEps && t > tmin;
        const int key = (__float_as_int(ok ? t : kBig) & ~(B - 1)) | (j0 + jj);
        key_min = min(key_min, key);
      }
    }
    return key_min;
  });

  if (tid < Rb) {
    t_best_out[r] = t_best;
    ref_out[r] = ref;
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

// Plain C entry point of K2g. G divides Rb. Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int rmcl_intersect_groups(
    const float* tri, const float* ob, const float* db,
    const float* t_min_b, const float* t_max_b,
    const int* cand_bin, const int* cand_count, const float* cand_tnear,
    const int* order, float* t_best, int* ref,
    int n_blk, int Rb, int cb, int B, int G, void* stream) {
  if (n_blk == 0) return 0;
  if (G < 1 || G > Rb || Rb % G) return (int)cudaErrorInvalidValue;
  const int threads = ((Rb + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  int Bt = B;
  while (Bt > 1 && (size_t)Bt * G * 3 * sizeof(float4) > kTableBytes) Bt >>= 1;
  const size_t smem = ((size_t)6 * B + (size_t)3 * Bt * G + G) * sizeof(float4);
  if (smem + 2 * kMaxWarps * sizeof(int) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        intersect_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  intersect_groups_kernel<<<n_blk, threads, smem, (cudaStream_t)stream>>>(
      tri, ob, db, t_min_b, t_max_b, cand_bin, cand_count, cand_tnear, order,
      t_best, ref, Rb, cb, B, G, Bt);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread (spills show as local memory)
// of K1 (which = 0) or K2g (which = 1) as built. Returns the cudaError of
// the query.
extern "C" int rmcl_intersect_attrs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = which ? cudaFuncGetAttributes(&a, intersect_groups_kernel)
                                : cudaFuncGetAttributes(&a, intersect_bins_kernel);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
