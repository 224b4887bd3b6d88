// Candidate cull of the binned closest-point engine (K7): per block of
// queries, its nearest-first candidate bins by box-box distance lower
// bounds.
//
// Replaces the XLA ops of the JAX package's _cp_candidates
// (rmcl_tpu/ops/closest_point.py:305, with _box_box_d2 at :299), which
// closest_points_binned runs once per query chunk; the plain PyTorch version
// is rmcl_tpu_torch/ops/closest_point.py::_cp_candidates. Per block:
//
//   box:     the block's query box qlo / qhi (the least and greatest of its
//            queries per axis) and d2cap, the greatest of its max_d2;
//   level 0: d2 = gx^2 + gy^2 + gz^2 (summed left to right; g = max(max(bmin
//            - qhi, qlo - bmax), 0)) against every super; the supers with d2
//            <= d2cap, the cs nearest by the key (bits(d2), index) — ties to
//            the lower index, as jax.lax.top_k on -d2;
//   level 1: the S bins of each kept super, valid when d2 <= d2cap and the
//            bin is no padding (gbin < n_bins); the cb least by the packed
//            key (bits(d2) & ~idm) | gbin when the bin ids fit 20 bits, else
//            by the key (bits(d2), position) with position = rank * S + s
//            (the plain version's float path);
//   output:  cand_bin (-1 past the count), cand_count, cand_dlb (the packed
//            key's truncated d2, or d2; 3e38 past the count).
//
// d2 >= +0.0, so the unsigned order of its bits is the float order, and
// every key is unique: the kept keys, sorted, are the plain version's list.
// Built with --fmad=false, the squares and sums round as the plain
// version's, and every pass over a level computes each d2 the same way.
//
// What bounds it on an H100, per shape of the main path:
//   - phase 9 (112,500 blocks, 244 supers of 64, cs 40, cb 835): bytes. A
//     block reads its 128 queries and bounds (2 KB) and writes cb ids and
//     bounds (8 B each, 6.7 KB); the boxes (24 B a super or bin) stay in
//     L2. A box-box test is ~18 float instructions and a block runs n_super
//     + kept x S of them: ~0.03 ms of instructions against ~0.29 ms of
//     bytes. Its lists are short (4.5 bins a block on average), so the
//     sort's tile is sized to the list.
//   - phases 8 and 12 (113 blocks, 119 supers of 64, cs 24 / 84, cb 96 /
//     4,000): bytes too, but below a microsecond (0.2 and 1.2 us), so a
//     launch's few microseconds and each block's chain of barriers are the
//     floor: the design spends its barriers sparingly.
//
// The design. One CTA a block: 512 threads where a level or a kept list is
// wide and the grid is about one wave (phases 8 and 12), 128 where the grid
// is many waves (phase 9); ops/closest_cuda.py::cp_launch_plan picks. The
// block's box and bound are reduced by warp shuffles. Each level's tests
// are spread one box a thread; the level's keys are selected and sorted by
// key_sort.cuh (shared with K3): compacted into a stage in shared memory, a
// radix select of the kept-th key where more pass than the level keeps, a
// bitonic sort of the kept keys alone in warps' registers with the wide
// strides in shared memory, and a level wider than its stage streamed
// (each pass recomputes its tests; the boxes sit in L2). So shared memory
// scales with the kept counts, not with the levels' widths; only a kept
// list that does not fit a CTA (cb, with cs super ids, past ~28,000 keys)
// is refused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_sort.cuh"

// the kernel's arguments, mirrored field for field by ops/closest_cuda.py::_BoxArgs
struct BoxArgs {
  const float* qb;          // (n_blk, Rq, 3)
  const float* d2b;         // (n_blk, Rq)
  const float* super_aabb;  // (n_super, 6)
  const float* bin_aabb;    // (n_bins, 6)
  int* cand_bin;            // (n_blk, cb)
  int* cand_count;          // (n_blk,)
  float* cand_dlb;          // (n_blk, cb)
  int n_blk, Rq, n_super, n_bins, S, cs, cb;
  unsigned idm;   // the packed key's id bits
  int packed;     // 1: packed keys (bin ids within 20 bits); 0: (bits(d2), position)
  int threads;    // a CTA's threads: 128 or 512
  int key_slots;  // shared key slots: >= max(cs, cb); past the kept list, a level's stage
};

namespace {

constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float box_box_d2(const float* lo, const float* hi, const float* b) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gap = fmaxf(fmaxf(b[k] - hi[k], lo[k] - b[3 + k]), 0.0f);
    g[k] = gap * gap;
  }
  return (g[0] + g[1]) + g[2];
}

template <int T>
__global__ void __launch_bounds__(T) cull_boxes_kernel(const BoxArgs A) {
  extern __shared__ u64 smem[];
  u64* region = smem;                                        // key_slots
  int* s_sup = reinterpret_cast<int*>(smem + A.key_slots);  // cs
  constexpr int kWarps = T / 32;
  __shared__ Scratch s;
  __shared__ float s_red[kWarps][7];
  __shared__ float s_box[7];  // qlo(3) qhi(3) d2cap

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // the block's query box and bound (least and greatest: exact in any order)
  const float inf = __int_as_float(0x7f800000);
  float v[7] = {inf, inf, inf, -inf, -inf, -inf, -inf};
  for (int i = tid; i < A.Rq; i += T) {
    const float* q = A.qb + ((size_t)blk * A.Rq + i) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], q[k]);
      v[3 + k] = fmaxf(v[3 + k], q[k]);
    }
    v[6] = fmaxf(v[6], A.d2b[(size_t)blk * A.Rq + i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = k < 3 ? fminf(v[k], o) : fmaxf(v[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) s_red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < 7) {
    float x = s_red[0][tid];
    for (int w = 1; w < kWarps; ++w) x = tid < 3 ? fminf(x, s_red[w][tid]) : fmaxf(x, s_red[w][tid]);
    s_box[tid] = x;
  }
  __syncthreads();
  const float lo[3] = {s_box[0], s_box[1], s_box[2]};
  const float hi[3] = {s_box[3], s_box[4], s_box[5]};
  const float d2cap = s_box[6];

  // level 0: every super; keep the cs nearest by (bits(d2), index)
  const int sh0 = bit_width(A.n_super - 1);
  const auto super_key = [&](int i, u64& key) {
    const float d2 = box_box_d2(lo, hi, A.super_aabb + (size_t)i * 6);
    key = ((u64)__float_as_uint(d2) << sh0) | (unsigned)i;
    return d2 <= d2cap;
  };
  u64* kept;
  const auto supers = on_threads<T>(A.n_super, super_key);
  const int k0 = min(cull_level<T>(supers, supers, A.n_super, A.cs, 31 + sh0, region,
                                   A.key_slots, s, &kept),
                     A.cs);
  for (int k = tid; k < k0; k += T) s_sup[k] = (int)(kept[k] & ((1ULL << sh0) - 1ULL));
  __syncthreads();

  // level 1: the S bins of each kept super; keep the cb nearest
  const int sh1 = bit_width(A.cs * A.S - 1);
  const auto bin_key = [&](int pos, u64& key) {
    const int gbin = s_sup[pos / A.S] * A.S + pos % A.S;
    if (gbin >= A.n_bins) return false;
    const float d2 = box_box_d2(lo, hi, A.bin_aabb + (size_t)gbin * 6);
    const unsigned bits = __float_as_uint(fmaxf(d2, 0.0f));
    key = A.packed ? (u64)((bits & ~A.idm) | (unsigned)gbin) : (((u64)bits << sh1) | (unsigned)pos);
    return d2 <= d2cap;
  };
  const auto bins = on_threads<T>(k0 * A.S, bin_key);
  const int m = min(cull_level<T>(bins, bins, k0 * A.S, A.cb, A.packed ? 31 : 31 + sh1, region,
                                  A.key_slots, s, &kept),
                    A.cb);
  for (int k = tid; k < A.cb; k += T) {
    int id = -1;
    float dlb = kBig;
    if (k < m) {
      const u64 key = kept[k];
      if (A.packed) {
        id = (int)((unsigned)key & A.idm);
        dlb = __uint_as_float((unsigned)key & ~A.idm);
      } else {
        const int pos = (int)(key & ((1ULL << sh1) - 1ULL));
        id = s_sup[pos / A.S] * A.S + pos % A.S;
        dlb = __uint_as_float((unsigned)(key >> sh1));
      }
    }
    A.cand_bin[(size_t)blk * A.cb + k] = id;
    A.cand_dlb[(size_t)blk * A.cb + k] = dlb;
  }
  if (tid == 0) A.cand_count[blk] = m;
}

// a kernel that does nothing: at K7's grid, the device time of a launch
// alone, the floor under K7's time where its bound is below a microsecond
__global__ void launch_floor_kernel() {}

template <int T>
int launch(const BoxArgs& A, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cull_boxes_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return (int)err;
    }
  }
  cull_boxes_kernel<T><<<A.n_blk, T, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success; cudaErrorInvalidValue for budgets out of range,
// a width other than 128 or 512, or key slots below a kept list; the
// attribute's error for shared memory beyond what a CTA may hold.
extern "C" int rmcl_cull_boxes(const BoxArgs* args, void* stream) {
  const BoxArgs& A = *args;
  if (A.n_blk == 0) return 0;
  if (A.cs < 1 || A.cs > A.n_super || A.cb < 1 || A.cb > A.cs * A.S || A.key_slots < A.cs ||
      A.key_slots < A.cb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A.key_slots * sizeof(u64) + (size_t)A.cs * sizeof(int);
  if (A.threads == 512) return launch<512>(A, smem, (cudaStream_t)stream);
  if (A.threads == 128) return launch<128>(A, smem, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Registers, local-memory bytes (spills show as local memory) and static
// shared bytes of the kernel at a CTA width of 128 or 512 threads. Returns
// the cudaFuncGetAttributes error.
extern "C" int rmcl_cull_boxes_attrs(int threads, int* regs, int* local_bytes, int* static_smem) {
  cudaFuncAttributes a;
  const cudaError_t err = threads == 512 ? cudaFuncGetAttributes(&a, cull_boxes_kernel<512>)
                                         : cudaFuncGetAttributes(&a, cull_boxes_kernel<128>);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  return (int)err;
}

// One launch of the empty kernel at n_blk CTAs of the given threads (for
// timing the launch floor). Returns cudaGetLastError().
extern "C" int rmcl_launch_floor(int n_blk, int threads, void* stream) {
  launch_floor_kernel<<<n_blk, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
