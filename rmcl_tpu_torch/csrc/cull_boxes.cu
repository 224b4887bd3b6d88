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
// every key is unique: the sorted prefix is the plain version's list. Built
// with --fmad=false, the squares and sums round as the plain version's.
//
// What bounds it on an H100: bytes. A block reads its 128 queries and
// bounds (2 KB) and writes cb ids and bounds (8 B each); the boxes (24 B a
// super or bin) stay in L2. A box-box test is ~18 float instructions, and
// a block runs n_super + cs x S of them, so at phase 9 (112,500 blocks, 975
// supers, cs x S = 624) the instructions take ~0.03 ms against ~0.29 ms for
// the bytes. The design, K3's back end on boxes: one CTA of 128 threads a
// block; the block's box and bound reduced by warp shuffles; each level's
// tests spread one box a thread, the passing boxes compacted by ballot and
// popcount (one shared atomic a warp step) and only those sorted (one warp's
// shuffles up to 32 keys, a bitonic sort in shared memory beyond,
// key_sort.cuh); shared memory sized for the widest level.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
  unsigned idm;  // the packed key's id bits
  int packed;    // 1: packed keys (bin ids within 20 bits); 0: (bits(d2), position)
  int key_cap;   // shared key slots: a power of two >= max(n_super, cs * S, 32)
};

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float box_box_d2(const float* lo, const float* hi, const float* b) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gap = fmaxf(fmaxf(b[k] - hi[k], lo[k] - b[3 + k]), 0.0f);
    g[k] = gap * gap;
  }
  return (g[0] + g[1]) + g[2];
}

// append key to keys[] where pass holds: the warp's passes compacted by
// ballot and popcount, one shared atomic a warp step
__device__ __forceinline__ void append(bool pass, unsigned long long key,
                                       unsigned long long* keys, int* s_count) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if (!ballot) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(s_count, __popc(ballot));
  at = __shfl_sync(0xffffffffu, at, 0);
  if (pass) keys[at + __popc(ballot & ((1u << lane) - 1u))] = key;
}

__global__ void __launch_bounds__(kThreads) cull_boxes_kernel(const BoxArgs A) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_keys = smem;                       // key_cap
  int* s_sup = reinterpret_cast<int*>(smem + A.key_cap);  // cs
  __shared__ float s_red[kWarps][7];
  __shared__ float s_box[7];  // qlo(3) qhi(3) d2cap
  __shared__ int s_count;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // the block's query box and bound (least and greatest: exact in any order)
  const float inf = __int_as_float(0x7f800000);
  float v[7] = {inf, inf, inf, -inf, -inf, -inf, -inf};
  for (int i = tid; i < A.Rq; i += kThreads) {
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
  if (tid == 0) s_count = 0;
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

  // level 0: every super; keep the cs nearest
  for (int base = 0; base < A.n_super; base += kThreads) {
    const int i = base + tid;
    bool pass = false;
    unsigned long long key = 0;
    if (i < A.n_super) {
      const float d2 = box_box_d2(lo, hi, A.super_aabb + (size_t)i * 6);
      pass = d2 <= d2cap;
      key = ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)i;
    }
    append(pass, key, s_keys, &s_count);
  }
  int m = take_count(&s_count);
  sort_keys(s_keys, m);
  const int kept = min(m, A.cs);
  for (int k = tid; k < kept; k += kThreads) s_sup[k] = (int)(s_keys[k] & 0xffffffffu);
  __syncthreads();

  // level 1: the S bins of each kept super; keep the cb nearest
  const int n1 = kept * A.S;
  for (int base = 0; base < n1; base += kThreads) {
    const int pos = base + tid;
    bool pass = false;
    unsigned long long key = 0;
    if (pos < n1) {
      const int gbin = s_sup[pos / A.S] * A.S + pos % A.S;
      if (gbin < A.n_bins) {
        const float d2 = box_box_d2(lo, hi, A.bin_aabb + (size_t)gbin * 6);
        const unsigned bits = __float_as_uint(fmaxf(d2, 0.0f));
        pass = d2 <= d2cap;
        key = A.packed ? (unsigned long long)((bits & ~A.idm) | (unsigned)gbin)
                       : (((unsigned long long)bits << 32) | (unsigned)pos);
      }
    }
    append(pass, key, s_keys, &s_count);
  }
  m = take_count(&s_count);
  sort_keys(s_keys, m);
  for (int k = tid; k < A.cb; k += kThreads) {
    int id = -1;
    float dlb = kBig;
    if (k < m) {
      const unsigned long long key = s_keys[k];
      if (A.packed) {
        id = (int)((unsigned)key & A.idm);
        dlb = __uint_as_float((unsigned)key & ~A.idm);
      } else {
        const int pos = (int)(key & 0xffffffffu);
        id = s_sup[pos / A.S] * A.S + pos % A.S;
        dlb = __uint_as_float((unsigned)(key >> 32));
      }
    }
    A.cand_bin[(size_t)blk * A.cb + k] = id;
    A.cand_dlb[(size_t)blk * A.cb + k] = dlb;
  }
  if (tid == 0) A.cand_count[blk] = min(m, A.cb);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success; cudaErrorInvalidValue for a key_cap below the
// widest level or shared memory beyond what a CTA may hold.
extern "C" int rmcl_cull_boxes(const BoxArgs* args, void* stream) {
  const BoxArgs& A = *args;
  if (A.n_blk == 0) return 0;
  const int widest = std::max(std::max(A.n_super, A.cs * A.S), 32);
  if (A.key_cap < widest || A.key_cap != pow2_at_least(A.key_cap) || A.cb > A.cs * A.S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A.key_cap * sizeof(unsigned long long) + (size_t)A.cs * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cull_boxes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cull_boxes_kernel<<<A.n_blk, kThreads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread (spills show as local memory).
// Returns the cudaFuncGetAttributes error.
extern "C" int rmcl_cull_boxes_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, cull_boxes_kernel);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}
