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
// are spread one box a thread and the passing keys compacted by ballot and
// popcount (one shared atomic a warp step) into a stage in shared memory.
// When more keys pass than the level keeps, an MSB-first radix select finds
// the kept-th least key (8-bit digits over the key's live bits; a shared
// histogram built with warp-aggregated atomics, scanned by one warp; it
// stops as soon as the digit's bucket is taken whole), then the keys at or
// below it are compacted: exactly the kept count, since keys are unique.
// Only those are sorted, by a bitonic network whose comparators all put the
// lesser key at the lower index, so the keys past the count are virtual (no
// padding to a power of two): strides inside a warp's tile of 256 keys run
// in registers (8 a lane, striped) and by shuffles, only wider strides go
// through shared memory with a barrier; a list of up to 32, 64 or 128 keys
// takes a tile of 1, 2 or 4 keys a lane. A level that passes more keys than
// its stage holds is streamed: each radix pass and the compaction recompute
// its tests (the boxes sit in L2), so shared memory scales with the kept
// counts, not with the levels' widths; only a kept list that does not fit a
// CTA (cb, with cs super ids, past ~28,000 keys) is refused.

#include <cuda_runtime.h>
#include <stdint.h>

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

using u64 = unsigned long long;

constexpr float kBig = 3.0e38f;
constexpr u64 kSentinel = ~0ULL;
constexpr int kItems = 8;           // keys a lane holds in a full sort tile
constexpr int kTile = kItems * 32;  // keys a warp sorts in registers

struct Scratch {
  int count;            // keys appended by the current pass
  int digit, bucket;    // the radix select's step: its digit and that bucket's count,
  int rank;             // and the rank left inside the bucket
  unsigned hist[256];   // the radix select's digit histogram
};

__device__ __forceinline__ float box_box_d2(const float* lo, const float* hi, const float* b) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gap = fmaxf(fmaxf(b[k] - hi[k], lo[k] - b[3 + k]), 0.0f);
    g[k] = gap * gap;
  }
  return (g[0] + g[1]) + g[2];
}

__device__ __forceinline__ int bit_width(int n) { return n > 0 ? 32 - __clz(n) : 0; }

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// append key to keys[] where pass holds and its slot is below cap: the
// warp's passes compacted by ballot and popcount, one shared atomic a warp
// step; the count goes on past cap
__device__ __forceinline__ void append(bool pass, u64 key, u64* keys, int cap, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if (!ballot) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(count, __popc(ballot));
  at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
  if (pass && at < cap) keys[at] = key;
}

// the keys of items 0..n-1 that pass and are <= thr appended to keys[] (at
// most cap stored); returns how many passed. src(i, key) sets item i's key
// and returns whether it passes.
template <int T, class Src>
__device__ int gather(const Src& src, int n, u64 thr, u64* keys, int cap, Scratch& s) {
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  for (int base = 0; base < n; base += T) {
    const int i = base + threadIdx.x;
    u64 key = 0;
    const bool pass = i < n && src(i, key) && key <= thr;
    append(pass, key, keys, cap, &s.count);
  }
  __syncthreads();
  const int m = s.count;
  __syncthreads();
  return m;
}

// the rank-th least (1-based) of the passing keys of items 0..n-1, each
// below 2^bits and unique, by an MSB-first radix select; returns the
// threshold t with exactly rank passing keys <= t
template <int T, class Src>
__device__ u64 select_kth(const Src& src, int n, int rank, int bits, Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  u64 prefix = 0, mask = 0;
  int left = bits;
  for (;;) {
    const int shift = left > 8 ? left - 8 : 0;
    const unsigned dmask = (1u << (left - shift)) - 1u;
    for (int b = tid; b < 256; b += T) s.hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += T) {
      const int i = base + tid;
      u64 key = 0;
      const bool in = i < n && src(i, key) && (key & mask) == prefix;
      const int digit = in ? (int)((key >> shift) & dmask) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (tid < 32) {  // one warp scans the 256 buckets, 8 a lane
      unsigned c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (c[j] = s.hist[lane * 8 + j]);
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned below = incl - sum;
      const unsigned r = (unsigned)rank;
      if (below < r && r <= incl) {
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!found && r <= below + c[j]) {
            found = true;
            s.digit = lane * 8 + j;
            s.bucket = (int)c[j];
            s.rank = (int)(r - below);
          }
          below += c[j];
        }
      }
    }
    __syncthreads();
    const int bucket = s.bucket;
    rank = s.rank;
    prefix |= (u64)s.digit << shift;
    mask |= (u64)dmask << shift;
    // the bucket taken whole: every key below it, and all of it
    if (bucket == rank || shift == 0) return prefix | ((1ULL << shift) - 1ULL);
    left = shift;
  }
}

// --- the sort: a bitonic network with every comparator ascending --------
//
// Block size K: first element e against e ^ (K - 1) (the mirror), then
// against e ^ j for j = K/4 .. 1. The lesser key always goes to the lower
// index, so keys past the count c act as +inf and are never touched. A
// warp's tile of 32 N keys holds r[t] = element base + t * 32 + lane; the
// tile is sized to the count (N = 1, 2, 4 or 8), so a short list spends no
// issue slots on empty items.

__device__ __forceinline__ void order2(u64& lo, u64& hi) {
  const u64 a = lo;
  lo = min(a, hi);
  hi = max(a, hi);
}

// the stage of partners e ^ J (J < 32 across lanes, else across a lane's
// items); items wholly past the count hold sentinels, which a stage across
// lanes leaves as they are
template <int N, int J>
__device__ __forceinline__ void stage_xor(u64 (&r)[N], int lane, int live) {
  if constexpr (J < 32) {
    const bool lower = (lane & J) == 0;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t * 32 < live) {
        const u64 o = __shfl_xor_sync(0xffffffffu, r[t], J);
        r[t] = lower ? min(r[t], o) : max(r[t], o);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t)
      if ((t & (J / 32)) == 0) order2(r[t], r[t | (J / 32)]);
  }
}

// the mirror stage of block size K: partners e ^ (K - 1)
template <int N, int K>
__device__ __forceinline__ void stage_mirror(u64 (&r)[N], int lane, int live) {
  if constexpr (K <= 32) {
    const bool lower = (lane & (K / 2)) == 0;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t * 32 < live) {
        const u64 o = __shfl_xor_sync(0xffffffffu, r[t], K - 1);
        r[t] = lower ? min(r[t], o) : max(r[t], o);
      }
    }
  } else {  // lane ^ 31 and item t ^ X: r[t] is the lower of its pair when bit H of t is clear
    constexpr int X = K / 32 - 1, H = K / 64;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if ((t & H) == 0) {
        const u64 a = __shfl_xor_sync(0xffffffffu, r[t ^ X], 31);
        const u64 b = __shfl_xor_sync(0xffffffffu, r[t], 31);
        r[t] = min(r[t], a);
        r[t ^ X] = max(r[t ^ X], b);
      }
    }
  }
}

template <int N, int J>
__device__ __forceinline__ void stages_down(u64 (&r)[N], int lane, int live) {
  if constexpr (J >= 1) {
    stage_xor<N, J>(r, lane, live);
    stages_down<N, J / 2>(r, lane, live);
  }
}

// block sizes K, 2K, ... up to min(p2, 32 N), whole
template <int N, int K>
__device__ __forceinline__ void tile_sort(u64 (&r)[N], int lane, int live, int p2) {
  if constexpr (K <= 32 * N) {
    if (K <= p2) {
      stage_mirror<N, K>(r, lane, live);
      stages_down<N, K / 4>(r, lane, live);
      tile_sort<N, 2 * K>(r, lane, live, p2);
    }
  }
}

// every warp's tiles of 32 N keys: sorted whole up to block size 32 N, or
// (merge) the strides below 32 N of a larger block
template <int T, int N>
__device__ void tile_pass(u64* keys, int c, int p2, bool merge) {
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 32 * N; base < c; base += T * N) {
    u64 r[N];
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int e = base + t * 32 + lane;
      r[t] = e < c ? keys[e] : kSentinel;
    }
    const int live = c - base;
    if (merge)
      stages_down<N, 16 * N>(r, lane, live);
    else
      tile_sort<N, 2>(r, lane, live, p2);
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int e = base + t * 32 + lane;
      if (e < c) keys[e] = r[t];
    }
  }
}

// one stage in shared memory: pairs (i, i ^ x), i with bit hb clear
template <int T>
__device__ void shared_stage(u64* keys, int c, int p2, int x, int hb) {
  for (int p = threadIdx.x; p < p2 / 2; p += T) {
    const int i = ((p & ~(hb - 1)) << 1) | (p & (hb - 1));
    const int pi = i ^ x;
    if (pi < c) {
      const u64 a = keys[i], b = keys[pi];
      if (a > b) {
        keys[i] = b;
        keys[pi] = a;
      }
    }
  }
  __syncthreads();
}

// ascending order of keys[0..c-1] (written before a barrier): a list of up
// to kTile keys in one warp's registers, a longer one in tiles of kTile
// with the wider strides in shared memory
template <int T>
__device__ void sort_kept(u64* keys, int c) {
  const int p2 = pow2_at_least(c);
  if (p2 <= 32) {
    tile_pass<T, 1>(keys, c, p2, false);
  } else if (p2 <= 64) {
    tile_pass<T, 2>(keys, c, p2, false);
  } else if (p2 <= 128) {
    tile_pass<T, 4>(keys, c, p2, false);
  } else {
    tile_pass<T, kItems>(keys, c, p2, false);
    for (int k = 2 * kTile; k <= p2; k <<= 1) {
      __syncthreads();
      shared_stage<T>(keys, c, p2, k - 1, k >> 1);
      for (int j = k >> 2; j >= kTile; j >>= 1) shared_stage<T>(keys, c, p2, j, j);
      tile_pass<T, kItems>(keys, c, p2, true);
    }
  }
  __syncthreads();
}

// A level: the keep least keys that pass among items 0..n-1 (all of them
// when fewer pass), sorted; returns their count and sets *kept to where
// they lie. region[0..keep) takes the kept list, region[keep..slots) the
// level's stage; a level no wider than keep appends straight into the list.
template <int T, class Item>
__device__ int cull_level(const Item& item, int n, int keep, int bits, u64* region, int slots,
                          Scratch& s, u64** kept) {
  const bool direct = n <= keep;
  u64* stage = direct ? region : region + keep;
  const int cap = direct ? keep : slots - keep;
  const int m = gather<T>(item, n, kSentinel, stage, cap, s);
  if (m <= keep && m <= cap) {
    sort_kept<T>(stage, m);
    *kept = stage;
    return m;
  }
  const auto staged = [stage](int i, u64& key) {
    key = stage[i];
    return true;
  };
  if (m <= keep) {  // more than the stage holds, all kept
    gather<T>(item, n, kSentinel, region, keep, s);
  } else if (m <= cap) {
    gather<T>(staged, m, select_kth<T>(staged, m, keep, bits, s), region, keep, s);
  } else {  // streamed: every pass recomputes the level's tests
    gather<T>(item, n, select_kth<T>(item, n, keep, bits, s), region, keep, s);
  }
  const int k = m < keep ? m : keep;
  sort_kept<T>(region, k);
  *kept = region;
  return k;
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
  const int k0 = cull_level<T>(super_key, A.n_super, A.cs, 31 + sh0, region, A.key_slots, s, &kept);
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
  const int m = cull_level<T>(bin_key, k0 * A.S, A.cb, A.packed ? 31 : 31 + sh1, region,
                              A.key_slots, s, &kept);
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
    if (err != cudaSuccess) return (int)err;
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
