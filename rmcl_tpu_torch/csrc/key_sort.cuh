// Selection and sort of a level's keys, shared by the two culls: the block
// cull (cull_blocks.cu, K3) and the closest-point candidate cull
// (cull_boxes.cu, K7). A level's passing boxes each give one unique 64-bit
// key (the bits of a non-negative float distance above the box's id or
// position), and a level keeps the least `keep` of them, in ascending order:
// with unique keys that is the plain versions' list whatever order the
// warps append in.
//
// A level is visited through an `each` functor: each(visit) calls
// visit(pass, key) once for every (lane, item) step of the level's loop,
// with every lane of a warp calling together (visit is warp-collective), so
// a cull may spread an item over one thread (K7, `on_threads`) or over L
// lanes (K3, its cone tests). Its passing keys are compacted by ballot and
// popcount (one shared atomic a warp step) into a stage in shared memory.
// When more pass than the level keeps, an MSB-first radix select finds the
// kept-th least key (8-bit digits over the key's live bits; a shared
// histogram built with warp-aggregated atomics, scanned by one warp; it
// stops as soon as the digit's bucket is taken whole), then the keys at or
// below it are compacted: exactly the kept count, since keys are unique.
// Only those are sorted, by a bitonic network whose comparators all put the
// lesser key at the lower index, so the keys past the count are virtual (no
// padding to a power of two): strides inside a warp's tile of 256 keys run
// in registers (8 a lane, striped) and by shuffles, only wider strides go
// through shared memory with a barrier; a list of up to 32, 64 or 128 keys
// takes a tile of 1, 2 or 4 keys a lane. A level that passes more keys than
// its stage holds is streamed: each radix pass and the compaction call
// `each` again, recomputing the level's tests, so shared memory scales with
// the kept counts, not with the levels' widths. The functions that call
// `each` are inlined, so a level's loop and its functor compile as one.
#pragma once

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr u64 kSentinel = ~0ULL;
constexpr int kItems = 8;           // keys a lane holds in a full sort tile
constexpr int kTile = kItems * 32;  // keys a warp sorts in registers

struct Scratch {
  int count;            // keys appended by the current pass
  int digit, bucket;    // the radix select's step: its digit and that bucket's count,
  int rank;             // and the rank left inside the bucket
  unsigned hist[256];   // the radix select's digit histogram
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ int bit_width(int n) { return n > 0 ? 32 - __clz(n) : 0; }

// items 0..n-1 one a thread, T threads a CTA: src(i, key) sets item i's key
// and returns whether it passes
template <int T, class Src>
__device__ __forceinline__ auto on_threads(int n, const Src& src) {
  return [n, src](auto&& visit) {
    for (int base = 0; base < n; base += T) {
      const int i = base + threadIdx.x;
      u64 key = 0;
      const bool pass = i < n && src(i, key);
      visit(pass, key);
    }
  };
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

// the passing keys <= thr appended to keys[] (at most cap stored); returns
// how many passed
template <int T, class Each>
__device__ __forceinline__ int gather(const Each& each, u64 thr, u64* keys, int cap, Scratch& s) {
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  each([&](bool pass, u64 key) { append(pass && key <= thr, key, keys, cap, &s.count); });
  __syncthreads();
  const int m = s.count;
  __syncthreads();
  return m;
}

// the rank-th least (1-based) of the passing keys, each below 2^bits and
// unique, by an MSB-first radix select; returns the threshold t with
// exactly rank passing keys <= t
template <int T, class Each>
__device__ __forceinline__ u64 select_kth(const Each& each, int rank, int bits, Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  u64 prefix = 0, mask = 0;
  int left = bits;
  for (;;) {
    const int shift = left > 8 ? left - 8 : 0;
    const unsigned dmask = (1u << (left - shift)) - 1u;
    for (int b = tid; b < 256; b += T) s.hist[b] = 0;
    __syncthreads();
    each([&](bool pass, u64 key) {
      const bool in = pass && (key & mask) == prefix;
      const int digit = in ? (int)((key >> shift) & dmask) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], (unsigned)__popc(peers));
    });
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

// the whole network in shared memory, every stage over all the CTA's
// threads, one barrier a stage
template <int T>
__device__ void shared_sort(u64* keys, int c, int p2) {
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    shared_stage<T>(keys, c, p2, k - 1, k >> 1);
    for (int j = k >> 2; j >= 1; j >>= 1) shared_stage<T>(keys, c, p2, j, j);
  }
}

// ascending order of keys[0..c-1] (written before a barrier): a list of up
// to 32 N keys in one warp's registers, N keys a lane (N up to MaxN), a
// longer one in tiles of 32 MaxN with the wider strides in shared memory;
// with Spread > 0, lists of 33 to Spread keys by shared_sort instead, so
// that every warp of the CTA works on them
template <int T, int MaxN = kItems, int Spread = 0>
__device__ void sort_kept(u64* keys, int c) {
  constexpr int kTileKeys = 32 * MaxN;
  const int p2 = pow2_at_least(c);
  if (p2 > 32 && p2 <= Spread) {
    shared_sort<T>(keys, c, p2);
  } else if (p2 <= 32) {
    tile_pass<T, 1>(keys, c, p2, false);
  } else if (MaxN >= 2 && p2 <= 64) {
    tile_pass<T, (MaxN >= 2 ? 2 : 1)>(keys, c, p2, false);
  } else if (MaxN >= 4 && p2 <= 128) {
    tile_pass<T, (MaxN >= 4 ? 4 : 1)>(keys, c, p2, false);
  } else {
    tile_pass<T, MaxN>(keys, c, p2, false);
    for (int k = 2 * kTileKeys; k <= p2; k <<= 1) {
      __syncthreads();
      shared_stage<T>(keys, c, p2, k - 1, k >> 1);
      for (int j = k >> 2; j >= kTileKeys; j >>= 1) shared_stage<T>(keys, c, p2, j, j);
      tile_pass<T, MaxN>(keys, c, p2, true);
    }
  }
  __syncthreads();
}

// A level of n items: the keep least keys that pass (all of them when fewer
// pass), sorted; returns how many passed and sets *kept to where the
// min(passed, keep) kept keys lie. region[0..keep) takes the kept list,
// region[keep..slots) the level's stage; a level no wider than keep
// appends straight into the list. `again` visits the level as `each` does,
// for the passes of a level wider than its stage (a cull may make it hold
// fewer registers: those passes are rare). Without kStream the caller
// vouches that every level fits its stage, and the streamed passes are not
// built (a build without them holds fewer registers).
template <int T, int MaxN = kItems, int Spread = 0, bool kStream = true, class Each,
          class Again>
__device__ __forceinline__ int cull_level(const Each& each, const Again& again, int n, int keep,
                                          int bits, u64* region, int slots, Scratch& s,
                                          u64** kept) {
  const bool direct = n <= keep;
  u64* stage = direct ? region : region + keep;
  const int cap = direct ? keep : slots - keep;
  const int m = gather<T>(each, kSentinel, stage, cap, s);
  if (m <= keep && m <= cap) {
    sort_kept<T, MaxN, Spread>(stage, m);
    *kept = stage;
    return m;
  }
  const auto staged = on_threads<T>(m, [stage](int i, u64& key) {
    key = stage[i];
    return true;
  });
  if constexpr (!kStream) {
    gather<T>(staged, select_kth<T>(staged, keep, bits, s), region, keep, s);
  } else if (m <= keep) {  // more than the stage holds, all kept
    gather<T>(again, kSentinel, region, keep, s);
  } else if (m <= cap) {
    gather<T>(staged, select_kth<T>(staged, keep, bits, s), region, keep, s);
  } else {  // streamed: every pass recomputes the level's tests
    gather<T>(again, select_kth<T>(again, keep, bits, s), region, keep, s);
  }
  sort_kept<T, MaxN, Spread>(region, m < keep ? m : keep);
  *kept = region;
  return m;
}

}  // namespace
