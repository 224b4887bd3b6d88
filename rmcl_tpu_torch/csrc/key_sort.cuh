// Selection of the compacted keys of a level in the block cull
// (cull_blocks.cu, K3; K7 selects its own way, cull_boxes.cu). A level's
// passing boxes are appended to a shared key array in any order, each key
// unique (it carries the box's id or position), then sorted ascending, so
// the kept prefix is the plain version's whatever order the warps appended
// in.
#pragma once

#include <cuda_runtime.h>

constexpr unsigned long long kSentinel = ~0ULL;
constexpr int kWarpSortMax = 32;  // key counts that one warp sorts by shuffles

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ascending order of the m compacted keys, padded to a power of two: up to
// kWarpSortMax by one warp's shuffles (no block barrier a step), else by a
// bitonic sort in shared memory
__device__ inline void sort_keys(unsigned long long* keys, int m) {
  const int p2 = pow2_at_least(m);
  if (p2 <= kWarpSortMax) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned long long key = lane < m ? keys[lane] : kSentinel;
      for (int k = 2; k <= 32; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, j);
          key = ((lane & j) == 0) == ((lane & k) == 0) ? min(key, other) : max(key, other);
        }
      }
      keys[lane] = key;
    }
    __syncthreads();
    return;
  }
  for (int i = m + threadIdx.x; i < p2; i += blockDim.x) keys[i] = kSentinel;
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// the passes of the last level, and a fresh count for the next
__device__ inline int take_count(int* s_count) {
  __syncthreads();
  const int m = *s_count;
  __syncthreads();
  if (threadIdx.x == 0) *s_count = 0;
  return m;
}
