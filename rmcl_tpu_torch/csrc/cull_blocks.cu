// Block cull for the binned ray casters: per ray block, the nearest-first
// candidate bins.
//
// Replaces the cull that the JAX package runs as XLA device code inside its
// casts, rmcl_tpu/ops/raycast_binned.py: the box tests and selections of
// _chunk_level0 (both its level 0 over all supers and its c_hyper branch),
// _group_box_tests, _chunk_cull_tests, _chunk_select and _chunk_candidates.
// The per-sub-block cone bounds come in precomputed (shared PyTorch code);
// this kernel does, per block:
//
//   level 0: either the R sub-block cones x every super (a super passes if
//            any cone passes; its entry distance is the least over passing
//            cones), keeping the cs nearest by the key (bits(tn), index);
//            or, with the hyper level, the fat block cone x every hyper,
//            the ch nearest by the packed key (bits(tn) & ~idm) | id, then
//            the fat cone x those hypers' supers, the cs nearest;
//   level 1: the R cones x the S bins of each kept super, the cb nearest
//            by the packed key; tnear = the key's truncated tn / n_hi;
//   sat:     whether any level had more passing boxes than its budget.
//
// The cone-box test is the plain version's (_cone_box_test in
// rmcl_tpu_torch/ops/cull_cuda.py) operation for operation, built with
// --fmad=false, so both round alike and pick the same lists.
//
// What bounds it on an H100: the cone-box tests, ~89 float instructions
// each (two slab passes, two norms), R x cs x S per block at level 1 (the
// pose sweep: 128 cones x 384 bins); a block reads only ~100 bytes of cone
// bounds and a few KB of boxes (L2-resident), so it is bound by float32
// instruction throughput. The design is simple:
//   * one CTA of 256 threads per block; the block's cones are precomputed
//     once (1/axis, sqrt(1 - axis^2), t_hi * tan) into shared memory;
//   * threads run over boxes, each looping over the R cones, so the OR and
//     the min of tn over cones need no atomics;
//   * each level's keys are 64-bit (a packed 32-bit key, or tn's bits above
//     the index) in shared memory, and a bitonic sort in shared memory puts
//     the k nearest first; one shared counter per level counts the passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned long long kSentinel = ~0ULL;
constexpr int kConeIn = 11;  // oc(3) oh(3) axis(3) tan_th t_hi
constexpr int kCone = 16;    // oc(3) oh(3) inv(3) s_perp(3) tan_th t_hi r0 (pad)
constexpr int kThreads = 256;

__device__ void load_cone(const float* in, float* c) {
  for (int k = 0; k < 3; ++k) {
    const float a = in[6 + k];
    const float a_safe = fabsf(a) < 1e-30f ? 1e-30f : a;
    c[k] = in[k];
    c[3 + k] = in[3 + k];
    c[6 + k] = 1.0f / a_safe;
    c[9 + k] = sqrtf(fmaxf(1.0f - a * a, 0.0f));
  }
  c[12] = in[9];
  c[13] = in[10];
  c[14] = in[10] * in[9];
}

// max over axes of min(t0, t1) and min over axes of max(t0, t1)
__device__ __forceinline__ void slab(const float* c, const float* b0, const float* b1, float r,
                                     float& tn, float& tf) {
  float mn[3], mx[3];
  for (int k = 0; k < 3; ++k) {
    const float rk = r * c[9 + k];
    const float t0 = (b0[k] - rk) * c[6 + k];
    const float t1 = (b1[k] + rk) * c[6 + k];
    mn[k] = fminf(t0, t1);
    mx[k] = fmaxf(t0, t1);
  }
  tn = fmaxf(fmaxf(mn[0], mn[1]), mn[2]);
  tf = fminf(fminf(mx[0], mx[1]), mx[2]);
}

__device__ bool cone_box(const float* c, const float* bmin, const float* bmax, float* tn_out) {
  float b0[3], b1[3], g[3], s[3];
  for (int k = 0; k < 3; ++k) {
    b0[k] = (bmin[k] - c[3 + k]) - c[k];
    b1[k] = (bmax[k] + c[3 + k]) - c[k];
    g[k] = fmaxf(fmaxf(b0[k], -b1[k]), 0.0f);
    s[k] = fmaxf(b1[k], -b0[k]);
  }
  const float d_near = sqrtf((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]);
  const float d_far = sqrtf((s[0] * s[0] + s[1] * s[1]) + s[2] * s[2]);
  const float tan_th = c[12], t_hi = c[13];
  float tn, tf;
  slab(c, b0, b1, c[14], tn, tf);
  const float r1 = fminf(fmaxf(tf, 0.0f), t_hi) * tan_th;
  slab(c, b0, b1, r1, tn, tf);
  tn = fmaxf(tn, d_near);
  tf = fminf(tf, d_far);
  *tn_out = tn > 0.0f ? tn : 0.0f;
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_hi) && (d_near <= t_hi);
}

// Fill the keys of one level: slot i < n tests box id(i) against n_cones
// cones; slots past n and boxes that fail (or lie past n_ids) get the
// sentinel. With group_sel, slot i is member i % G of group group_sel[i / G]
// (-1: no group); else slot i is box i.
__device__ void fill_level(unsigned long long* keys, int n, int p2, const float* cones,
                           int n_cones, const float* boxes, const int* group_sel, int G,
                           int n_ids, int packed, unsigned idm, int* n_valid) {
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    unsigned long long key = kSentinel;
    if (i < n) {
      int id = i;
      bool in_range = true;
      if (group_sel) {
        const int grp = group_sel[i / G];
        id = grp * G + i % G;
        in_range = grp >= 0 && id < n_ids;
      }
      if (in_range) {
        const float* b = boxes + (size_t)id * 6;
        const float bmin[3] = {b[0], b[1], b[2]};
        const float bmax[3] = {b[3], b[4], b[5]};
        bool any = false;
        float tn_min = kBig;
        for (int r = 0; r < n_cones; ++r) {
          float tn;
          if (cone_box(cones + r * kCone, bmin, bmax, &tn)) {
            any = true;
            tn_min = fminf(tn_min, tn);
          }
        }
        if (any) {
          const unsigned tb = __float_as_uint(tn_min);
          key = packed ? (unsigned long long)((tb & ~idm) | (unsigned)id)
                       : (((unsigned long long)tb << 32) | (unsigned)i);
          atomicAdd(n_valid, 1);
        }
      }
    }
    keys[i] = key;
  }
}

__device__ void bitonic_sort(unsigned long long* keys, int p2) {
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

// id and tn of a sorted key (id -1 and tn 3e38 for the sentinel)
__device__ void decode(unsigned long long key, int packed, unsigned idm, const int* group_sel,
                       int G, int* id, float* tn) {
  if (key == kSentinel) {
    *id = -1;
    *tn = kBig;
  } else if (packed) {
    const unsigned k32 = (unsigned)key;
    *id = (int)(k32 & idm);
    *tn = __uint_as_float(k32 & ~idm);
  } else {
    const int pos = (int)(key & 0xffffffffu);
    *id = group_sel ? group_sel[pos / G] * G + pos % G : pos;
    *tn = __uint_as_float((unsigned)(key >> 32));
  }
}

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__global__ void cull_blocks_kernel(
    const float* __restrict__ cones, const float* __restrict__ fat,
    const float* __restrict__ n_hi, const float* __restrict__ bin_aabb,
    const float* __restrict__ super_aabb, const float* __restrict__ hyper_aabb,
    int* __restrict__ cand_bin, int* __restrict__ cand_count, float* __restrict__ cand_tnear,
    unsigned char* __restrict__ sat_out,
    int R, int n_bins, int n_super, int n_hyper, int S, int H, int ch, int cs, int cb,
    unsigned idm_hyp, unsigned idm_sup, unsigned idm_bin, int hyp_packed, int sup_packed,
    int bin_packed, int p2_max) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_keys = smem;                 // p2_max
  float* s_cones = (float*)(smem + p2_max);          // R * kCone
  float* s_fat = s_cones + R * kCone;                // kCone
  int* s_hyp = (int*)(s_fat + kCone);                // max(ch, 1)
  int* s_sup = s_hyp + (ch > 0 ? ch : 1);            // cs
  __shared__ int s_valid;
  __shared__ int s_sat;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += blockDim.x)
    load_cone(cones + ((size_t)blk * R + i) * kConeIn, s_cones + i * kCone);
  if (tid == 0) {
    if (ch > 0) load_cone(fat + (size_t)blk * kConeIn, s_fat);
    s_sat = 0;
    s_valid = 0;
  }
  __syncthreads();

  // level 0 -> s_sup
  int n, p2;
  if (ch > 0) {
    n = n_hyper;
    p2 = pow2_at_least(n);
    fill_level(s_keys, n, p2, s_fat, 1, hyper_aabb, nullptr, 1, n, hyp_packed, idm_hyp,
               &s_valid);
    bitonic_sort(s_keys, p2);
    for (int k = tid; k < ch; k += blockDim.x) {
      float tn;
      decode(s_keys[k], hyp_packed, idm_hyp, nullptr, 1, s_hyp + k, &tn);
    }
    if (tid == 0) {
      s_sat |= s_valid > ch;
      s_valid = 0;
    }
    __syncthreads();
    n = ch * H;
    p2 = pow2_at_least(n);
    fill_level(s_keys, n, p2, s_fat, 1, super_aabb, s_hyp, H, n_super, sup_packed, idm_sup,
               &s_valid);
    bitonic_sort(s_keys, p2);
    for (int k = tid; k < cs; k += blockDim.x) {
      float tn;
      decode(k < p2 ? s_keys[k] : kSentinel, sup_packed, idm_sup, s_hyp, H, s_sup + k, &tn);
    }
  } else {
    n = n_super;
    p2 = pow2_at_least(n);
    fill_level(s_keys, n, p2, s_cones, R, super_aabb, nullptr, 1, n, 0, 0u, &s_valid);
    bitonic_sort(s_keys, p2);
    for (int k = tid; k < cs; k += blockDim.x) {
      float tn;
      decode(s_keys[k], 0, 0u, nullptr, 1, s_sup + k, &tn);
    }
  }
  if (tid == 0) {
    s_sat |= s_valid > cs;
    s_valid = 0;
  }
  __syncthreads();

  // level 1: the kept supers' bins
  n = cs * S;
  p2 = pow2_at_least(n);
  fill_level(s_keys, n, p2, s_cones, R, bin_aabb, s_sup, S, n_bins, bin_packed, idm_bin,
             &s_valid);
  bitonic_sort(s_keys, p2);
  const float scale = n_hi[blk];
  for (int k = tid; k < cb; k += blockDim.x) {
    int id;
    float tn;
    decode(s_keys[k], bin_packed, idm_bin, s_sup, S, &id, &tn);
    cand_bin[(size_t)blk * cb + k] = id;
    cand_tnear[(size_t)blk * cb + k] = id >= 0 ? tn / scale : kBig;
  }
  if (tid == 0) {
    cand_count[blk] = min(s_valid, cb);
    sat_out[blk] = (unsigned char)(s_sat | (s_valid > cb));
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. sup_bin_packed: bit 0 the super level's packed
// flag (hyper path), bit 1 the bin level's.
extern "C" int rmcl_cull_blocks(
    const float* cones, const float* fat, const float* n_hi, const float* bin_aabb,
    const float* super_aabb, const float* hyper_aabb, int* cand_bin, int* cand_count,
    float* cand_tnear, unsigned char* sat,
    int Cb, int R, int n_bins, int n_super, int n_hyper, int S, int H, int ch, int cs, int cb,
    int idm_hyp, int idm_sup, int idm_bin, int hyp_packed, int sup_bin_packed, void* stream) {
  if (Cb == 0) return 0;
  int p2_max = pow2_at_least(cs * S);
  if (ch > 0) {
    p2_max = std::max(p2_max, std::max(pow2_at_least(n_hyper), pow2_at_least(ch * H)));
  } else {
    p2_max = std::max(p2_max, pow2_at_least(n_super));
  }
  const size_t smem = (size_t)p2_max * sizeof(unsigned long long) +
                      (size_t)(R + 1) * kCone * sizeof(float) +
                      (size_t)((ch > 0 ? ch : 1) + cs) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cull_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cull_blocks_kernel<<<Cb, kThreads, smem, (cudaStream_t)stream>>>(
      cones, fat, n_hi, bin_aabb, super_aabb, hyper_aabb, cand_bin, cand_count, cand_tnear, sat,
      R, n_bins, n_super, n_hyper, S, H, ch, cs, cb, (unsigned)idm_hyp, (unsigned)idm_sup,
      (unsigned)idm_bin, hyp_packed, sup_bin_packed & 1, (sup_bin_packed >> 1) & 1, p2_max);
  return (int)cudaGetLastError();
}
