// MICP-L's point-to-plane Gauss-Newton loop over fixed correspondences, one
// launch a correction (no host round trip).
//
// Replaces no Pallas kernel: the JAX package runs this loop as XLA-fused
// code inside one jitted program, rmcl_tpu/micp/pipeline.py::correct_once_jit
// (the loop itself: correct_from_correspondences, :349-548, unsharded with
// solver "p2l_gn"). The port ran it eagerly, some 785 launches and 7 host
// syncs a correction. The function, for every sensor's pairs (the dataset
// point, the model point and the model normal, in the sensor frame, valid
// where mask and found):
//
//   lift the pairs into the odom frame (t_os = tbo @ tsb); the gate of each
//   sensor anneals from the convergence progress read on the device:
//   max_dist (1 - p) + adaptive_min p (or max_dist); the centroid c of the
//   valid pairs' dataset points; T = identity; K times: with d' = T d,
//   r = n . (d' - m), g = valid and |r| <= gate, J = g [n, (d' - c) x n],
//   A = sum w J J^T, b = -sum w J r g over every sensor's pairs (w its
//   weight); A += damping max(trace A, 1) I; solve A x = b by Gaussian
//   elimination with partial pivoting; q = exp(x[3:]), the increment
//   (q, c + x[:3] - q c) composed on the left of T, T's rotation
//   normalised. Then the unweighted gated statistics at T (n_meas and the
//   trace of the cross-covariance of the pairs' d' and their projections
//   d' - r n onto the planes), T = identity under disable_correction,
//   tom_new = normalised tom @ T (the old tom where that is not finite), and
//   the progress exp(-10 |T.t|) T.w^2 min(n_meas / max(valid, 1), 1).
//
// Output: 12 floats, tom_new's rotation (w, x, y, z) and translation, then
// the total and valid measurements, n_meas, the covariance trace and the
// progress (MICPStats holds views of them).
//
// What bounds it on an H100: neither bytes nor operations. The node's
// 14,400 pairs are ~0.55 MB read once and ~8 M float operations over K = 5
// iterations, under a microsecond at the card's bounds; the loop is a chain
// of K + 3 dependent reductions, each followed by a serial step (a 6 x 6
// solve, the centroid, the means), so latency and barriers bound it. The
// design:
//
// * One thread-block cluster of 8 CTAs (kCluster) on neighbouring SMs,
//   each with a contiguous slice of the pairs (1,800 at the node's shape).
//   Every pass lifts its pairs again from device memory: ~0.55 MB, which
//   stays in L2 after the first pass. Keeping the lifted pairs in shared
//   memory instead saved no measurable time a correction (PERF.md), so the
//   kernel has one path for any scan.
// * A pass reduces each thread's partial sums (A's upper triangle, b) by a
//   transposing warp fold (31 shuffles for 32 sums), then across the warps
//   in shared memory. One cluster barrier follows, and every CTA reads the 8
//   CTAs' partials through distributed shared memory in rank order and runs
//   the serial step itself. Every CTA so holds the same T without a second
//   barrier, and every sum is taken in a fixed order, with no atomics: two
//   launches on the same inputs agree bit for bit.
//
// Built with --fmad=false, so each product and sum rounds like the plain
// PyTorch version's (rmcl_tpu_torch/micp/pipeline.py::_correct_torch); the
// sums run in another order, so the two agree to float32 rounding, not
// bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 32;  // the sums of a pass, padded to a warp's lanes
constexpr int kMaxSensors = 32;
constexpr int kOut = 12;

struct V3 {
  float x, y, z;
};
struct Quat {
  float w, x, y, z;
};
struct Pose {
  Quat r;
  V3 t;
};

struct Sensor {
  const float* points;   // (n, 3), sensor frame
  const float* model;    // (n, 3)
  const float* normals;  // (n, 3)
  const uint8_t* mask;   // (n,) bool
  const uint8_t* found;  // (n,) bool
  const float* tsb_rot;  // (4,) w, x, y, z
  const float* tsb_trans;
  int n;
  float max_dist, adaptive_min, weight;
};

struct Params {
  Sensor s[kMaxSensors];
  int n_sensors, n_total, chunk, iterations, adaptive, disable;
  float damping;
  const float *tbo_rot, *tbo_trans, *tom_rot, *tom_trans, *progress;
  float* out;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would return lo)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// Quaternion.rotate: t = 2 qv x v; v + qw t + qv x t
__device__ __forceinline__ V3 rotate(Quat q, V3 v) {
  const V3 qv = {q.x, q.y, q.z};
  const V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q.w)), cross(qv, t));
}

__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Quat normalize(Quat q) {
  const float n = clamp_min(sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), 1e-12f);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// a @ b: b first, then a
__device__ __forceinline__ Pose compose(Pose a, Pose b) {
  return {qmul(a.r, b.r), add(rotate(a.r, b.t), a.t)};
}

__device__ __forceinline__ V3 apply(Pose T, V3 p) { return add(rotate(T.r, p), T.t); }

__device__ __forceinline__ V3 load3(const float* a, int j) {
  return {a[3 * j], a[3 * j + 1], a[3 * j + 2]};
}

__device__ __forceinline__ Pose load_pose(const float* rot, const float* trans) {
  return {{rot[0], rot[1], rot[2], rot[3]}, {trans[0], trans[1], trans[2]}};
}

// Quaternion.exp of a rotation vector
__device__ __forceinline__ Quat qexp(V3 v) {
  const float sum_sq = v.x * v.x + v.y * v.y + v.z * v.z;
  const float angle = sqrtf(clamp_min(sum_sq, 1e-24f));
  const float half = 0.5f * angle;
  const float k = sum_sq < 1e-18f ? 0.5f - sum_sq / 48.0f : sinf(half) / angle;
  return {cosf(half), v.x * k, v.y * k, v.z * k};
}

__device__ __forceinline__ bool pose_is_finite(Pose T) {
  return isfinite(T.r.w) && isfinite(T.r.x) && isfinite(T.r.y) && isfinite(T.r.z) &&
         isfinite(T.t.x) && isfinite(T.t.y) && isfinite(T.t.z);
}

// One fold of the transposing warp reduction: lanes that differ in bit OFF
// swap halves of their first 2 OFF sums, so that after the folds 16 .. 1
// lane l holds the warp's total of sum l.
template <int OFF>
__device__ __forceinline__ void fold(float (&v)[kSums], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Solve M[:, :6] x = M[:, 6] by Gaussian elimination with partial pivoting
// (the first largest pivot), unrolled so that M stays in registers.
__device__ __forceinline__ void solve6(float (&M)[6][7], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(M[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float a = fabsf(M[i][k]);
      if (a > best) {
        best = a;
        piv = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == piv) {
#pragma unroll
        for (int j = k; j < 7; ++j) {
          const float t = M[k][j];
          M[k][j] = M[i][j];
          M[i][j] = t;
        }
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = M[i][k] / M[k][k];
#pragma unroll
      for (int j = k + 1; j < 7; ++j) M[i][j] = M[i][j] - f * M[k][j];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = M[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
}

struct Pair {
  V3 d, m, n;  // odom frame
  int sid;
  float ok;        // mask and found, 0 or 1
  float measured;  // mask, 0 or 1
};

struct Shared {
  float part[2][kSums];  // this CTA's sums of a pass, read by the cluster
  float warp_part[kWarps][kSums];
  float tot[kSums];  // the cluster's sums of the last pass
  Pose tos[kMaxSensors];
  float gate[kMaxSensors], weight[kMaxSensors];
  int off[kMaxSensors + 1];
  Pose T;
  V3 c;
};

// The cluster's totals of v (every thread's sums) into sh.tot, in a fixed
// order: warp folds, warps in order, CTAs in rank order.
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, Shared& sh,
                                            float (&v)[kSums], int pass) {
  const int tid = threadIdx.x, lane = tid & 31;
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  sh.warp_part[tid >> 5][lane] = v[0];
  __syncthreads();
  float* mine = sh.part[pass & 1];
  if (tid < kSums) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh.warp_part[w][tid];
    mine[tid] = s;
  }
  // the partials of pass p + 2 overwrite those of pass p only after every
  // CTA has passed this barrier in pass p + 1, hence after its reads of p
  cluster.sync();
  if (tid < kSums) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(mine, r)[tid];
    sh.tot[tid] = s;
  }
  __syncthreads();
}

// Pair i (global index) lifted from device memory; sid walks up the sensors
// as a thread's i grows.
__device__ __forceinline__ Pair lift(const Params& p, const Shared& sh, int i, int& sid) {
  while (i >= sh.off[sid + 1]) ++sid;
  const Sensor& s = p.s[sid];
  const int j = i - sh.off[sid];
  const Pose tos = sh.tos[sid];
  const bool measured = s.mask[j] != 0;
  return {apply(tos, load3(s.points, j)), apply(tos, load3(s.model, j)),
          rotate(tos.r, load3(s.normals, j)), sid, (measured && s.found[j] != 0) ? 1.0f : 0.0f,
          measured ? 1.0f : 0.0f};
}

__device__ __forceinline__ void zero(float (&v)[kSums]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1)
    p2l_gauss_newton_kernel(const __grid_constant__ Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lo = min((int)cluster.block_rank() * p.chunk, p.n_total);
  const int hi = min(lo + p.chunk, p.n_total);

  if (tid < p.n_sensors) {
    const Sensor& s = p.s[tid];
    const float prog = *p.progress;
    sh.tos[tid] = compose(load_pose(p.tbo_rot, p.tbo_trans), load_pose(s.tsb_rot, s.tsb_trans));
    sh.gate[tid] = p.adaptive ? s.max_dist * (1.0f - prog) + s.adaptive_min * prog : s.max_dist;
    sh.weight[tid] = s.weight;
  }
  if (tid == 0) {
    int acc = 0;
    for (int k = 0; k < p.n_sensors; ++k) {
      sh.off[k] = acc;
      acc += p.s[k].n;
    }
    sh.off[p.n_sensors] = acc;
    sh.T = Pose{{1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  }
  __syncthreads();

  float v[kSums];
  int pass = 0;

  // pass 0: the centroid's sums and the valid count
  zero(v);
  {
    int sid = 0;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const Pair q = lift(p, sh, i, sid);
      v[0] += q.d.x * q.ok;
      v[1] += q.d.y * q.ok;
      v[2] += q.d.z * q.ok;
      v[3] += q.ok;
      v[4] += q.measured;
    }
  }
  cluster_sum(cluster, sh, v, pass++);
  const float valid = sh.tot[4];
  if (tid == 0) {
    const float cnt = clamp_min(sh.tot[3], 1.0f);
    sh.c = {sh.tot[0] / cnt, sh.tot[1] / cnt, sh.tot[2] / cnt};
  }
  __syncthreads();

  for (int it = 0; it < p.iterations; ++it) {
    const Pose T = sh.T;
    const V3 c = sh.c;
    zero(v);
    int sid = 0;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const Pair q = lift(p, sh, i, sid);
      const V3 dp = apply(T, q.d);
      const float r = dot(q.n, sub(dp, q.m));
      const float g = (q.ok != 0.0f && fabsf(r) <= sh.gate[q.sid]) ? 1.0f : 0.0f;
      const V3 jr = cross(sub(dp, c), q.n);
      const float J[6] = {q.n.x * g, q.n.y * g, q.n.z * g, jr.x * g, jr.y * g, jr.z * g};
      const float w = sh.weight[q.sid];
      const float rg = r * g;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) v[k++] += (J[a] * J[b]) * w;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) v[21 + a] += (J[a] * rg) * w;
    }
    cluster_sum(cluster, sh, v, pass++);
    if (tid == 0) {
      float M[6][7];
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) {
          M[a][b] = sh.tot[k];
          M[b][a] = sh.tot[k];
          ++k;
        }
        M[a][6] = -sh.tot[21 + a];
      }
      const float damp = p.damping * clamp_min(
          M[0][0] + M[1][1] + M[2][2] + M[3][3] + M[4][4] + M[5][5], 1.0f);
#pragma unroll
      for (int a = 0; a < 6; ++a) M[a][a] = M[a][a] + damp;
      float x[6];
      solve6(M, x);
      const Quat q = qexp({x[3], x[4], x[5]});
      // the increment about the centroid: Trans(c) (q, t) Trans(-c)
      const Pose delta = {q, sub(add(c, {x[0], x[1], x[2]}), rotate(q, c))};
      Pose Tn = compose(delta, T);
      Tn.r = normalize(Tn.r);
      sh.T = Tn;
    }
    __syncthreads();
  }

  // the unweighted statistics at T: n_meas, the means, then the trace
  const Pose T = sh.T;
  zero(v);
  {
    int sid = 0;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const Pair q = lift(p, sh, i, sid);
      const V3 dp = apply(T, q.d);
      const float r = dot(q.n, sub(dp, q.m));
      const float g = (q.ok != 0.0f && fabsf(r) <= sh.gate[q.sid]) ? 1.0f : 0.0f;
      const V3 proj = sub(dp, scale(q.n, r));
      v[0] += g;
      v[1] += dp.x * g;
      v[2] += dp.y * g;
      v[3] += dp.z * g;
      v[4] += proj.x * g;
      v[5] += proj.y * g;
      v[6] += proj.z * g;
    }
  }
  cluster_sum(cluster, sh, v, pass++);
  const float n_meas = sh.tot[0];
  const float safe_n = clamp_min(n_meas, 1.0f);
  const V3 md = {sh.tot[1] / safe_n, sh.tot[2] / safe_n, sh.tot[3] / safe_n};
  const V3 mp = {sh.tot[4] / safe_n, sh.tot[5] / safe_n, sh.tot[6] / safe_n};
  zero(v);
  {
    int sid = 0;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const Pair q = lift(p, sh, i, sid);
      const V3 dp = apply(T, q.d);
      const float r = dot(q.n, sub(dp, q.m));
      const float g = (q.ok != 0.0f && fabsf(r) <= sh.gate[q.sid]) ? 1.0f : 0.0f;
      const V3 proj = sub(dp, scale(q.n, r));
      v[0] += dot(sub(proj, mp), scale(sub(dp, md), g));
    }
  }
  cluster_sum(cluster, sh, v, pass++);

  if (cluster.block_rank() == 0 && tid == 0) {
    const float cov_trace = n_meas <= 0.0f ? 0.0f : sh.tot[0] / safe_n;
    const Pose Tf = p.disable ? Pose{{1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}} : T;
    const Pose tom = load_pose(p.tom_rot, p.tom_trans);
    Pose tn = compose(tom, Tf);
    tn.r = normalize(tn.r);
    if (!pose_is_finite(tn)) tn = tom;  // the NaN guard keeps the old pose
    const float trans_progress = expf(-10.0f * sqrtf(dot(Tf.t, Tf.t)));
    const float rot_progress = Tf.r.w * Tf.r.w;
    const float ratio = n_meas / clamp_min(valid, 1.0f);
    const float out[kOut] = {tn.r.w, tn.r.x, tn.r.y, tn.r.z, tn.t.x, tn.t.y, tn.t.z,
                             (float)p.n_total, valid, n_meas, cov_trace,
                             trans_progress * rot_progress * (ratio > 1.0f ? 1.0f : ratio)};
#pragma unroll
    for (int k = 0; k < kOut; ++k) p.out[k] = out[k];
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

}  // namespace

// ptrs: n_sensors x 7 device pointers (points, model points, normals, mask,
// found, tsb rotation, tsb translation); counts: n_sensors pairs; cfg:
// n_sensors x 3 (max_dist, adaptive_max_dist_min, weight); poses: tbo
// rotation, tbo translation, tom rotation, tom translation, progress, out.
// Returns a cudaError_t (0: launched).
extern "C" int rmcl_p2l_gauss_newton(const uint64_t* ptrs, const int* counts, const float* cfg,
                                     int n_sensors, const uint64_t* poses, int iterations,
                                     int adaptive, int disable, float damping, int chunk,
                                     void* stream) {
  if (n_sensors < 0 || n_sensors > kMaxSensors || chunk < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  int n_total = 0;
  for (int k = 0; k < n_sensors; ++k) {
    const uint64_t* q = ptrs + 7 * k;
    p.s[k] = {(const float*)q[0], (const float*)q[1], (const float*)q[2],
              (const uint8_t*)q[3], (const uint8_t*)q[4], (const float*)q[5],
              (const float*)q[6], counts[k], cfg[3 * k], cfg[3 * k + 1], cfg[3 * k + 2]};
    n_total += counts[k];
  }
  if ((long long)chunk * kCluster < n_total) return (int)cudaErrorInvalidValue;
  p.n_sensors = n_sensors;
  p.n_total = n_total;
  p.chunk = chunk;
  p.iterations = iterations;
  p.adaptive = adaptive;
  p.disable = disable;
  p.damping = damping;
  p.tbo_rot = (const float*)poses[0];
  p.tbo_trans = (const float*)poses[1];
  p.tom_rot = (const float*)poses[2];
  p.tom_trans = (const float*)poses[3];
  p.progress = (const float*)poses[4];
  p.out = (float*)poses[5];

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, p2l_gauss_newton_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread, and static shared bytes a CTA,
// of the kernel as built (cudaFuncGetAttributes).
extern "C" int rmcl_p2l_gauss_newton_attrs(int* regs, int* local_bytes, int* static_smem) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, p2l_gauss_newton_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  return 0;
}
