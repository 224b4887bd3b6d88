// The batch corrector's epilogue: from K4's winning hits to each pose's
// Umeyama increment, one launch a correction (no host round trip).
//
// Replaces no Pallas kernel: the JAX package runs these steps as XLA ops of
// its batch correction (the JAX bench's `correction`: the factored cast's
// plane payload, the un-permutation, the point-to-plane pairs, the
// statistics and one Umeyama solve a pose), and the port ran them as some
// 200 torch launches and two host syncs (the batched SVD and determinant) a
// correction: rmcl_tpu_torch/micp/batch.py::BatchCorrector._correct_torch,
// this kernel's plain version. The function, for pose p (position t_p) and
// each direction i of the shared scan (dirs, the map's axes):
//
//   s = slots[p, i], the pair's slot in the sweep's permuted order; the ray
//   hit where K4's packed t_best[s] < t_max (and < 3e38); its winner row
//   ref[s] = bin * B + lane indexes the map's plane table (ng = e1 x e2,
//   c0 = ng . v0 a triangle row, float32 by the pair loop's formulas:
//   ops/epilogue_cuda.py::winner_planes); t = (c0 - ng . t_p) / (ng . d),
//   the hit point t_p + t d and the unit normal turned towards the ray;
//   the measured point m = data[p, i] + t_p, its signed distance r = n .
//   (m - hit point) and the gate mask & hit & |r| <= max_dist; the model
//   point m - r n. Then, over each pose's gated
//   pairs, n, both means and the cross-covariance C = E[(model - mean)
//   (dataset - mean)^T] (math/gaussian.py::CrossStatistics), and the
//   rotation maximising tr(R C^T) (math/stats.py::umeyama_transform: Kabsch
//   with the determinant fix; here the same rotation as the top eigenvector
//   of Horn's 4 x 4 matrix), t = model mean - R dataset mean, the identity
//   where n = 0.
//
// Output: (N, 8) float32 a pose: the increment's rotation (w, x, y, z, w >=
// 0) and translation, then n.
//
// What bounds it on an H100: bytes. A pair reads its slot (4 B), K4's t and
// row (8 B), its measured point and mask (13 B) and its winner's plane
// (16 B): at the sweep's 1,000 poses x 14,400 rays some 0.36 GB of inputs
// once, ~0.11 ms at 3.35 TB/s, against ~55 float and ~37 double operations
// a pair. The design:
//
// * One CTA a pose (CTA b, pose b), so that its sums never leave the CTA:
//   no second pass, no atomics.
// * The winner's plane is one 16-byte load from a table of the map's rows
//   (16 MB at ~1M faces, mostly in L2: neighbouring rays hit neighbouring
//   triangles), not nine floats of bins.tri, each in a sector of its own:
//   0.54 ms against 0.35 ms at the sweep's size (PERF.md section 6); the
//   launch bound of four CTAs a SM (64 registers) brings it lower still.
// * A thread walks directions tid, tid + 256, ... of its pose (coalesced
//   reads of the slot map, the points and the mask), two at a time, each
//   pair's loads issued before its gate is known (a chain of three: slot,
//   then t and row index, then the plane).
// * Every per-pair quantity is float32, in the operation order of the plain
//   version (built with --fmad=false, so each product and sum rounds as
//   PyTorch's do); the sums are float64 of the pair's points relative to the
//   pose's position (sensor-range magnitudes), taken in a fixed order: a
//   thread's pairs in turn, a warp's butterfly, the warps in order. Two
//   launches on the same inputs agree bit for bit. The 3 x 3 solve runs in
//   float64 on one thread a CTA (cyclic Jacobi on Horn's matrix), in
//   registers: the launch bound of four CTAs a SM spills nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // CTAs a SM: 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 16;  // n, the dataset's sum (3), the model's (3), sum model dataset^T (9)
constexpr int kOut = 8;
constexpr float kBig = 3.0e38f;  // cull_cuda._BIG: no hit at or past it
constexpr int kMaxSweeps = 30;

struct Params {
  const float* __restrict__ t_best;  // K4's packed t, sweep-flat
  const int* __restrict__ ref;       // K4's winner rows, sweep-flat
  const float4* __restrict__ planes; // (n_bins * B,) (ng, c0) a row
  const float* __restrict__ trans;   // (N, 3)
  const float* __restrict__ dirs;    // (D, 3)
  const float* __restrict__ data;    // (N, D, 3), sensor frame
  const uint8_t* __restrict__ mask;  // (N, D) bool
  const int* __restrict__ slots;     // (N, D)
  float* __restrict__ out;           // (N, kOut)
  int n_dirs;
  float max_dist, t_max;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// One gated pair's terms, added to v; the hit and gate of the plain version
// (ops/raycast_binned.py's plane payload, BatchCorrector.cast and
// _correct_torch), in its operation order. Every load is issued whatever
// the pair's fate (a miss reads row 0), so that none waits on a branch: the
// chain is the slot, then t and the row index, then the plane.
__device__ __forceinline__ void add_pair(const Params& p, size_t k, int i, float tx, float ty,
                                         float tz, double (&v)[kSums]) {
  const bool measured = __ldg(p.mask + k) != 0;
  const float dmx = __ldg(p.data + 3 * k), dmy = __ldg(p.data + 3 * k + 1),
              dmz = __ldg(p.data + 3 * k + 2);
  const float dx = __ldg(p.dirs + 3 * i), dy = __ldg(p.dirs + 3 * i + 1),
              dz = __ldg(p.dirs + 3 * i + 2);
  const int s = __ldg(p.slots + k);
  const float t = __ldg(p.t_best + s);
  const float4 plane = __ldg(p.planes + max(__ldg(p.ref + s), 0));
  const float ngx = plane.x, ngy = plane.y, ngz = plane.z, c0 = plane.w;
  const float denom = ngx * dx + ngy * dy + ngz * dz;
  const float safe_denom = fabsf(denom) > 1e-30f ? denom : 1e-30f;
  const float t_plane = (c0 - (ngx * tx + ngy * ty + ngz * tz)) / safe_denom;
  const float inv_len = 1.0f / sqrtf(clamp_min(ngx * ngx + ngy * ngy + ngz * ngz, 1e-30f));
  const float flip = denom > 0.0f ? -1.0f : 1.0f;
  const float nx = ngx * inv_len * flip, ny = ngy * inv_len * flip, nz = ngz * inv_len * flip;
  // the hit point from t along the direction, and the measured point, in the map
  const float px = tx + t_plane * dx, py = ty + t_plane * dy, pz = tz + t_plane * dz;
  const float mx = dmx + tx, my = dmy + ty, mz = dmz + tz;
  const float signed_d = nx * (mx - px) + ny * (my - py) + nz * (mz - pz);
  const bool hit = t < p.t_max && t < kBig;
  if (!(measured && hit && fabsf(signed_d) <= p.max_dist)) return;
  const float qx = mx - signed_d * nx, qy = my - signed_d * ny, qz = mz - signed_d * nz;
  // relative to the pose's position: float32 differences are exact in float64
  const double a[3] = {(double)mx - tx, (double)my - ty, (double)mz - tz};
  const double b[3] = {(double)qx - tx, (double)qy - ty, (double)qz - tz};
  v[0] += 1.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[1 + j] += a[j];
    v[4 + j] += b[j];
  }
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v[7 + 3 * ii + j] += b[ii] * a[j];
  }
}

// The unit eigenvector of symmetric A's largest eigenvalue (the first of
// equal ones), by cyclic Jacobi rotations; A is overwritten. Every loop
// over the matrix is unrolled, so that A and V stay in registers.
__device__ void top_eigenvector(double (&A)[4][4], double (&q)[4]) {
  double V[4][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}};
  double scale = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) scale += A[r][c] * A[r][c];
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = r + 1; c < 4; ++c) off += A[r][c] * A[r][c];
    }
    if (!(off > 1e-36 * scale)) break;
#pragma unroll
    for (int pi = 0; pi < 3; ++pi) {
#pragma unroll
      for (int qi = pi + 1; qi < 4; ++qi) {
        const double apq = A[pi][qi];
        if (apq != 0.0) {
          const double theta = (A[qi][qi] - A[pi][pi]) / (2.0 * apq);
          const double at = fabs(theta);
          double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(theta * theta + 1.0));
          if (theta < 0.0) t = -t;
          const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
          A[pi][pi] -= t * apq;
          A[qi][qi] += t * apq;
          A[pi][qi] = A[qi][pi] = 0.0;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r != pi && r != qi) {
              const double arp = A[r][pi], arq = A[r][qi];
              A[r][pi] = A[pi][r] = c * arp - s * arq;
              A[r][qi] = A[qi][r] = s * arp + c * arq;
            }
            const double vrp = V[r][pi], vrq = V[r][qi];
            V[r][pi] = c * vrp - s * vrq;
            V[r][qi] = s * vrp + c * vrq;
          }
        }
      }
    }
  }
  double top = A[0][0];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = V[r][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (A[k][k] > top) {
      top = A[k][k];
#pragma unroll
      for (int r = 0; r < 4; ++r) q[r] = V[r][k];
    }
  }
  const double norm = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] /= norm;
}

// Pose p's increment from its sums (the layout of add_pair's v), into out.
__device__ void solve_pose(const double (&sum)[kSums], const float (&tp)[3], float* out) {
  const double n = sum[0];
  if (!(n > 0.0)) {
    out[0] = 1.0f;
#pragma unroll
    for (int k = 1; k < kOut; ++k) out[k] = 0.0f;
    return;
  }
  double ma[3], mb[3], C[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ma[j] = sum[1 + j] / n;
    mb[j] = sum[4 + j] / n;
  }
  // C[i][j] = E[(model_i - mean)(dataset_j - mean)]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = sum[7 + 3 * i + j] / n - mb[i] * ma[j];
  }
  // Horn's matrix of S = C^T (S[a][b] = E[dataset_a model_b], centred): its
  // top eigenvector is the unit quaternion maximising sum model . R dataset
  const double sxx = C[0][0], sxy = C[1][0], sxz = C[2][0];
  const double syx = C[0][1], syy = C[1][1], syz = C[2][1];
  const double szx = C[0][2], szy = C[1][2], szz = C[2][2];
  double N[4][4] = {{sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
                    {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
                    {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
                    {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  double q[4];
  top_eigenvector(N, q);
  const double sign = q[0] < 0.0 ? -1.0 : 1.0;
  const double w = sign * q[0], x = sign * q[1], y = sign * q[2], z = sign * q[3];
  const double R[3][3] = {{1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
                          {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
                          {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}};
  // t = model mean - R dataset mean, both means the pose's position plus the
  // relative ones: (tp - R tp) + (mb - R ma)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    double rt = 0.0, ra = 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rt += R[i][j] * tp[j];
      ra += R[i][j] * ma[j];
    }
    out[4 + i] = (float)(((double)tp[i] - rt) + (mb[i] - ra));
  }
  out[0] = (float)w;
  out[1] = (float)x;
  out[2] = (float)y;
  out[3] = (float)z;
  out[7] = (float)n;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    batch_epilogue_kernel(const __grid_constant__ Params p) {
  __shared__ double warp_part[kWarps][kSums];
  __shared__ double total[kSums];
  const int pose = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const float tp[3] = {p.trans[3 * pose], p.trans[3 * pose + 1], p.trans[3 * pose + 2]};
  double v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0;
  const size_t first = (size_t)pose * p.n_dirs;
  // two pairs' loads in flight a thread; the sums still in the pairs' order
#pragma unroll 2
  for (int i = tid; i < p.n_dirs; i += kThreads) add_pair(p, first + i, i, tp[0], tp[1], tp[2], v);

  // a fixed order: the warp's butterfly, then the warps in turn
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_part[tid >> 5][k] = v[k];
  }
  __syncthreads();
  if (tid < kSums) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][tid];
    total[tid] = s;
  }
  __syncthreads();
  if (tid == 0) solve_pose(total, tp, p.out + (size_t)pose * kOut);
}

}  // namespace

// ptrs: t_best, ref, planes, trans, dirs, data, mask, slots, out
// (device pointers; planes 16-byte aligned). One CTA a pose. Returns a
// cudaError_t (0: launched).
extern "C" int rmcl_batch_epilogue(const uint64_t* ptrs, int n_poses, int n_dirs,
                                   float max_dist, float t_max, void* stream) {
  if (n_poses < 0 || n_dirs < 0 || ptrs[2] % 16) return (int)cudaErrorInvalidValue;
  if (n_poses == 0) return 0;
  Params p = {};
  p.t_best = (const float*)ptrs[0];
  p.ref = (const int*)ptrs[1];
  p.planes = (const float4*)ptrs[2];
  p.trans = (const float*)ptrs[3];
  p.dirs = (const float*)ptrs[4];
  p.data = (const float*)ptrs[5];
  p.mask = (const uint8_t*)ptrs[6];
  p.slots = (const int*)ptrs[7];
  p.out = (float*)ptrs[8];
  p.n_dirs = n_dirs;
  p.max_dist = max_dist;
  p.t_max = t_max;
  batch_epilogue_kernel<<<n_poses, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes a thread, and static shared bytes a CTA,
// of the kernel as built (cudaFuncGetAttributes).
extern "C" int rmcl_batch_epilogue_attrs(int* regs, int* local_bytes, int* static_smem) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, batch_epilogue_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  return 0;
}
