// Closest point on a triangle: Ericson, Real-Time Collision Detection
// §5.1.5, with the Voronoi regions resolved by selects. Shared by the
// closest-point kernels (closest_bvh.cu, closest_bins.cu); the operation
// order is that of rmcl_tpu/ops/closest_point.py::_ericson_vw_planes and of
// the plain PyTorch version (rmcl_tpu_torch/ops/closest_point.py::
// ericson_vw_planes), term for term.
#pragma once

__device__ __forceinline__ float ericson_safe_div(float a, float b) {
  return a / (fabsf(b) > 1e-30f ? b : 1e-30f);
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Barycentric (v, w) of the closest point a + v * ab + w * ac to q.
__device__ __forceinline__ void ericson_vw(float qx, float qy, float qz, float ax, float ay,
                                           float az, float abx, float aby, float abz, float acx,
                                           float acy, float acz, float& v, float& w) {
  const float apx = qx - ax, apy = qy - ay, apz = qz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float bpx = apx - abx, bpy = apy - aby, bpz = apz - abz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float cpx = apx - acx, cpy = apy - acy, cpz = apz - acz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;

  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom_face = fmaxf(va + vb + vc, 1e-30f);
  const float v_face = vb / denom_face;
  const float w_face = vc / denom_face;

  const float v_ab = clip01(ericson_safe_div(d1, d1 - d3));
  const float w_ac = clip01(ericson_safe_div(d2, d2 - d6));
  const float t_bc = clip01(ericson_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)));

  const bool in_a = d1 <= 0.0f && d2 <= 0.0f;
  const bool in_b = d3 >= 0.0f && d4 <= d3;
  const bool in_c = d6 >= 0.0f && d5 <= d6;
  const bool no_vert = !in_a && !in_b && !in_c;
  const bool in_ab = no_vert && vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f;
  const bool in_ac = no_vert && vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f;
  const bool in_bc = no_vert && va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f;

  v = (in_a || in_c) ? 0.0f : (in_b ? 1.0f : v_face);
  w = (in_a || in_b) ? 0.0f : (in_c ? 1.0f : w_face);
  if (in_ab) { v = v_ab; w = 0.0f; }
  if (in_ac) { v = 0.0f; w = w_ac; }
  if (in_bc) { v = 1.0f - t_bc; w = t_bc; }
}
