// Closest point on a triangle: Ericson, Real-Time Collision Detection
// §5.1.5. Shared by the closest-point kernels (closest_bvh.cu,
// closest_bins.cu); the operation order is that of
// rmcl_tpu/ops/closest_point.py::_ericson_vw_planes and of the plain PyTorch
// version (rmcl_tpu_torch/ops/closest_cuda.py::ericson_vw_planes), term for
// term.
//
// The plain version forms all five quotients (the face's two, the three
// edges' one each) and keeps at most two of them by selects. The region
// flags depend only on d1..d6 and va, vb, vc, never on a quotient, so here
// the region is resolved first and only its own quotients are formed: two
// divisions in the face, one on an edge, none at a vertex. Each kept
// quotient is the same IEEE division of the same operands with the same
// guards, and the branches keep the selects' precedence (bc over ac over ab
// over the vertex and face values; several flags can hold at once on a
// degenerate triangle), so v and w are the plain version's bits.
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

  const bool in_a = d1 <= 0.0f && d2 <= 0.0f;
  const bool in_b = d3 >= 0.0f && d4 <= d3;
  const bool in_c = d6 >= 0.0f && d5 <= d6;
  if (in_a || in_b || in_c) {  // a vertex: the edge and face values are never selected
    v = (in_a || in_c) ? 0.0f : 1.0f;
    w = (in_a || in_b) ? 0.0f : 1.0f;
  } else if (va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f) {  // edge bc
    const float t_bc = clip01(ericson_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)));
    v = 1.0f - t_bc;
    w = t_bc;
  } else if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {  // edge ac
    v = 0.0f;
    w = clip01(ericson_safe_div(d2, d2 - d6));
  } else if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {  // edge ab
    v = clip01(ericson_safe_div(d1, d1 - d3));
    w = 0.0f;
  } else {  // the face
    const float denom_face = fmaxf(va + vb + vc, 1e-30f);
    v = vb / denom_face;
    w = vc / denom_face;
  }
}
