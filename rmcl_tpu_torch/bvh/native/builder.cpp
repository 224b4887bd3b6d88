// Native BVH builder: binned SAH, emitting the preorder-threaded slot layout
// of rmcl_tpu.bvh.types (see that module for the format contract).
//
// This is the framework's counterpart to the reference's native acceleration-
// structure builds (Embree/OptiX BVH construction — SURVEY.md §2.9): the
// numpy LBVH builder (rmcl_tpu/bvh/builder.py) is the portable fallback;
// this one is faster on multi-million-triangle maps and produces higher
// quality trees (surface-area heuristic instead of Morton median splits).
//
// Exposed via ctypes (rmcl_tpu/bvh/native/__init__.py). Build: `make`.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{3e38f, 3e38f, 3e38f};
  Vec3 hi{-3e38f, -3e38f, -3e38f};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Prim {
  AABB box;
  Vec3 centroid;
  int32_t id;
};

constexpr int32_t kSentinel = INT32_MIN;
constexpr int kSahBins = 16;

struct Builder {
  const float *verts;
  const int32_t *faces;
  std::vector<Prim> prims;
  // tree as (left_child, right_child) indices into a node pool; leaves are
  // encoded as ~prim_index
  struct Node {
    AABB box;
    int32_t left = -1, right = -1;  // node-pool ids or ~prim
    int32_t size = 1;               // subtree slot count
  };
  std::vector<Node> pool;
  std::atomic<int32_t> pool_top{0};

  int32_t alloc() { return pool_top.fetch_add(1); }

  // recursive binned-SAH build over prims[lo, hi); returns node-pool id or
  // ~prim encoding for single-primitive ranges
  int32_t build(int32_t lo, int32_t hi, int depth) {
    if (hi - lo == 1) return ~prims[lo].id;  // leaf marker (prim id kept)

    AABB cbox, box;
    for (int32_t i = lo; i < hi; ++i) {
      box.grow(prims[i].box);
      cbox.grow(prims[i].centroid);
    }
    // split axis = widest centroid extent
    float ex = cbox.hi.x - cbox.lo.x, ey = cbox.hi.y - cbox.lo.y,
          ez = cbox.hi.z - cbox.lo.z;
    int axis = ex > ey ? (ex > ez ? 0 : 2) : (ey > ez ? 1 : 2);
    float cmin = axis == 0 ? cbox.lo.x : axis == 1 ? cbox.lo.y : cbox.lo.z;
    float cext = axis == 0 ? ex : axis == 1 ? ey : ez;

    int32_t mid;
    if (cext < 1e-12f) {
      mid = lo + (hi - lo) / 2;  // degenerate: median split
    } else {
      // binned SAH
      AABB bins[kSahBins];
      int32_t counts[kSahBins] = {0};
      float scale = kSahBins / cext;
      auto bin_of = [&](const Prim &p) {
        float c = axis == 0 ? p.centroid.x : axis == 1 ? p.centroid.y : p.centroid.z;
        int b = int((c - cmin) * scale);
        return std::min(std::max(b, 0), kSahBins - 1);
      };
      for (int32_t i = lo; i < hi; ++i) {
        int b = bin_of(prims[i]);
        bins[b].grow(prims[i].box);
        counts[b]++;
      }
      // sweep for best split
      AABB right_acc[kSahBins];
      AABB acc;
      for (int b = kSahBins - 1; b > 0; --b) {
        acc.grow(bins[b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int32_t left_n = 0;
      float best_cost = 3e38f;
      int best_b = -1;
      for (int b = 0; b < kSahBins - 1; ++b) {
        left_acc.grow(bins[b]);
        left_n += counts[b];
        int32_t right_n = (hi - lo) - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = left_acc.half_area() * left_n + right_acc[b + 1].half_area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
      if (best_b < 0) {
        mid = lo + (hi - lo) / 2;
      } else {
        auto it = std::partition(
            prims.begin() + lo, prims.begin() + hi,
            [&](const Prim &p) { return bin_of(p) <= best_b; });
        mid = int32_t(it - prims.begin());
        if (mid == lo || mid == hi) mid = lo + (hi - lo) / 2;
      }
    }

    int32_t node = alloc();
    int32_t l, r;
    if (depth < 4 && hi - lo > 16384) {  // task-parallel top levels
      auto fut = std::async(std::launch::async,
                            [&] { return build(lo, mid, depth + 1); });
      r = build(mid, hi, depth + 1);
      l = fut.get();
    } else {
      l = build(lo, mid, depth + 1);
      r = build(mid, hi, depth + 1);
    }
    Node &n = pool[node];
    n.box = box;
    n.left = l;
    n.right = r;
    n.size = 1 + sub_size(l) + sub_size(r);
    return node;
  }

  int32_t sub_size(int32_t child) const {
    return child < 0 ? 1 : pool[child].size;
  }

  // preorder slot emission with hit/miss threading
  float *nodes_out;
  int32_t *leaf_order_out;
  int32_t leaf_cursor = 0;

  // link value for a child at preorder position `pos`
  static int32_t link_of(int32_t pos, bool leaf) { return leaf ? ~pos : pos; }

  void emit(int32_t node, int32_t pos, int32_t miss_link) {
    float *slot = nodes_out + size_t(pos) * 16;
    if (node < 0) {  // leaf: inline triangle
      int32_t prim = ~node;
      const int32_t *f = faces + size_t(prim) * 3;
      const float *a = verts + size_t(f[0]) * 3;
      const float *b = verts + size_t(f[1]) * 3;
      const float *c = verts + size_t(f[2]) * 3;
      float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float nx = e1[1] * e2[2] - e1[2] * e2[1];
      float ny = e1[2] * e2[0] - e1[0] * e2[2];
      float nz = e1[0] * e2[1] - e1[1] * e2[0];
      float len = std::sqrt(nx * nx + ny * ny + nz * nz);
      float inv = len > 1e-20f ? 1.0f / len : 0.0f;
      slot[0] = a[0]; slot[1] = a[1]; slot[2] = a[2];
      slot[3] = e1[0]; slot[4] = e1[1]; slot[5] = e1[2];
      slot[6] = e2[0]; slot[7] = e2[1]; slot[8] = e2[2];
      slot[9] = nx * inv; slot[10] = ny * inv; slot[11] = nz * inv;
      std::memcpy(&slot[12], &prim, 4);
      std::memcpy(&slot[13], &miss_link, 4);
      int32_t inst = 0;
      std::memcpy(&slot[14], &inst, 4);
      slot[15] = 0.f;
      leaf_order_out[leaf_cursor++] = prim;
      return;
    }
    const Node &n = pool[node];
    int32_t l_pos = pos + 1;
    int32_t l_size = sub_size(n.left);
    int32_t r_pos = pos + 1 + l_size;
    int32_t hit = link_of(l_pos, n.left < 0);
    slot[0] = n.box.lo.x; slot[1] = n.box.lo.y; slot[2] = n.box.lo.z;
    slot[3] = n.box.hi.x; slot[4] = n.box.hi.y; slot[5] = n.box.hi.z;
    for (int k = 6; k < 16; ++k) slot[k] = 0.f;
    std::memcpy(&slot[12], &hit, 4);
    std::memcpy(&slot[13], &miss_link, 4);
    emit(n.left, l_pos, link_of(r_pos, n.right < 0));
    emit(n.right, r_pos, miss_link);
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. nodes_out must hold (2*n_faces-1)*16 floats;
// leaf_order_out must hold n_faces int32 (preorder leaf -> original prim id).
// root_link_out receives the root link; aabb_out receives [min3, max3].
int rmcl_build_bvh_sah(const float *verts, int32_t n_verts, const int32_t *faces,
                       int32_t n_faces, float *nodes_out, int32_t *root_link_out,
                       int32_t *leaf_order_out, float *aabb_out) {
  if (n_faces <= 0) return 1;
  Builder b;
  b.verts = verts;
  b.faces = faces;
  b.prims.resize(n_faces);
  AABB scene;
  for (int32_t i = 0; i < n_faces; ++i) {
    const int32_t *f = faces + size_t(i) * 3;
    Vec3 a{verts[f[0] * 3], verts[f[0] * 3 + 1], verts[f[0] * 3 + 2]};
    Vec3 v1{verts[f[1] * 3], verts[f[1] * 3 + 1], verts[f[1] * 3 + 2]};
    Vec3 v2{verts[f[2] * 3], verts[f[2] * 3 + 1], verts[f[2] * 3 + 2]};
    AABB box;
    box.grow(a); box.grow(v1); box.grow(v2);
    b.prims[i].box = box;
    b.prims[i].centroid = {(box.lo.x + box.hi.x) * 0.5f,
                           (box.lo.y + box.hi.y) * 0.5f,
                           (box.lo.z + box.hi.z) * 0.5f};
    b.prims[i].id = i;
    scene.grow(box);
  }
  b.pool.resize(std::max(n_faces - 1, 1));
  b.nodes_out = nodes_out;
  b.leaf_order_out = leaf_order_out;

  int32_t root = b.build(0, n_faces, 0);
  *root_link_out = Builder::link_of(0, root < 0);
  b.emit(root, 0, kSentinel);
  aabb_out[0] = scene.lo.x; aabb_out[1] = scene.lo.y; aabb_out[2] = scene.lo.z;
  aabb_out[3] = scene.hi.x; aabb_out[4] = scene.hi.y; aabb_out[5] = scene.hi.z;
  return 0;
}

}  // extern "C"

extern "C" {

// kd-style recursive median partition of triangle centroids into compact
// leaves of exactly `bin_size` (matching rmcl_tpu.bvh.bins._median_split_order:
// widest-axis split, left child rounded to a multiple of bin_size, leaves
// emitted in DFS order). Returns 0 on success; order_out must hold n int64.
int rmcl_bin_order(const float *centroids /* (n,3) */, int64_t n,
                   int32_t bin_size, int64_t *order_out) {
  if (n <= 0 || bin_size <= 0) return 1;
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;

  struct Seg { int64_t lo, hi; };
  std::vector<Seg> stack;
  stack.push_back({0, n});
  int64_t pos = 0;
  while (!stack.empty()) {
    Seg s = stack.back();
    stack.pop_back();
    int64_t len = s.hi - s.lo;
    if (len <= bin_size) {
      std::memcpy(order_out + pos, order.data() + s.lo, size_t(len) * 8);
      pos += len;
      continue;
    }
    // widest centroid axis over the segment
    float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = s.lo; i < s.hi; ++i) {
      const float *c = centroids + order[i] * 3;
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], c[k]);
        hi[k] = std::max(hi[k], c[k]);
      }
    }
    int axis = 0;
    float w = hi[0] - lo[0];
    if (hi[1] - lo[1] > w) { axis = 1; w = hi[1] - lo[1]; }
    if (hi[2] - lo[2] > w) { axis = 2; }
    // left gets the largest multiple of bin_size <= len/2 (at least one bin)
    int64_t n_left = std::max<int64_t>(
        bin_size, ((len / 2) / bin_size) * bin_size);
    std::nth_element(
        order.begin() + s.lo, order.begin() + s.lo + n_left - 1,
        order.begin() + s.hi,
        [centroids, axis](int64_t a, int64_t b) {
          return centroids[a * 3 + axis] < centroids[b * 3 + axis];
        });
    // DFS: push right first so left is emitted first
    stack.push_back({s.lo + n_left, s.hi});
    stack.push_back({s.lo, s.lo + n_left});
  }
  return pos == n ? 0 : 2;
}

}  // extern "C"
