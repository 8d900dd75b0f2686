// Native SBVH builder.
//
// C++ implementation of the same Stich-2009 spatial-split BVH algorithm as
// the Python builder (accel/bvh.py): SAH object splits via 3-axis sort +
// sweep, 32-bin spatial splits with triangle-plane reference chopping, and
// per-reference unsplit/duplicate decisions. This is this project's analog
// of the reference's CPU builder role (src/SplitBVHBuilder.cpp) — written
// from scratch against the paper, ported from our own Python version.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Output encoding (arrays, caller reads then calls sbvh_free):
//   bounds : float[num_nodes*6]  (lo.xyz, hi.xyz)
//   meta   : int[num_nodes*4]    (left, right, tri_start, tri_count)
//            left/right = child node ids, -1 -1 for leaves
//   tri_idx: int[num_idx]        triangle ids, leaves reference [start,count)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxDepth = 64;
constexpr int kMaxSpatialDepth = 48;
constexpr int kNumBins = 32;
constexpr float kBig = 3.402823466e38f;

struct V3 {
  double x = 0, y = 0, z = 0;
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  void set(int i, double v) { (i == 0 ? x : (i == 1 ? y : z)) = v; }
};
static V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{kBig, kBig, kBig};
  V3 hi{-kBig, -kBig, -kBig};
  void grow(const V3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void grow(const AABB& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  void intersect(const AABB& b) { lo = vmax(lo, b.lo); hi = vmin(hi, b.hi); }
  double area() const {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return 2.0 * (dx * dy + dy * dz + dz * dx);
  }
  bool valid() const { return hi.x >= lo.x && hi.y >= lo.y && hi.z >= lo.z; }
};

struct Ref {
  int tri;
  AABB box;
};

struct Node {
  AABB box;
  int left = -1, right = -1;
  int tri_start = -1, tri_count = 0;
};

struct Builder {
  const float* verts;  // T*9
  int num_tris;
  float split_alpha;
  int min_leaf, max_leaf;
  bool do_spatial;
  // SAH triangle-intersection cost relative to a node step (the Python
  // builder's Platform.sah_triangle_cost). <1 grows leaves (fewer node
  // steps, more tris per leaf) — the leaf-size lever for packet
  // traversal, where every step costs a whole packet (ARCHITECTURE.md
  // "Reference-asset scale").
  double tri_cost = 1.0;

  std::vector<Ref> refs;      // reference stack; current node's refs at tail
  std::vector<Node> nodes;
  std::vector<int> tri_idx;
  double min_overlap = 0;

  V3 vert(int tri, int corner) const {
    const float* p = verts + tri * 9 + corner * 3;
    return {p[0], p[1], p[2]};
  }

  // clip triangle's reference box by plane dim=pos
  void split_ref(const Ref& r, int dim, double pos, Ref& l, Ref& rr) const {
    l.tri = rr.tri = r.tri;
    l.box = AABB();
    rr.box = AABB();
    V3 v1 = vert(r.tri, 2);
    for (int i = 0; i < 3; ++i) {
      V3 v0 = v1;
      v1 = vert(r.tri, i);
      double p0 = v0[dim], p1v = v1[dim];
      if (p0 <= pos) l.box.grow(v0);
      if (p0 >= pos) rr.box.grow(v0);
      if ((p0 < pos && p1v > pos) || (p0 > pos && p1v < pos)) {
        double t = (pos - p0) / (p1v - p0);
        t = std::min(std::max(t, 0.0), 1.0);
        V3 x{v0.x + (v1.x - v0.x) * t, v0.y + (v1.y - v0.y) * t,
             v0.z + (v1.z - v0.z) * t};
        l.box.grow(x);
        rr.box.grow(x);
      }
    }
    l.box.hi.set(dim, pos);
    rr.box.lo.set(dim, pos);
    l.box.intersect(r.box);
    rr.box.intersect(r.box);
  }

  struct ObjSplit {
    double sah = kBig;
    int dim = -1, num_left = -1;
    AABB lbox, rbox;
  };

  ObjSplit find_object_split(int num_ref, double node_sah) {
    ObjSplit best;
    size_t base = refs.size() - num_ref;
    std::vector<AABB> right_acc(num_ref);
    for (int dim = 0; dim < 3; ++dim) {
      std::sort(refs.begin() + base, refs.end(),
                [dim](const Ref& a, const Ref& b) {
                  double ca = a.box.lo[dim] + a.box.hi[dim];
                  double cb = b.box.lo[dim] + b.box.hi[dim];
                  if (ca != cb) return ca < cb;
                  return a.tri < b.tri;
                });
      AABB rb;
      for (int i = num_ref - 1; i > 0; --i) {
        rb.grow(refs[base + i].box);
        right_acc[i - 1] = rb;
      }
      AABB lb;
      for (int i = 1; i < num_ref; ++i) {
        lb.grow(refs[base + i - 1].box);
        double sah = node_sah + (lb.area() * i +
                     right_acc[i - 1].area() * (num_ref - i)) * tri_cost;
        if (sah < best.sah) {
          best.sah = sah;
          best.dim = dim;
          best.num_left = i;
          best.lbox = lb;
          best.rbox = right_acc[i - 1];
        }
      }
    }
    return best;
  }

  struct SpatSplit {
    double sah = kBig;
    int dim = -1;
    double pos = 0;
  };

  SpatSplit find_spatial_split(const AABB& box, int num_ref,
                               double node_sah) {
    SpatSplit best;
    V3 origin = box.lo;
    V3 size{box.hi.x - box.lo.x, box.hi.y - box.lo.y, box.hi.z - box.lo.z};
    size_t base = refs.size() - num_ref;
    for (int dim = 0; dim < 3; ++dim) {
      double ext = size[dim];
      if (ext <= 0) continue;
      double bin_sz = ext / kNumBins;
      double inv = 1.0 / bin_sz;
      AABB bins[kNumBins];
      int enter[kNumBins] = {0}, exit_[kNumBins] = {0};
      for (int i = 0; i < num_ref; ++i) {
        const Ref& r = refs[base + i];
        int fb = (int)((r.box.lo[dim] - origin[dim]) * inv);
        int lb = (int)((r.box.hi[dim] - origin[dim]) * inv);
        fb = std::min(std::max(fb, 0), kNumBins - 1);
        lb = std::min(std::max(lb, fb), kNumBins - 1);
        if (fb == lb) {
          bins[fb].grow(r.box);
        } else {
          Ref cur = r;
          for (int b = fb; b < lb; ++b) {
            Ref l, rr;
            split_ref(cur, dim, origin[dim] + bin_sz * (b + 1), l, rr);
            bins[b].grow(l.box);
            cur = rr;
          }
          bins[lb].grow(cur.box);
        }
        enter[fb]++;
        exit_[lb]++;
      }
      AABB racc[kNumBins];
      AABB rb;
      for (int i = kNumBins - 1; i > 0; --i) {
        rb.grow(bins[i]);
        racc[i - 1] = rb;
      }
      AABB lb2;
      int lnum = 0, rnum = num_ref;
      for (int i = 1; i < kNumBins; ++i) {
        lb2.grow(bins[i - 1]);
        lnum += enter[i - 1];
        rnum -= exit_[i - 1];
        double sah = node_sah +
                     (lb2.area() * lnum + racc[i - 1].area() * rnum) * tri_cost;
        if (sah < best.sah) {
          best.sah = sah;
          best.dim = dim;
          best.pos = origin[dim] + bin_sz * i;
        }
      }
    }
    return best;
  }

  // returns (left box, left count, right box, right count); refs rewritten
  // so the right child's refs sit at the stack tail
  bool perform_spatial(int num_ref, const SpatSplit& sp, AABB& lbox,
                       int& lnum, AABB& rbox, int& rnum) {
    size_t base = refs.size() - num_ref;
    std::vector<Ref> left, right, straddle;
    lbox = AABB();
    rbox = AABB();
    for (size_t i = base; i < refs.size(); ++i) {
      const Ref& r = refs[i];
      if (r.box.hi[sp.dim] <= sp.pos) {
        lbox.grow(r.box);
        left.push_back(r);
      } else if (r.box.lo[sp.dim] >= sp.pos) {
        rbox.grow(r.box);
        right.push_back(r);
      } else {
        straddle.push_back(r);
      }
    }
    for (const Ref& r : straddle) {
      Ref l, rr;
      split_ref(r, sp.dim, sp.pos, l, rr);
      AABB lub = lbox, rub = rbox, ldb = lbox, rdb = rbox;
      lub.grow(r.box);
      rub.grow(r.box);
      ldb.grow(l.box);
      rdb.grow(rr.box);
      double lac = (double)left.size(), rac = (double)right.size();
      double lbc = lac + 1, rbc = rac + 1;
      double unsplit_l = lub.area() * lbc + rbox.area() * rac;
      double unsplit_r = lbox.area() * lac + rub.area() * rbc;
      double duplicate = ldb.area() * lbc + rdb.area() * rbc;
      double m = std::min({unsplit_l, unsplit_r, duplicate});
      if (m == unsplit_l) {
        lbox = lub;
        left.push_back(r);
      } else if (m == unsplit_r) {
        rbox = rub;
        right.push_back(r);
      } else {
        lbox = ldb;
        rbox = rdb;
        left.push_back(l);
        right.push_back(rr);
      }
    }
    if (left.empty() || right.empty()) return false;
    refs.resize(base);
    refs.insert(refs.end(), left.begin(), left.end());
    refs.insert(refs.end(), right.begin(), right.end());
    lnum = (int)left.size();
    rnum = (int)right.size();
    return true;
  }

  int make_leaf(const AABB& box, int num_ref) {
    Node n;
    n.box = box;
    n.tri_start = (int)tri_idx.size();
    n.tri_count = num_ref;
    for (int i = 0; i < num_ref; ++i) {
      tri_idx.push_back(refs.back().tri);  // pop order = reversed (parity
      refs.pop_back();                     // with Python builder)
    }
    nodes.push_back(n);
    return (int)nodes.size() - 1;
  }

  int build_node(const AABB& box, int num_ref, int level) {
    if (num_ref <= min_leaf || level >= kMaxDepth)
      return make_leaf(box, num_ref);

    double area = box.area();
    double leaf_sah = area * num_ref * tri_cost;
    double node_sah = area * 2.0;
    ObjSplit obj = find_object_split(num_ref, node_sah);

    SpatSplit spat;
    if (do_spatial && level < kMaxSpatialDepth && obj.dim >= 0) {
      AABB ov = obj.lbox;
      ov.intersect(obj.rbox);
      if (ov.valid() && ov.area() >= min_overlap)
        spat = find_spatial_split(box, num_ref, node_sah);
    }

    double min_sah = std::min({leaf_sah, obj.sah, spat.sah});
    if (min_sah == leaf_sah && num_ref <= max_leaf)
      return make_leaf(box, num_ref);

    AABB lbox, rbox;
    int lnum = 0, rnum = 0;
    bool did = false;
    if (spat.dim >= 0 && min_sah == spat.sah)
      did = perform_spatial(num_ref, spat, lbox, lnum, rbox, rnum);
    if (!did) {
      // re-sort along obj.dim and split at num_left
      size_t base = refs.size() - num_ref;
      int dim = obj.dim;
      std::sort(refs.begin() + base, refs.end(),
                [dim](const Ref& a, const Ref& b) {
                  double ca = a.box.lo[dim] + a.box.hi[dim];
                  double cb = b.box.lo[dim] + b.box.hi[dim];
                  if (ca != cb) return ca < cb;
                  return a.tri < b.tri;
                });
      lnum = obj.num_left;
      rnum = num_ref - lnum;
      lbox = obj.lbox;
      rbox = obj.rbox;
    }

    // right child's refs live at the stack tail -> build right first
    int right = build_node(rbox, rnum, level + 1);
    int left = build_node(lbox, lnum, level + 1);
    Node n;
    n.box = box;
    n.left = left;
    n.right = right;
    nodes.push_back(n);
    return (int)nodes.size() - 1;
  }

  int run() {
    refs.resize(num_tris);
    AABB root;
    for (int t = 0; t < num_tris; ++t) {
      refs[t].tri = t;
      refs[t].box = AABB();
      for (int c = 0; c < 3; ++c) refs[t].box.grow(vert(t, c));
      root.grow(refs[t].box);
    }
    min_overlap = root.area() * split_alpha;
    return build_node(root, num_tris, 0);
  }
};

}  // namespace

extern "C" {

int sbvh_build(const float* verts, int num_tris, float split_alpha,
               int min_leaf, int max_leaf, int do_spatial, float tri_cost,
               float** out_bounds, int** out_meta, int** out_tri_idx,
               int* out_num_nodes, int* out_num_idx, int* out_root) {
  Builder b;
  b.verts = verts;
  b.num_tris = num_tris;
  b.split_alpha = split_alpha;
  b.min_leaf = min_leaf;
  b.max_leaf = max_leaf;
  b.do_spatial = do_spatial != 0;
  b.tri_cost = tri_cost;
  int root = b.run();

  int nn = (int)b.nodes.size();
  float* bounds = (float*)std::malloc(sizeof(float) * nn * 6);
  int* meta = (int*)std::malloc(sizeof(int) * nn * 4);
  int* tidx = (int*)std::malloc(sizeof(int) * b.tri_idx.size());
  if (!bounds || !meta || (!tidx && !b.tri_idx.empty())) return -1;
  for (int i = 0; i < nn; ++i) {
    const Node& n = b.nodes[i];
    bounds[i * 6 + 0] = (float)n.box.lo.x;
    bounds[i * 6 + 1] = (float)n.box.lo.y;
    bounds[i * 6 + 2] = (float)n.box.lo.z;
    bounds[i * 6 + 3] = (float)n.box.hi.x;
    bounds[i * 6 + 4] = (float)n.box.hi.y;
    bounds[i * 6 + 5] = (float)n.box.hi.z;
    meta[i * 4 + 0] = n.left;
    meta[i * 4 + 1] = n.right;
    meta[i * 4 + 2] = n.tri_start;
    meta[i * 4 + 3] = n.tri_count;
  }
  std::memcpy(tidx, b.tri_idx.data(), sizeof(int) * b.tri_idx.size());
  *out_bounds = bounds;
  *out_meta = meta;
  *out_tri_idx = tidx;
  *out_num_nodes = nn;
  *out_num_idx = (int)b.tri_idx.size();
  *out_root = root;
  return 0;
}

void sbvh_free(void* p) { std::free(p); }

}  // extern "C"
