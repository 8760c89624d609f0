// Triangle BVH: host-side geometry service for the SDF primitive.
//
// The PyTorch port's copy of instant_ngp_tpu/native/bvh.cpp (the JAX
// package's host BVH; reference src/triangle_bvh.cu, triangle_bvh.cuh:38-55),
// built by instant_ngp_torch/geometry/bvh.py with g++ into
// build/instant_ngp_torch/ and loaded with ctypes. Signed-distance and ray
// queries run on the host CPU (multithreaded C++ over numpy arrays) while
// the training step consumes the resulting batches on the card. Provides:
//   * median-split BVH build over triangles
//   * batched unsigned closest-distance queries
//   * signed distance via ray-parity (watertight), the raystab sign
//     heuristic or angle-weighted pseudonormals (reference EMeshSdfMode,
//     common.h:118-123)
//   * batched ray-mesh intersection (for GT renders / IoU culling)
//
// One change from the JAX package's source: the lazy pseudonormal build runs
// under std::call_once, because the port queries one BVH from its batch
// producer thread and from the caller's thread at once. Every query computes
// the same bits as the JAX package's build on the same host.
//
// Build: g++ -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC -o libngpbvh.so bvh.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <array>
#include <functional>
#include <limits>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
  float dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  float norm2() const { return dot(*this); }
};

struct Tri {
  Vec3 a, b, c;
  Vec3 centroid() const { return (a + b + c) * (1.0f / 3.0f); }
};

struct AABB {
  Vec3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const Tri& t) { grow(t.a); grow(t.b); grow(t.c); }
  float dist2(const Vec3& p) const {
    float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
    float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
    float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
  // slab test; returns entry t or +inf
  float ray(const Vec3& o, const Vec3& inv_d) const {
    float t1 = (lo.x - o.x) * inv_d.x, t2 = (hi.x - o.x) * inv_d.x;
    float tmin = std::min(t1, t2), tmax = std::max(t1, t2);
    t1 = (lo.y - o.y) * inv_d.y; t2 = (hi.y - o.y) * inv_d.y;
    tmin = std::max(tmin, std::min(t1, t2)); tmax = std::min(tmax, std::max(t1, t2));
    t1 = (lo.z - o.z) * inv_d.z; t2 = (hi.z - o.z) * inv_d.z;
    tmin = std::max(tmin, std::min(t1, t2)); tmax = std::min(tmax, std::max(t1, t2));
    if (tmax < 0 || tmin > tmax) return std::numeric_limits<float>::infinity();
    return std::max(tmin, 0.0f);
  }
};

struct Node {
  AABB box;
  int left = -1, right = -1;  // children; leaf if left < 0
  int first = 0, count = 0;   // triangle range for leaves
};

float point_tri_dist2(const Vec3& p, const Tri& t, Vec3* closest_out = nullptr) {
  // Ericson, Real-Time Collision Detection §5.1.5
  Vec3 ab = t.b - t.a, ac = t.c - t.a, ap = p - t.a;
  float d1 = ab.dot(ap), d2 = ac.dot(ap);
  Vec3 closest;
  if (d1 <= 0 && d2 <= 0) {
    closest = t.a;
  } else {
    Vec3 bp = p - t.b;
    float d3 = ab.dot(bp), d4 = ac.dot(bp);
    if (d3 >= 0 && d4 <= d3) {
      closest = t.b;
    } else {
      float vc = d1 * d4 - d3 * d2;
      if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        float v = d1 / (d1 - d3);
        closest = t.a + ab * v;
      } else {
        Vec3 cp = p - t.c;
        float d5 = ab.dot(cp), d6 = ac.dot(cp);
        if (d6 >= 0 && d5 <= d6) {
          closest = t.c;
        } else {
          float vb = d5 * d2 - d1 * d6;
          if (vb <= 0 && d2 >= 0 && d6 <= 0) {
            float w = d2 / (d2 - d6);
            closest = t.a + ac * w;
          } else {
            float va = d3 * d6 - d5 * d4;
            if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
              float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
              closest = t.b + (t.c - t.b) * w;
            } else {
              float denom = 1.0f / (va + vb + vc);
              float v = vb * denom, w = vc * denom;
              closest = t.a + ab * v + ac * w;
            }
          }
        }
      }
    }
  }
  if (closest_out) *closest_out = closest;
  return (p - closest).norm2();
}

// Möller–Trumbore
bool ray_tri(const Vec3& o, const Vec3& d, const Tri& t, float* t_out) {
  const float EPS = 1e-9f;
  Vec3 e1 = t.b - t.a, e2 = t.c - t.a;
  Vec3 h = d.cross(e2);
  float det = e1.dot(h);
  if (std::fabs(det) < EPS) return false;
  float inv = 1.0f / det;
  Vec3 s = o - t.a;
  float u = s.dot(h) * inv;
  if (u < 0 || u > 1) return false;
  Vec3 q = s.cross(e1);
  float v = d.dot(q) * inv;
  if (v < 0 || u + v > 1) return false;
  float tt = e2.dot(q) * inv;
  if (tt <= EPS) return false;
  *t_out = tt;
  return true;
}

struct BVH {
  std::vector<Tri> tris;
  std::vector<Node> nodes;
  // angle-weighted pseudonormals (Baerentzen & Aanaes) for O(1) sign
  // from a single closest-point query — replaces raystab/parity when
  // the mesh is reasonably clean; built lazily, once.
  std::once_flag pseudonormals_once;
  std::vector<Vec3> face_normals;          // per tri
  std::vector<Vec3> vertex_pseudo;         // per tri, per corner (3x)
  std::vector<Vec3> edge_pseudo;           // per tri, per edge (3x): ab, bc, ca

  void build(const float* verts, int n_tris) {
    tris.resize(n_tris);
    for (int i = 0; i < n_tris; ++i) {
      tris[i].a = {verts[i * 9 + 0], verts[i * 9 + 1], verts[i * 9 + 2]};
      tris[i].b = {verts[i * 9 + 3], verts[i * 9 + 4], verts[i * 9 + 5]};
      tris[i].c = {verts[i * 9 + 6], verts[i * 9 + 7], verts[i * 9 + 8]};
    }
    nodes.clear();
    nodes.reserve(2 * n_tris);
    nodes.emplace_back();
    build_node(0, 0, n_tris);
  }

  void build_node(int node_idx, int first, int count) {
    Node& n0 = nodes[node_idx];
    n0.first = first;
    n0.count = count;
    AABB box;
    for (int i = first; i < first + count; ++i) box.grow(tris[i]);
    nodes[node_idx].box = box;
    if (count <= 4) return;
    Vec3 ext = box.hi - box.lo;
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    int mid = first + count / 2;
    std::nth_element(
        tris.begin() + first, tris.begin() + mid, tris.begin() + first + count,
        [axis](const Tri& a, const Tri& b) {
          Vec3 ca = a.centroid(), cb = b.centroid();
          return axis == 0 ? ca.x < cb.x : axis == 1 ? ca.y < cb.y : ca.z < cb.z;
        });
    int li = (int)nodes.size();
    nodes.emplace_back();
    nodes.emplace_back();
    nodes[node_idx].left = li;
    nodes[node_idx].right = li + 1;
    nodes[node_idx].count = 0;
    build_node(li, first, mid - first);
    build_node(li + 1, mid, first + count - mid);
  }

  float closest_dist2(const Vec3& p, Vec3* cp_out, int* tri_out = nullptr) const {
    float best = 1e30f;
    Vec3 best_cp{0, 0, 0};
    int best_tri = -1;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node& n = nodes[stack[--sp]];
      if (n.box.dist2(p) >= best) continue;
      if (n.left < 0) {
        for (int i = n.first; i < n.first + n.count; ++i) {
          Vec3 cp;
          float d2 = point_tri_dist2(p, tris[i], &cp);
          if (d2 < best) { best = d2; best_cp = cp; best_tri = i; }
        }
      } else {
        float dl = nodes[n.left].box.dist2(p);
        float dr = nodes[n.right].box.dist2(p);
        // near child last (popped first)
        if (dl < dr) {
          if (dr < best) stack[sp++] = n.right;
          if (dl < best) stack[sp++] = n.left;
        } else {
          if (dl < best) stack[sp++] = n.left;
          if (dr < best) stack[sp++] = n.right;
        }
      }
    }
    if (cp_out) *cp_out = best_cp;
    if (tri_out) *tri_out = best_tri;
    return best;
  }

  void build_pseudonormals() {
    std::call_once(pseudonormals_once, [this] { build_pseudonormals_now(); });
  }

  void build_pseudonormals_now() {
    int n = (int)tris.size();
    face_normals.resize(n);
    vertex_pseudo.assign(n * 3, {0, 0, 0});
    edge_pseudo.assign(n * 3, {0, 0, 0});

    // unify vertices by bit pattern
    struct KeyHash {
      size_t operator()(const std::array<uint32_t, 3>& k) const {
        size_t h = 1469598103934665603ull;
        for (uint32_t v : k) { h ^= v; h *= 1099511628211ull; }
        return h;
      }
    };
    auto key_of = [](const Vec3& v) {
      std::array<uint32_t, 3> k;
      std::memcpy(k.data(), &v, 12);
      return k;
    };
    std::unordered_map<std::array<uint32_t, 3>, int, KeyHash> vmap;
    std::vector<std::array<int, 3>> vidx(n);
    int next_v = 0;
    for (int i = 0; i < n; ++i) {
      const Vec3* corners[3] = {&tris[i].a, &tris[i].b, &tris[i].c};
      for (int c = 0; c < 3; ++c) {
        auto k = key_of(*corners[c]);
        auto it = vmap.find(k);
        if (it == vmap.end()) it = vmap.emplace(k, next_v++).first;
        vidx[i][c] = it->second;
      }
    }

    std::vector<Vec3> vnorm(next_v, {0, 0, 0});
    std::unordered_map<uint64_t, Vec3> enorm;
    auto ekey = [](int a, int b) {
      if (a > b) std::swap(a, b);
      return ((uint64_t)a << 32) | (uint32_t)b;
    };
    for (int i = 0; i < n; ++i) {
      Vec3 e1 = tris[i].b - tris[i].a, e2 = tris[i].c - tris[i].a;
      Vec3 fn = e1.cross(e2);
      float len = std::sqrt(fn.norm2());
      face_normals[i] = len > 1e-20f ? fn * (1.0f / len) : Vec3{0, 0, 1};
      const Vec3* corners[3] = {&tris[i].a, &tris[i].b, &tris[i].c};
      for (int c = 0; c < 3; ++c) {
        // angle at corner c
        Vec3 u = *corners[(c + 1) % 3] - *corners[c];
        Vec3 v = *corners[(c + 2) % 3] - *corners[c];
        float cosang = u.dot(v) / std::sqrt(std::max(u.norm2() * v.norm2(), 1e-30f));
        float ang = std::acos(std::min(1.0f, std::max(-1.0f, cosang)));
        vnorm[vidx[i][c]] = vnorm[vidx[i][c]] + face_normals[i] * ang;
        Vec3& en = enorm[ekey(vidx[i][c], vidx[i][(c + 1) % 3])];
        en = en + face_normals[i];
      }
    }
    for (int i = 0; i < n; ++i) {
      for (int c = 0; c < 3; ++c) {
        vertex_pseudo[i * 3 + c] = vnorm[vidx[i][c]];
        edge_pseudo[i * 3 + c] = enorm[ekey(vidx[i][c], vidx[i][(c + 1) % 3])];
      }
    }
  }

  float signed_distance_pseudo(const Vec3& p) const {
    Vec3 cp;
    int ti;
    float d2 = closest_dist2(p, &cp, &ti);
    // classify the closest feature via barycentric coords
    const Tri& t = tris[ti];
    Vec3 v0 = t.b - t.a, v1 = t.c - t.a, v2 = cp - t.a;
    float d00 = v0.dot(v0), d01 = v0.dot(v1), d11 = v1.dot(v1);
    float d20 = v2.dot(v0), d21 = v2.dot(v1);
    float denom = d00 * d11 - d01 * d01;
    float v = denom != 0 ? (d11 * d20 - d01 * d21) / denom : 0.0f;
    float w = denom != 0 ? (d00 * d21 - d01 * d20) / denom : 0.0f;
    float u = 1.0f - v - w;
    const float eps = 1e-4f;
    Vec3 nrm;
    if (v <= eps && w <= eps) nrm = vertex_pseudo[ti * 3 + 0];
    else if (u <= eps && w <= eps) nrm = vertex_pseudo[ti * 3 + 1];
    else if (u <= eps && v <= eps) nrm = vertex_pseudo[ti * 3 + 2];
    else if (w <= eps) nrm = edge_pseudo[ti * 3 + 0];      // edge ab
    else if (u <= eps) nrm = edge_pseudo[ti * 3 + 1];      // edge bc
    else if (v <= eps) nrm = edge_pseudo[ti * 3 + 2];      // edge ca
    else nrm = face_normals[ti];
    float s = (p - cp).dot(nrm) >= 0 ? 1.0f : -1.0f;
    return s * std::sqrt(d2);
  }

  int count_hits(const Vec3& o, const Vec3& d) const {
    Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    int hits = 0;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node& n = nodes[stack[--sp]];
      if (!std::isfinite(n.box.ray(o, inv))) continue;
      if (n.left < 0) {
        float tt;
        for (int i = n.first; i < n.first + n.count; ++i)
          if (ray_tri(o, d, tris[i], &tt)) ++hits;
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return hits;
  }

  float first_hit(const Vec3& o, const Vec3& d, int* tri_idx) const {
    Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    float best = std::numeric_limits<float>::infinity();
    int best_i = -1;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node& n = nodes[stack[--sp]];
      float entry = n.box.ray(o, inv);
      if (entry >= best) continue;
      if (n.left < 0) {
        float tt;
        for (int i = n.first; i < n.first + n.count; ++i)
          if (ray_tri(o, d, tris[i], &tt) && tt < best) { best = tt; best_i = i; }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    if (tri_idx) *tri_idx = best_i;
    return best;
  }
};

void parallel_for(int n, const std::function<void(int, int)>& fn) {
  int n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, 16);
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn]() { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// raystab directions: 32 well-distributed unit vectors (Fibonacci sphere)
std::vector<Vec3> stab_dirs() {
  std::vector<Vec3> dirs;
  const float golden = 2.39996323f;
  for (int i = 0; i < 32; ++i) {
    float z = 1.0f - (2.0f * i + 1.0f) / 32.0f;
    float r = std::sqrt(std::max(0.0f, 1.0f - z * z));
    float th = golden * i;
    dirs.push_back({r * std::cos(th), r * std::sin(th), z});
  }
  return dirs;
}

}  // namespace

extern "C" {

void* bvh_create(const float* tri_verts, int n_tris) {
  auto* bvh = new BVH();
  bvh->build(tri_verts, n_tris);
  return bvh;
}

void bvh_destroy(void* handle) { delete static_cast<BVH*>(handle); }

// mode: 0 = unsigned, 1 = watertight (single-ray parity), 2 = raystab,
//       3 = pseudonormal (angle-weighted; one closest-point query)
void bvh_signed_distance(void* handle, const float* points, int n, int mode,
                         float* out_dist) {
  auto* bvh = static_cast<BVH*>(handle);
  static const std::vector<Vec3> dirs = stab_dirs();
  if (mode == 3) {
    bvh->build_pseudonormals();
    parallel_for(n, [&](int lo, int hi) {
      for (int i = lo; i < hi; ++i) {
        Vec3 p{points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
        out_dist[i] = bvh->signed_distance_pseudo(p);
      }
    });
    return;
  }
  parallel_for(n, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
      float d = std::sqrt(bvh->closest_dist2(p, nullptr));
      float sign = 1.0f;
      if (mode == 1) {
        int hits = bvh->count_hits(p, {0.577350f, 0.577350f, 0.577350f});
        sign = (hits & 1) ? -1.0f : 1.0f;
      } else if (mode == 2) {
        // Raystab: if every stab direction hits geometry, we're inside
        // (reference raystab heuristic for non-watertight meshes).
        int blocked = 0;
        for (const auto& dir : dirs) {
          int t_i;
          if (std::isfinite(bvh->first_hit(p, dir, &t_i))) ++blocked;
        }
        sign = (blocked == (int)dirs.size()) ? -1.0f : 1.0f;
      }
      out_dist[i] = sign * d;
    }
  });
}

void bvh_closest_points(void* handle, const float* points, int n, float* out_cp) {
  auto* bvh = static_cast<BVH*>(handle);
  parallel_for(n, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
      Vec3 cp;
      bvh->closest_dist2(p, &cp);
      out_cp[i * 3] = cp.x; out_cp[i * 3 + 1] = cp.y; out_cp[i * 3 + 2] = cp.z;
    }
  });
}

void bvh_raytrace(void* handle, const float* origins, const float* dirs_in,
                  int n, float* out_t, int* out_tri) {
  auto* bvh = static_cast<BVH*>(handle);
  parallel_for(n, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 o{origins[i * 3], origins[i * 3 + 1], origins[i * 3 + 2]};
      Vec3 d{dirs_in[i * 3], dirs_in[i * 3 + 1], dirs_in[i * 3 + 2]};
      int tri;
      float t = bvh->first_hit(o, d, &tri);
      out_t[i] = t;
      out_tri[i] = tri;
    }
  });
}

void bvh_inside(void* handle, const float* points, int n, int mode, uint8_t* out) {
  auto* bvh = static_cast<BVH*>(handle);
  static const std::vector<Vec3> dirs = stab_dirs();
  parallel_for(n, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
      bool inside;
      if (mode == 2) {
        inside = true;
        for (const auto& dir : dirs) {
          int t_i;
          if (!std::isfinite(bvh->first_hit(p, dir, &t_i))) { inside = false; break; }
        }
      } else {
        inside = bvh->count_hits(p, {0.577350f, 0.577350f, 0.577350f}) & 1;
      }
      out[i] = inside ? 1 : 0;
    }
  });
}

}  // extern "C"
