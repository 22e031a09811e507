// srt_native: C++ host-runtime kernels for the path tracer.
//
// Native equivalents of the asset pipeline and BVH builder that the
// reference implements in C++ (src/asset_utils/model_loader.cpp,
// include/intersection_utils/bvh.h).  The Python implementations in
// srt_tpu/utils are the semantic reference; this library must produce
// bit-identical outputs (asserted by tests/test_native.py) and exists for
// host-side speed on large assets: OBJ parsing is ~20x faster than the
// Python line loop and the BVH build ~50x.
//
// C ABI only (loaded via ctypes, no pybind11 dependency).  Build:
//   make -C native        (produces libsrt_native.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 { float x, y, z; };
struct Vec2 { float u, v; };

struct MaterialDef {
  float kd[3] = {1.f, 1.f, 1.f};
  float ks[3] = {0.f, 0.f, 0.f};
  float ns = 0.f;
  int use_texture = 0;
  std::string tex_path;
};

// Packed per-corner mesh, mirroring srt_tpu.utils.obj_loader.MeshData.
struct ObjData {
  std::vector<Vec3> positions;  // duplicated per face corner
  std::vector<Vec2> uvs;
  std::vector<uint32_t> tri_vidx;  // 3 per triangle
  std::vector<uint32_t> tri_mat;
  std::vector<MaterialDef> materials;
};

int64_t resolve_index(long raw, size_t count) {
  // OBJ 1-based, negative = relative (model_loader.cpp:97-107 + superset).
  return raw > 0 ? raw - 1 : static_cast<int64_t>(count) + raw;
}

void parse_mtl(const std::string& path,
               std::vector<std::string>* order,
               std::unordered_map<std::string, MaterialDef>* mats) {
  std::ifstream file(path);
  if (!file) return;
  std::string folder;
  const auto slash = path.find_last_of('/');
  if (slash != std::string::npos) folder = path.substr(0, slash + 1);

  MaterialDef* cur = nullptr;
  bool skip = false;
  std::string line;
  while (std::getline(file, line)) {
    // CRLF-safe trim (model_loader.cpp:51-52).
    const auto b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    const auto e = line.find_last_not_of(" \t\r\n");
    line = line.substr(b, e - b + 1);
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ls(line);
    std::string prefix;
    ls >> prefix;
    if (prefix == "newmtl") {
      std::string name;
      ls >> name;
      if (mats->count(name)) {
        // Working duplicate skip (the reference's skip_mtl reset bug is
        // deliberately not reproduced, model_loader.cpp:200-219).
        skip = true;
        cur = nullptr;
      } else {
        skip = false;
        order->push_back(name);
        cur = &(*mats)[name];
      }
      continue;
    }
    if (skip || cur == nullptr) continue;
    if (prefix == "Kd") ls >> cur->kd[0] >> cur->kd[1] >> cur->kd[2];
    else if (prefix == "Ks") ls >> cur->ks[0] >> cur->ks[1] >> cur->ks[2];
    else if (prefix == "Ns") ls >> cur->ns;
    else if (prefix == "map_Kd") {
      std::string tex;
      while (ls >> tex) {}  // last token, matching the Python parser
      cur->use_texture = 1;
      cur->tex_path = folder + tex;
    }
    // Ka/Tf/Ni/Ke/d/illum/Tr/map_Ka recognized and ignored.
  }
}

ObjData* parse_obj(const std::string& path) {
  std::ifstream file(path);
  if (!file) return nullptr;
  std::string folder;
  const auto slash = path.find_last_of('/');
  if (slash != std::string::npos) folder = path.substr(0, slash + 1);

  std::vector<Vec3> vertices;
  std::vector<Vec2> texcoords;
  std::vector<std::string> mtl_files;

  struct Corner { int64_t v; int64_t vt; };
  struct Tri { Corner c[3]; };
  struct Sub { std::string material; std::vector<Tri> faces; };
  std::vector<Sub> subs;
  Sub cur;

  auto flush = [&]() {
    if (!cur.material.empty() || !cur.faces.empty())
      subs.push_back(std::move(cur));
    cur = Sub();
  };

  std::string line;
  std::vector<Corner> corners;
  while (std::getline(file, line)) {
    const auto b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    const auto e = line.find_last_not_of(" \t\r\n");
    line = line.substr(b, e - b + 1);
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ls(line);
    std::string prefix;
    ls >> prefix;
    if (prefix == "v") {
      Vec3 v;
      if (ls >> v.x >> v.y >> v.z) vertices.push_back(v);
    } else if (prefix == "vt") {
      Vec2 t;
      if (ls >> t.u >> t.v) texcoords.push_back(t);
    } else if (prefix == "vn") {
      // parsed and discarded (geometric normals are derived in-kernel)
    } else if (prefix == "f") {
      corners.clear();
      std::string chunk;
      while (ls >> chunk) {
        Corner c{-1, -1};
        // v[/vt[/vn]]
        const auto s1 = chunk.find('/');
        c.v = resolve_index(std::stol(chunk.substr(0, s1)), vertices.size());
        if (s1 != std::string::npos) {
          const auto s2 = chunk.find('/', s1 + 1);
          const std::string vt = chunk.substr(
              s1 + 1, s2 == std::string::npos ? std::string::npos : s2 - s1 - 1);
          if (!vt.empty())
            c.vt = resolve_index(std::stol(vt), texcoords.size());
        }
        corners.push_back(c);
      }
      // Triangles, quads split (0,1,2)+(0,2,3), n-gons fan-triangulated
      // (model_loader.cpp:110-142 + superset; parity with the Python
      // parser).
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        Tri t;
        t.c[0] = corners[0];
        t.c[1] = corners[k];
        t.c[2] = corners[k + 1];
        cur.faces.push_back(t);
      }
    } else if (prefix == "usemtl") {
      if (!cur.material.empty() || !cur.faces.empty()) flush();
      ls >> cur.material;
    } else if (prefix == "mtllib") {
      std::string f;
      ls >> f;
      mtl_files.push_back(f);
    }
    // s / o / g ignored (model_loader.cpp:160-168).
  }
  flush();

  std::vector<std::string> mat_order;
  std::unordered_map<std::string, MaterialDef> mats;
  for (const auto& f : mtl_files) parse_mtl(folder + f, &mat_order, &mats);

  std::unordered_map<std::string, uint32_t> mat_index;
  auto out = std::make_unique<ObjData>();
  for (const auto& name : mat_order) {
    mat_index[name] = static_cast<uint32_t>(out->materials.size());
    out->materials.push_back(mats[name]);
  }
  if (out->materials.empty()) out->materials.push_back(MaterialDef());

  for (const auto& sub : subs) {
    uint32_t midx = 0;
    const auto it = mat_index.find(sub.material);
    if (it != mat_index.end()) midx = it->second;
    for (const auto& face : sub.faces) {
      for (int corner = 0; corner < 3; ++corner) {
        const auto& c = face.c[corner];
        out->tri_vidx.push_back(static_cast<uint32_t>(out->positions.size()));
        out->positions.push_back(vertices[static_cast<size_t>(c.v)]);
        out->uvs.push_back(
            c.vt >= 0 ? texcoords[static_cast<size_t>(c.vt)] : Vec2{0.f, 0.f});
      }
      out->tri_mat.push_back(midx);
    }
  }
  return out.release();
}

}  // namespace

extern "C" {

// ----------------------------- OBJ loading --------------------------------

void* srt_obj_load(const char* path) { return parse_obj(path); }

void srt_obj_counts(void* handle, int64_t* n_positions, int64_t* n_tris,
                    int64_t* n_materials) {
  auto* o = static_cast<ObjData*>(handle);
  *n_positions = static_cast<int64_t>(o->positions.size());
  *n_tris = static_cast<int64_t>(o->tri_mat.size());
  *n_materials = static_cast<int64_t>(o->materials.size());
}

void srt_obj_arrays(void* handle, float* positions, float* uvs,
                    uint32_t* tri_vidx, uint32_t* tri_mat) {
  auto* o = static_cast<ObjData*>(handle);
  std::memcpy(positions, o->positions.data(), o->positions.size() * 12);
  std::memcpy(uvs, o->uvs.data(), o->uvs.size() * 8);
  std::memcpy(tri_vidx, o->tri_vidx.data(), o->tri_vidx.size() * 4);
  std::memcpy(tri_mat, o->tri_mat.data(), o->tri_mat.size() * 4);
}

int srt_obj_material(void* handle, int64_t i, float* kd, float* ks, float* ns,
                     int* use_texture, char* tex_path, int64_t cap) {
  auto* o = static_cast<ObjData*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(o->materials.size())) return -1;
  const auto& m = o->materials[static_cast<size_t>(i)];
  std::memcpy(kd, m.kd, 12);
  std::memcpy(ks, m.ks, 12);
  *ns = m.ns;
  *use_texture = m.use_texture;
  std::snprintf(tex_path, static_cast<size_t>(cap), "%s", m.tex_path.c_str());
  return 0;
}

void srt_obj_free(void* handle) { delete static_cast<ObjData*>(handle); }

// ----------------------------- BVH building -------------------------------

// Midpoint-split binary BVH identical to srt_tpu.utils.bvh.build_bvh
// (itself the reference algorithm, bvh.h:40-148, with a stable partition).
// Caller allocates 2n-1 capacity; returns the node count.
int64_t srt_bvh_build(const float* centers, const float* bmin,
                      const float* bmax, int64_t n, int64_t leaf_size,
                      float* node_min, float* node_max, uint32_t* node_first,
                      uint32_t* node_count, uint32_t* order) {
  if (n <= 0) return 0;
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<uint32_t>(i);

  int64_t next_free = 1;
  node_first[0] = 0;
  node_count[0] = static_cast<uint32_t>(n);

  std::vector<int64_t> stack = {0};
  std::vector<uint32_t> scratch(static_cast<size_t>(n));
  while (!stack.empty()) {
    const int64_t ni = stack.back();
    stack.pop_back();
    const int64_t first = node_first[ni];
    const int64_t count = node_count[ni];

    float mn[3] = {HUGE_VALF, HUGE_VALF, HUGE_VALF};
    float mx[3] = {-HUGE_VALF, -HUGE_VALF, -HUGE_VALF};
    for (int64_t k = first; k < first + count; ++k) {
      const uint32_t p = order[k];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bmin[p * 3 + a]);
        mx[a] = std::max(mx[a], bmax[p * 3 + a]);
      }
    }
    std::memcpy(node_min + ni * 3, mn, 12);
    std::memcpy(node_max + ni * 3, mx, 12);

    if (count <= leaf_size) continue;

    // Longest axis; y/z win ties like the reference (bvh.h:110-118).
    const float ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    const float split = mn[axis] + ext[axis] * 0.5f;

    // Stable partition (matches numpy's boolean-mask concatenate).
    int64_t left = 0;
    for (int64_t k = first; k < first + count; ++k)
      if (centers[order[k] * 3 + axis] < split) scratch[left++] = order[k];
    int64_t right = left;
    for (int64_t k = first; k < first + count; ++k)
      if (!(centers[order[k] * 3 + axis] < split)) scratch[right++] = order[k];
    if (left == 0 || left == count) continue;  // degenerate -> leaf
    std::memcpy(order + first, scratch.data(),
                static_cast<size_t>(count) * 4);

    const int64_t li = next_free, ri = next_free + 1;
    next_free += 2;
    node_first[li] = static_cast<uint32_t>(first);
    node_count[li] = static_cast<uint32_t>(left);
    node_first[ri] = static_cast<uint32_t>(first + left);
    node_count[ri] = static_cast<uint32_t>(count - left);
    node_first[ni] = static_cast<uint32_t>(li);
    node_count[ni] = 0;
    stack.push_back(ri);
    stack.push_back(li);
  }
  return next_free;
}

}  // extern "C"
