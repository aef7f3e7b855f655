// Fast Wavefront OBJ parser — native replacement for the ModelIO import
// path the reference uses (reference: MetalRaytracing/Model.swift:13-24,
// MDLAsset -> MTKMesh).  The Python loader (metal_raytracing_tpu/io/obj.py)
// is the always-available fallback and correctness oracle; this parser must
// match it record for record:
//   - v / vn / vt records (float32)
//   - f records in all index forms (i, i/j, i//k, i/j/k), 1-based and
//     negative indices
//   - arbitrary polygon faces, fan-triangulated
//   - per-usemtl submesh split (submeshes keyed by material name, ordered
//     by first use; faces before any usemtl go to the "" submesh)
//
// C ABI (ctypes-friendly): parse once into an opaque handle, query sizes,
// copy out flat arrays, free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Submesh {
  std::string material;
  std::vector<int32_t> tri_pos;   // 3 per triangle
  std::vector<int32_t> tri_norm;  // 3 per triangle (-1 when absent)
  std::vector<int32_t> tri_uv;    // 3 per triangle (-1 when absent)
};

struct ObjData {
  std::vector<float> positions;  // 3 per vertex
  std::vector<float> normals;    // 3 per normal
  std::vector<float> texcoords;  // 2 per texcoord
  std::vector<Submesh> submeshes;
  std::vector<std::string> mtllibs;
  int64_t face_count = 0;
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline int resolve(long idx, size_t count) {
  return idx > 0 ? static_cast<int>(idx - 1)
                 : static_cast<int>(static_cast<long>(count) + idx);
}

Submesh* bucket(ObjData& d, std::map<std::string, size_t>& by_name,
                const std::string& name) {
  auto it = by_name.find(name);
  if (it != by_name.end()) return &d.submeshes[it->second];
  by_name.emplace(name, d.submeshes.size());
  d.submeshes.emplace_back();
  d.submeshes.back().material = name;
  return &d.submeshes.back();
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new ObjData();
  std::map<std::string, size_t> by_name;
  std::string active;
  Submesh* sub = nullptr;

  char line[65536];
  struct Corner { int v, t, n; };
  std::vector<Corner> corners;
  while (fgets(line, sizeof line, f)) {
    const char* p = skip_ws(line);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      sscanf(p + 2, "%f %f %f", &x, &y, &z);
      d->positions.insert(d->positions.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      float x = 0, y = 0, z = 0;
      sscanf(p + 3, "%f %f %f", &x, &y, &z);
      d->normals.insert(d->normals.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) {
      float u = 0, v = 0;
      sscanf(p + 3, "%f %f", &u, &v);
      d->texcoords.insert(d->texcoords.end(), {u, v});
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      d->face_count += 1;
      corners.clear();
      const char* q = p + 1;
      while (true) {
        q = skip_ws(q);
        if (*q == '\0' || *q == '\n' || *q == '#') break;
        char* end = nullptr;
        long vi = strtol(q, &end, 10);
        if (end == q) break;
        q = end;
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (*q == '/') {
          ++q;
          if (*q != '/') {
            ti = strtol(q, &end, 10);
            has_t = end != q;
            q = end;
          }
          if (*q == '/') {
            ++q;
            ni = strtol(q, &end, 10);
            has_n = end != q;
            q = end;
          }
        }
        corners.push_back({
            resolve(vi, d->positions.size() / 3),
            has_t ? resolve(ti, d->texcoords.size() / 2) : -1,
            has_n ? resolve(ni, d->normals.size() / 3) : -1,
        });
      }
      if (!sub) sub = bucket(*d, by_name, active);
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
        for (const Corner& c : tri) {
          sub->tri_pos.push_back(c.v);
          sub->tri_uv.push_back(c.t);
          sub->tri_norm.push_back(c.n);
        }
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      const char* q = skip_ws(p + 6);
      std::string name;
      while (*q && *q != '\n' && *q != '\r' && *q != ' ' && *q != '\t')
        name.push_back(*q++);
      active = name;
      sub = bucket(*d, by_name, active);
    } else if (!strncmp(p, "mtllib", 6)) {
      const char* q = skip_ws(p + 6);
      std::string name;
      while (*q && *q != '\n' && *q != '\r') name.push_back(*q++);
      while (!name.empty() && (name.back() == ' ' || name.back() == '\t'))
        name.pop_back();
      d->mtllibs.push_back(name);
    }
  }
  fclose(f);
  return d;
}

// counts: [n_positions, n_normals, n_texcoords, n_submeshes, face_count,
//          total_triangles]
void obj_counts(void* h, int64_t* out) {
  auto* d = static_cast<ObjData*>(h);
  int64_t tris = 0;
  for (const auto& s : d->submeshes) tris += s.tri_pos.size() / 3;
  out[0] = static_cast<int64_t>(d->positions.size() / 3);
  out[1] = static_cast<int64_t>(d->normals.size() / 3);
  out[2] = static_cast<int64_t>(d->texcoords.size() / 2);
  out[3] = static_cast<int64_t>(d->submeshes.size());
  out[4] = d->face_count;
  out[5] = tris;
}

void obj_vertices(void* h, float* pos, float* nrm, float* uv) {
  auto* d = static_cast<ObjData*>(h);
  memcpy(pos, d->positions.data(), d->positions.size() * sizeof(float));
  if (nrm) memcpy(nrm, d->normals.data(), d->normals.size() * sizeof(float));
  if (uv)
    memcpy(uv, d->texcoords.data(), d->texcoords.size() * sizeof(float));
}

int64_t obj_submesh_tris(void* h, int64_t i) {
  auto* d = static_cast<ObjData*>(h);
  return static_cast<int64_t>(d->submeshes[i].tri_pos.size() / 3);
}

const char* obj_submesh_material(void* h, int64_t i) {
  auto* d = static_cast<ObjData*>(h);
  return d->submeshes[i].material.c_str();
}

void obj_submesh_indices(void* h, int64_t i, int32_t* tri_pos,
                         int32_t* tri_norm, int32_t* tri_uv) {
  auto* d = static_cast<ObjData*>(h);
  const Submesh& s = d->submeshes[i];
  memcpy(tri_pos, s.tri_pos.data(), s.tri_pos.size() * sizeof(int32_t));
  memcpy(tri_norm, s.tri_norm.data(), s.tri_norm.size() * sizeof(int32_t));
  memcpy(tri_uv, s.tri_uv.data(), s.tri_uv.size() * sizeof(int32_t));
}

int64_t obj_mtllib_count(void* h) {
  return static_cast<int64_t>(static_cast<ObjData*>(h)->mtllibs.size());
}

const char* obj_mtllib(void* h, int64_t i) {
  return static_cast<ObjData*>(h)->mtllibs[i].c_str();
}

void obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
