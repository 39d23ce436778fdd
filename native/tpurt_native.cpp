// tpurt native runtime: fast OBJ loading + binned-SAH CPU BVH builder.
//
// Counterpart of the reference's native layer: the reference does
// all of this in C++ too (tiny_obj_loader parsing + BVHBuilder::build's
// recursive SAH split and depth-first flatten with skip links
// [Source/BVHBuilder.cpp, RECALL — written from behavior, not copied]).
// Here the hot render path is JAX on the GPU; this library covers the
// host-side runtime where native code actually pays off:
//   * OBJ parsing (Python parsing is ~50x slower on Sponza-sized files)
//   * the CPU golden-oracle BVH used by the test pyramid
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: make -C native   (produces libhost_native.so)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loading
// ---------------------------------------------------------------------------

struct ObjMesh {
  std::vector<float> positions;   // 3 * num_positions
  std::vector<float> normals;     // 3 * num_normals (file order)
  std::vector<float> texcoords;   // 2 * num_texcoords (file order)
  std::vector<int32_t> tri_pos;   // 3 * num_tris position indices
  std::vector<int32_t> tri_nrm;   // 3 * num_tris normal indices (-1 if none)
  std::vector<int32_t> tri_tex;   // 3 * num_tris texcoord indices (-1 none)
  std::vector<int32_t> tri_mtl;   // num_tris material index (-1 if none)
  std::vector<std::string> mtl_names;  // usemtl names, first-use order
  std::string mtllibs;            // '\n'-separated mtllib filenames
};

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Parses one face corner token "v", "v/t", "v//n", "v/t/n".
static void parse_corner(const char*& p, const char* end, long np, long nn,
                         long nt, int32_t* pos_idx, int32_t* nrm_idx,
                         int32_t* tex_idx) {
  char* q;
  long v = strtol(p, &q, 10);
  p = q;
  *pos_idx = (int32_t)(v > 0 ? v - 1 : np + v);
  *nrm_idx = -1;
  *tex_idx = -1;
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      long t = strtol(p, &q, 10);
      p = q;
      *tex_idx = (int32_t)(t > 0 ? t - 1 : nt + t);
    }
    if (p < end && *p == '/') {
      ++p;
      long n = strtol(p, &q, 10);
      p = q;
      *nrm_idx = (int32_t)(n > 0 ? n - 1 : nn + n);
    }
  }
}

ObjMesh* obj_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)size + 1);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[(size_t)size] = '\n';

  ObjMesh* m = new ObjMesh();
  int32_t cur_mtl = -1;
  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    const char* c = skip_ws(p, line_end);
    if (c + 6 < line_end && memcmp(c, "usemtl", 6) == 0 &&
        (c[6] == ' ' || c[6] == '\t')) {
      const char* n0 = skip_ws(c + 7, line_end);
      const char* n1 = line_end;
      while (n1 > n0 && (n1[-1] == ' ' || n1[-1] == '\t' || n1[-1] == '\r'))
        --n1;
      std::string name(n0, (size_t)(n1 - n0));
      cur_mtl = -1;
      for (size_t k = 0; k < m->mtl_names.size(); ++k)
        if (m->mtl_names[k] == name) { cur_mtl = (int32_t)k; break; }
      if (cur_mtl < 0) {
        cur_mtl = (int32_t)m->mtl_names.size();
        m->mtl_names.push_back(name);
      }
    } else if (c + 6 < line_end && memcmp(c, "mtllib", 6) == 0 &&
               (c[6] == ' ' || c[6] == '\t')) {
      const char* n0 = skip_ws(c + 7, line_end);
      const char* n1 = line_end;
      while (n1 > n0 && (n1[-1] == ' ' || n1[-1] == '\t' || n1[-1] == '\r'))
        --n1;
      if (n1 > n0) {
        if (!m->mtllibs.empty()) m->mtllibs += '\n';
        m->mtllibs.append(n0, (size_t)(n1 - n0));
      }
    } else if (c + 1 < line_end && c[0] == 'v' &&
        (c[1] == ' ' || c[1] == '\t')) {
      char* q;
      float x = strtof(c + 2, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      m->positions.push_back(x);
      m->positions.push_back(y);
      m->positions.push_back(z);
    } else if (c + 2 < line_end && c[0] == 'v' && c[1] == 'n' &&
               (c[2] == ' ' || c[2] == '\t')) {
      char* q;
      float x = strtof(c + 3, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      m->normals.push_back(x);
      m->normals.push_back(y);
      m->normals.push_back(z);
    } else if (c + 2 < line_end && c[0] == 'v' && c[1] == 't' &&
               (c[2] == ' ' || c[2] == '\t')) {
      char* q;
      float u = strtof(c + 3, &q);
      float v2 = strtof(q, &q);
      m->texcoords.push_back(u);
      m->texcoords.push_back(v2);
    } else if (c + 1 < line_end && c[0] == 'f' &&
               (c[1] == ' ' || c[1] == '\t')) {
      long np = (long)m->positions.size() / 3;
      long nn = (long)m->normals.size() / 3;
      long nt = (long)m->texcoords.size() / 2;
      int32_t pidx[64], nidx[64], tidx[64];
      int count = 0;
      const char* t = c + 2;
      while (count < 64) {
        t = skip_ws(t, line_end);
        if (t >= line_end || !(isdigit(*t) || *t == '-')) break;
        parse_corner(t, line_end, np, nn, nt, &pidx[count], &nidx[count],
                     &tidx[count]);
        ++count;
      }
      for (int k = 1; k + 1 < count; ++k) {  // fan triangulation
        m->tri_pos.push_back(pidx[0]);
        m->tri_pos.push_back(pidx[k]);
        m->tri_pos.push_back(pidx[k + 1]);
        m->tri_nrm.push_back(nidx[0]);
        m->tri_nrm.push_back(nidx[k]);
        m->tri_nrm.push_back(nidx[k + 1]);
        m->tri_tex.push_back(tidx[0]);
        m->tri_tex.push_back(tidx[k]);
        m->tri_tex.push_back(tidx[k + 1]);
        m->tri_mtl.push_back(cur_mtl);
      }
    }
    p = line_end + 1;
  }
  return m;
}

int64_t obj_num_positions(ObjMesh* m) { return (int64_t)m->positions.size() / 3; }
int64_t obj_num_normals(ObjMesh* m) { return (int64_t)m->normals.size() / 3; }
int64_t obj_num_texcoords(ObjMesh* m) { return (int64_t)m->texcoords.size() / 2; }
int64_t obj_num_tris(ObjMesh* m) { return (int64_t)m->tri_pos.size() / 3; }
void obj_copy_texcoords(ObjMesh* m, float* out) {
  memcpy(out, m->texcoords.data(), m->texcoords.size() * sizeof(float));
}
void obj_copy_tri_tex(ObjMesh* m, int32_t* out) {
  memcpy(out, m->tri_tex.data(), m->tri_tex.size() * sizeof(int32_t));
}
void obj_copy_positions(ObjMesh* m, float* out) {
  memcpy(out, m->positions.data(), m->positions.size() * sizeof(float));
}
void obj_copy_normals(ObjMesh* m, float* out) {
  memcpy(out, m->normals.data(), m->normals.size() * sizeof(float));
}
void obj_copy_tris(ObjMesh* m, int32_t* pos_out, int32_t* nrm_out) {
  memcpy(pos_out, m->tri_pos.data(), m->tri_pos.size() * sizeof(int32_t));
  memcpy(nrm_out, m->tri_nrm.data(), m->tri_nrm.size() * sizeof(int32_t));
}
void obj_copy_tri_mtl(ObjMesh* m, int32_t* out) {
  memcpy(out, m->tri_mtl.data(), m->tri_mtl.size() * sizeof(int32_t));
}
// Material / mtllib names as one '\n'-separated buffer each.
static std::string join_names(const std::vector<std::string>& v) {
  std::string s;
  for (size_t i = 0; i < v.size(); ++i) {
    if (i) s += '\n';
    s += v[i];
  }
  return s;
}
int64_t obj_mtl_names_len(ObjMesh* m) {
  return (int64_t)join_names(m->mtl_names).size();
}
void obj_copy_mtl_names(ObjMesh* m, char* out) {
  std::string s = join_names(m->mtl_names);
  memcpy(out, s.data(), s.size());
}
int64_t obj_mtllibs_len(ObjMesh* m) { return (int64_t)m->mtllibs.size(); }
void obj_copy_mtllibs(ObjMesh* m, char* out) {
  memcpy(out, m->mtllibs.data(), m->mtllibs.size());
}
void obj_free(ObjMesh* m) { delete m; }

// ---------------------------------------------------------------------------
// Binned-SAH BVH (flattened depth-first with skip links), optionally with
// SBVH-style spatial splits (triangle-reference duplication with clipped
// boxes; Stich et al. 2009 — implemented from the published algorithm).
//
// The builder works on REFERENCES: (triangle id, AABB). An object split
// partitions references by centroid; a spatial split may cut a straddling
// reference into two references whose boxes are the triangle clipped to
// either side of the plane. References only ever shrink, so every box stays
// conservative; leaves emit reference -> triangle ids (with duplicates),
// which downstream shading maps back to original triangles unchanged.
// ---------------------------------------------------------------------------

struct BvhBuilder {
  // outputs (see tpurt/bvh/reference.py CpuBVH for the matching layout)
  std::vector<float> bb_min, bb_max;     // 3 * num_nodes
  std::vector<int32_t> prim_start, prim_count, skip;
  std::vector<int32_t> order;            // leaf-run triangle ids (DFS order)
  // reference arrays (grow under spatial splits)
  std::vector<float> rmin, rmax;         // 3 * num_refs clipped boxes
  std::vector<int32_t> rtri;             // reference -> triangle id
  std::vector<float> tv;                 // 9 * num_tris triangle vertices
  int leaf_size = 4;
  float alpha = 2.0f;      // spatial-split overlap threshold (fraction of
                           // root area); >= 1 disables spatial splits
  size_t max_refs = 0;     // reference-duplication budget
  float root_area = 1.0f;
};

static inline float box_area(const float lo3[3], const float hi3[3]) {
  float d0 = std::max(hi3[0] - lo3[0], 0.f);
  float d1 = std::max(hi3[1] - lo3[1], 0.f);
  float d2 = std::max(hi3[2] - lo3[2], 0.f);
  return d0 * d1 + d1 * d2 + d2 * d0;
}

// AABB of the triangle polygon clipped to lo <= x[axis] <= hi, intersected
// with the reference box [cmin, cmax] (the ref may itself be a clip).
// Produces an empty box (mn > mx) when the clip vanishes.
static void clip_tri_slab(const float* v /*9 floats*/, int axis, float lo,
                          float hi, const float* cmin, const float* cmax,
                          float out_min[3], float out_max[3]) {
  float poly[2][8][3];
  int n = 3;
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 3; ++a) poly[0][i][a] = v[3 * i + a];
  int cur = 0;
  // Two Sutherland–Hodgman passes: keep x[axis] >= lo, then <= hi.
  for (int pass = 0; pass < 2; ++pass) {
    float plane = pass == 0 ? lo : hi;
    float sign = pass == 0 ? 1.f : -1.f;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const float* p = poly[cur][i];
      const float* q = poly[cur][(i + 1) % n];
      float dp = sign * (p[axis] - plane);
      float dq = sign * (q[axis] - plane);
      if (dp >= 0.f) {
        for (int a = 0; a < 3; ++a) poly[1 - cur][m][a] = p[a];
        ++m;
      }
      if ((dp >= 0.f) != (dq >= 0.f)) {
        float t = dp / (dp - dq);
        for (int a = 0; a < 3; ++a)
          poly[1 - cur][m][a] = p[a] + t * (q[a] - p[a]);
        poly[1 - cur][m][axis] = plane;  // exact on the clip plane
        ++m;
      }
    }
    cur = 1 - cur;
    n = m;
    if (n == 0) break;
  }
  for (int a = 0; a < 3; ++a) {
    out_min[a] = 3.4e38f;
    out_max[a] = -3.4e38f;
  }
  for (int i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      out_min[a] = std::min(out_min[a], poly[cur][i][a]);
      out_max[a] = std::max(out_max[a], poly[cur][i][a]);
    }
  for (int a = 0; a < 3; ++a) {  // stay inside the parent reference box
    out_min[a] = std::max(out_min[a], cmin[a]);
    out_max[a] = std::min(out_max[a], cmax[a]);
  }
}

static void emit(BvhBuilder* b, std::vector<int32_t>& refs) {
  const int NB = 16;
  size_t my = b->bb_min.size() / 3;
  float bmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  float bmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  float cmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  float cmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  size_t nrefs = refs.size();
  for (size_t i = 0; i < nrefs; ++i) {
    size_t r = (size_t)refs[i];
    for (int a = 0; a < 3; ++a) {
      float lo3 = b->rmin[3 * r + a], hi3 = b->rmax[3 * r + a];
      float c = 0.5f * (lo3 + hi3);
      bmin[a] = std::min(bmin[a], lo3);
      bmax[a] = std::max(bmax[a], hi3);
      cmin[a] = std::min(cmin[a], c);
      cmax[a] = std::max(cmax[a], c);
    }
  }
  for (int a = 0; a < 3; ++a) {
    b->bb_min.push_back(bmin[a]);
    b->bb_max.push_back(bmax[a]);
  }
  b->prim_start.push_back(-1);
  b->prim_count.push_back(0);
  b->skip.push_back(-1);

  float cext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
  int longest = cext[1] > cext[0] ? 1 : 0;
  if (cext[2] > cext[longest]) longest = 2;
  if (nrefs <= (size_t)b->leaf_size || cext[longest] <= 1e-12f) {
    b->prim_start[my] = (int32_t)b->order.size();
    b->prim_count[my] = (int32_t)nrefs;
    for (size_t i = 0; i < nrefs; ++i)
      b->order.push_back(b->rtri[(size_t)refs[i]]);
    b->skip[my] = (int32_t)my + 1;
    return;
  }

  // ---- Object split: binned SAH over reference centroids, all 3 axes.
  float obj_best = 3.4e38f;
  int obj_axis = -1;
  float obj_plane = 0.f;
  float obj_lmin[3], obj_lmax[3], obj_rmin[3], obj_rmax[3];
  for (int axis = 0; axis < 3; ++axis) {
    if (cext[axis] <= 1e-12f) continue;
    float inv = (float)NB / cext[axis];
    int32_t counts[NB] = {0};
    float bmins[NB][3], bmaxs[NB][3];
    for (int k = 0; k < NB; ++k)
      for (int a = 0; a < 3; ++a) {
        bmins[k][a] = 3.4e38f;
        bmaxs[k][a] = -3.4e38f;
      }
    for (size_t i = 0; i < nrefs; ++i) {
      size_t r = (size_t)refs[i];
      float c = 0.5f * (b->rmin[3 * r + axis] + b->rmax[3 * r + axis]);
      int k = (int)((c - cmin[axis]) * inv);
      k = std::min(std::max(k, 0), NB - 1);
      ++counts[k];
      for (int a = 0; a < 3; ++a) {
        bmins[k][a] = std::min(bmins[k][a], b->rmin[3 * r + a]);
        bmaxs[k][a] = std::max(bmaxs[k][a], b->rmax[3 * r + a]);
      }
    }
    // Suffix boxes/counts, then sweep splits left-to-right.
    float smin[NB][3], smax[NB][3];
    int32_t scnt[NB];
    for (int k = NB - 1; k >= 0; --k) {
      scnt[k] = counts[k] + (k + 1 < NB ? scnt[k + 1] : 0);
      for (int a = 0; a < 3; ++a) {
        smin[k][a] = bmins[k][a];
        smax[k][a] = bmaxs[k][a];
        if (k + 1 < NB) {
          smin[k][a] = std::min(smin[k][a], smin[k + 1][a]);
          smax[k][a] = std::max(smax[k][a], smax[k + 1][a]);
        }
      }
    }
    float lmin[3] = {3.4e38f, 3.4e38f, 3.4e38f},
          lmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    int32_t nl = 0;
    for (int k = 1; k < NB; ++k) {
      nl += counts[k - 1];
      for (int a = 0; a < 3; ++a) {
        lmin[a] = std::min(lmin[a], bmins[k - 1][a]);
        lmax[a] = std::max(lmax[a], bmaxs[k - 1][a]);
      }
      int32_t nr = scnt[k];
      if (!nl || !nr) continue;
      float cost = nl * box_area(lmin, lmax) + nr * box_area(smin[k], smax[k]);
      if (cost < obj_best) {
        obj_best = cost;
        obj_axis = axis;
        obj_plane = cmin[axis] + (float)k / inv;
        for (int a = 0; a < 3; ++a) {
          obj_lmin[a] = lmin[a];
          obj_lmax[a] = lmax[a];
          obj_rmin[a] = smin[k][a];
          obj_rmax[a] = smax[k][a];
        }
      }
    }
  }

  // ---- Spatial split (SBVH): only when the object split's children
  // overlap more than alpha * root area, and the budget allows growth.
  float sp_best = 3.4e38f;
  int sp_axis = -1;
  float sp_plane = 0.f;
  bool try_spatial = false;
  if (obj_axis >= 0 && b->alpha < 1.0f &&
      b->rtri.size() + nrefs / 8 + 8 < b->max_refs) {
    float olap_min[3], olap_max[3];
    for (int a = 0; a < 3; ++a) {
      olap_min[a] = std::max(obj_lmin[a], obj_rmin[a]);
      olap_max[a] = std::min(obj_lmax[a], obj_rmax[a]);
    }
    bool nonempty = olap_min[0] <= olap_max[0] &&
                    olap_min[1] <= olap_max[1] && olap_min[2] <= olap_max[2];
    try_spatial =
        nonempty && box_area(olap_min, olap_max) > b->alpha * b->root_area;
  }
  if (try_spatial) {
    for (int axis = 0; axis < 3; ++axis) {
      float ext = bmax[axis] - bmin[axis];
      if (ext <= 1e-12f) continue;
      float inv = (float)NB / ext;
      int32_t enter[NB] = {0}, leave[NB] = {0};
      float gmins[NB][3], gmaxs[NB][3];
      for (int k = 0; k < NB; ++k)
        for (int a = 0; a < 3; ++a) {
          gmins[k][a] = 3.4e38f;
          gmaxs[k][a] = -3.4e38f;
        }
      for (size_t i = 0; i < nrefs; ++i) {
        size_t r = (size_t)refs[i];
        int b0 = (int)((b->rmin[3 * r + axis] - bmin[axis]) * inv);
        int b1 = (int)((b->rmax[3 * r + axis] - bmin[axis]) * inv);
        b0 = std::min(std::max(b0, 0), NB - 1);
        b1 = std::min(std::max(b1, b0), NB - 1);
        ++enter[b0];
        ++leave[b1];
        if (b0 == b1) {
          for (int a = 0; a < 3; ++a) {
            gmins[b0][a] = std::min(gmins[b0][a], b->rmin[3 * r + a]);
            gmaxs[b0][a] = std::max(gmaxs[b0][a], b->rmax[3 * r + a]);
          }
        } else {
          const float* tri = &b->tv[9 * (size_t)b->rtri[r]];
          for (int k = b0; k <= b1; ++k) {
            float lo = bmin[axis] + (float)k / inv;
            float hi = bmin[axis] + (float)(k + 1) / inv;
            float cb_min[3], cb_max[3];
            clip_tri_slab(tri, axis, lo, hi, &b->rmin[3 * r],
                          &b->rmax[3 * r], cb_min, cb_max);
            if (cb_min[0] > cb_max[0] || cb_min[1] > cb_max[1] ||
                cb_min[2] > cb_max[2])
              continue;
            for (int a = 0; a < 3; ++a) {
              gmins[k][a] = std::min(gmins[k][a], cb_min[a]);
              gmaxs[k][a] = std::max(gmaxs[k][a], cb_max[a]);
            }
          }
        }
      }
      float smin[NB][3], smax[NB][3];
      int32_t scnt[NB];
      for (int k = NB - 1; k >= 0; --k) {
        scnt[k] = leave[k] + (k + 1 < NB ? scnt[k + 1] : 0);
        for (int a = 0; a < 3; ++a) {
          smin[k][a] = gmins[k][a];
          smax[k][a] = gmaxs[k][a];
          if (k + 1 < NB) {
            smin[k][a] = std::min(smin[k][a], smin[k + 1][a]);
            smax[k][a] = std::max(smax[k][a], smax[k + 1][a]);
          }
        }
      }
      float lmin[3] = {3.4e38f, 3.4e38f, 3.4e38f},
            lmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
      int32_t nl = 0;
      for (int k = 1; k < NB; ++k) {
        nl += enter[k - 1];
        for (int a = 0; a < 3; ++a) {
          lmin[a] = std::min(lmin[a], gmins[k - 1][a]);
          lmax[a] = std::max(lmax[a], gmaxs[k - 1][a]);
        }
        // nl counts refs ENTERING left of k (straddlers included);
        // nr counts refs EXITING at or right of k (straddlers included) —
        // the chopped-binning accounting for duplicated references.
        int32_t nr = scnt[k];
        if (!nl || !nr) continue;
        float cost =
            nl * box_area(lmin, lmax) + nr * box_area(smin[k], smax[k]);
        if (cost < sp_best) {
          sp_best = cost;
          sp_axis = axis;
          sp_plane = bmin[axis] + (float)k / inv;
        }
      }
    }
  }

  std::vector<int32_t> lvec, rvec;
  lvec.reserve(nrefs / 2);
  rvec.reserve(nrefs / 2);
  if (sp_axis >= 0 && sp_best < obj_best) {
    // Spatial partition with reference duplication.
    for (size_t i = 0; i < nrefs; ++i) {
      size_t r = (size_t)refs[i];
      float lo3 = b->rmin[3 * r + sp_axis], hi3 = b->rmax[3 * r + sp_axis];
      if (hi3 <= sp_plane) {
        lvec.push_back((int32_t)r);
      } else if (lo3 >= sp_plane) {
        rvec.push_back((int32_t)r);
      } else {
        const float* tri = &b->tv[9 * (size_t)b->rtri[r]];
        float lb_min[3], lb_max[3], rb_min[3], rb_max[3];
        clip_tri_slab(tri, sp_axis, -3.4e38f, sp_plane, &b->rmin[3 * r],
                      &b->rmax[3 * r], lb_min, lb_max);
        clip_tri_slab(tri, sp_axis, sp_plane, 3.4e38f, &b->rmin[3 * r],
                      &b->rmax[3 * r], rb_min, rb_max);
        bool lok = lb_min[0] <= lb_max[0] && lb_min[1] <= lb_max[1] &&
                   lb_min[2] <= lb_max[2];
        bool rok = rb_min[0] <= rb_max[0] && rb_min[1] <= rb_max[1] &&
                   rb_min[2] <= rb_max[2];
        if (lok && rok && b->rtri.size() < b->max_refs) {
          // shrink r to the left part, append a new ref for the right
          for (int a = 0; a < 3; ++a) {
            b->rmin[3 * r + a] = lb_min[a];
            b->rmax[3 * r + a] = lb_max[a];
          }
          int32_t nr2 = (int32_t)b->rtri.size();
          b->rtri.push_back(b->rtri[r]);
          for (int a = 0; a < 3; ++a) {
            b->rmin.push_back(rb_min[a]);
            b->rmax.push_back(rb_max[a]);
          }
          lvec.push_back((int32_t)r);
          rvec.push_back(nr2);
        } else if (lok && !rok) {
          lvec.push_back((int32_t)r);
        } else if (rok && !lok) {
          rvec.push_back((int32_t)r);
        } else {
          // budget exhausted (or degenerate): keep whole ref on the side
          // holding more of its extent
          if (sp_plane - lo3 >= hi3 - sp_plane)
            lvec.push_back((int32_t)r);
          else
            rvec.push_back((int32_t)r);
        }
      }
    }
  }
  if (lvec.empty() || rvec.empty()) {
    lvec.clear();
    rvec.clear();
    if (obj_axis >= 0) {
      for (size_t i = 0; i < nrefs; ++i) {
        size_t r = (size_t)refs[i];
        float c = 0.5f * (b->rmin[3 * r + obj_axis] +
                          b->rmax[3 * r + obj_axis]);
        (c < obj_plane ? lvec : rvec).push_back((int32_t)r);
      }
    }
    if (lvec.empty() || rvec.empty()) {
      // median fallback on the longest centroid axis
      lvec.clear();
      rvec.clear();
      std::vector<int32_t> tmp(refs);
      size_t mid = nrefs / 2;
      std::nth_element(
          tmp.begin(), tmp.begin() + (long)mid, tmp.end(),
          [&](int32_t x, int32_t y) {
            return b->rmin[3 * (size_t)x + longest] +
                       b->rmax[3 * (size_t)x + longest] <
                   b->rmin[3 * (size_t)y + longest] +
                       b->rmax[3 * (size_t)y + longest];
          });
      lvec.assign(tmp.begin(), tmp.begin() + (long)mid);
      rvec.assign(tmp.begin() + (long)mid, tmp.end());
    }
  }
  refs.clear();
  refs.shrink_to_fit();  // bound peak memory on deep recursions
  emit(b, lvec);
  lvec.clear();
  lvec.shrink_to_fit();
  emit(b, rvec);
  b->skip[my] = (int32_t)(b->bb_min.size() / 3);
}

static BvhBuilder* build_common(const float* vertices, const int32_t* indices,
                                int64_t num_tris, int32_t leaf_size,
                                float alpha, float budget_factor) {
  BvhBuilder* b = new BvhBuilder();
  b->leaf_size = leaf_size;
  b->alpha = alpha;
  b->max_refs = (size_t)((double)num_tris * (double)budget_factor) + 8;
  b->rmin.resize(3 * (size_t)num_tris);
  b->rmax.resize(3 * (size_t)num_tris);
  b->rtri.resize((size_t)num_tris);
  b->tv.resize(9 * (size_t)num_tris);
  float root_lo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  float root_hi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  std::vector<int32_t> refs((size_t)num_tris);
  for (int64_t t = 0; t < num_tris; ++t) {
    refs[(size_t)t] = (int32_t)t;
    b->rtri[(size_t)t] = (int32_t)t;
    for (int a = 0; a < 3; ++a) {
      float v0 = vertices[3 * (size_t)indices[3 * t] + a];
      float v1 = vertices[3 * (size_t)indices[3 * t + 1] + a];
      float v2 = vertices[3 * (size_t)indices[3 * t + 2] + a];
      b->tv[9 * (size_t)t + a] = v0;
      b->tv[9 * (size_t)t + 3 + a] = v1;
      b->tv[9 * (size_t)t + 6 + a] = v2;
      float lo3 = std::min(v0, std::min(v1, v2));
      float hi3 = std::max(v0, std::max(v1, v2));
      b->rmin[3 * (size_t)t + a] = lo3;
      b->rmax[3 * (size_t)t + a] = hi3;
      root_lo[a] = std::min(root_lo[a], lo3);
      root_hi[a] = std::max(root_hi[a], hi3);
    }
  }
  b->root_area = std::max(box_area(root_lo, root_hi), 1e-20f);
  b->order.reserve(b->max_refs);
  emit(b, refs);
  return b;
}

BvhBuilder* bvh_build(const float* vertices, int64_t /*num_vertices*/,
                      const int32_t* indices, int64_t num_tris,
                      int32_t leaf_size) {
  return build_common(vertices, indices, num_tris, leaf_size,
                      /*alpha=*/2.0f, /*budget_factor=*/1.0f);
}

BvhBuilder* bvh_build_sbvh(const float* vertices, int64_t /*num_vertices*/,
                           const int32_t* indices, int64_t num_tris,
                           int32_t leaf_size, float alpha,
                           float budget_factor) {
  return build_common(vertices, indices, num_tris, leaf_size, alpha,
                      budget_factor);
}

int64_t bvh_num_nodes(BvhBuilder* b) { return (int64_t)b->prim_count.size(); }
int64_t bvh_num_refs(BvhBuilder* b) { return (int64_t)b->order.size(); }
void bvh_copy(BvhBuilder* b, float* bb_min, float* bb_max,
              int32_t* prim_start, int32_t* prim_count, int32_t* skip,
              int32_t* order) {
  memcpy(bb_min, b->bb_min.data(), b->bb_min.size() * sizeof(float));
  memcpy(bb_max, b->bb_max.data(), b->bb_max.size() * sizeof(float));
  memcpy(prim_start, b->prim_start.data(),
         b->prim_start.size() * sizeof(int32_t));
  memcpy(prim_count, b->prim_count.data(),
         b->prim_count.size() * sizeof(int32_t));
  memcpy(skip, b->skip.data(), b->skip.size() * sizeof(int32_t));
  memcpy(order, b->order.data(), b->order.size() * sizeof(int32_t));
}
void bvh_free(BvhBuilder* b) { delete b; }

}  // extern "C"
