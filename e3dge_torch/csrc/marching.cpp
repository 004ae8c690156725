// Marching tetrahedra for the mesh export of the PyTorch port
// (e3dge_torch/utils/mesh.py), the port's own copy of the JAX package's
// e3dge_tpu/native/marching.cpp (march_tetrahedra only).
//
// The reference extracts meshes with scikit-image marching cubes on the CPU
// (project/utils/mesh_utils.py:48-69). Here the SDF grid comes from the field
// kernel (VolumeFeatureRenderer.render_sdf_grid) and this host code extracts
// the surface: each grid cell is split into 6 tetrahedra whose iso-crossings
// are triangulated by linear interpolation. No case tables are needed and the
// surface is watertight.
//
// C ABI (ctypes): march_tetrahedra(...) returns a triangle soup; the Python
// side welds the vertices and writes .obj. Built with the host C++ compiler
// at first use into e3dge_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp_edge(const V3& p0, const V3& p1, float v0, float v1, float iso) {
  float denom = v1 - v0;
  float t = (std::fabs(denom) < 1e-12f) ? 0.5f : (iso - v0) / denom;
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return V3{p0.x + t * (p1.x - p0.x), p0.y + t * (p1.y - p0.y),
            p0.z + t * (p1.z - p0.z)};
}

// The 6-tetrahedra decomposition of a unit cube (indices into the cube's 8
// corners, consistent winding).
constexpr int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// Cube corner offsets (x, y, z).
constexpr int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

}  // namespace

extern "C" {

// sdf: nx*ny*nz floats, C order: index = (x * ny + y) * nz + z.
// out_verts: capacity 3*max_tris vertices (9*max_tris floats).
// Returns number of triangles written (3 consecutive verts per triangle), or -1
// if capacity was exceeded.
int64_t march_tetrahedra(const float* sdf, int64_t nx, int64_t ny, int64_t nz,
                         float iso, float* out_verts, int64_t max_tris) {
  int64_t ntri = 0;
  auto val = [&](int64_t x, int64_t y, int64_t z) -> float {
    return sdf[(x * ny + y) * nz + z];
  };

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        float v[8];
        V3 p[8];
        bool all_pos = true, all_neg = true;
        for (int c = 0; c < 8; ++c) {
          int64_t cx = x + kCorner[c][0];
          int64_t cy = y + kCorner[c][1];
          int64_t cz = z + kCorner[c][2];
          v[c] = val(cx, cy, cz);
          p[c] = V3{(float)cx, (float)cy, (float)cz};
          if (v[c] < iso) all_pos = false;
          if (v[c] >= iso) all_neg = false;
        }
        if (all_pos || all_neg) continue;

        for (const auto& tet : kTets) {
          int idx[4] = {tet[0], tet[1], tet[2], tet[3]};
          // classify corners
          int inside = 0;
          bool in[4];
          for (int i = 0; i < 4; ++i) {
            in[i] = v[idx[i]] < iso;
            inside += in[i];
          }
          if (inside == 0 || inside == 4) continue;

          // order so that "inside" corners come first
          int ord[4];
          int a = 0, b = 3;
          for (int i = 0; i < 4; ++i) {
            if (in[i]) ord[a++] = idx[i];
            else ord[b--] = idx[i];
          }

          V3 tri[6];
          int tri_count = 0;
          if (inside == 1) {
            // one inside (ord[0]); triangle across the three edges
            tri[0] = lerp_edge(p[ord[0]], p[ord[1]], v[ord[0]], v[ord[1]], iso);
            tri[1] = lerp_edge(p[ord[0]], p[ord[2]], v[ord[0]], v[ord[2]], iso);
            tri[2] = lerp_edge(p[ord[0]], p[ord[3]], v[ord[0]], v[ord[3]], iso);
            tri_count = 1;
          } else if (inside == 3) {
            // one outside (ord[3])
            tri[0] = lerp_edge(p[ord[3]], p[ord[0]], v[ord[3]], v[ord[0]], iso);
            tri[1] = lerp_edge(p[ord[3]], p[ord[1]], v[ord[3]], v[ord[1]], iso);
            tri[2] = lerp_edge(p[ord[3]], p[ord[2]], v[ord[3]], v[ord[2]], iso);
            tri_count = 1;
          } else {  // inside == 2: quad across four edges -> two triangles
            V3 e00 = lerp_edge(p[ord[0]], p[ord[2]], v[ord[0]], v[ord[2]], iso);
            V3 e01 = lerp_edge(p[ord[0]], p[ord[3]], v[ord[0]], v[ord[3]], iso);
            V3 e10 = lerp_edge(p[ord[1]], p[ord[2]], v[ord[1]], v[ord[2]], iso);
            V3 e11 = lerp_edge(p[ord[1]], p[ord[3]], v[ord[1]], v[ord[3]], iso);
            tri[0] = e00; tri[1] = e01; tri[2] = e11;
            tri[3] = e00; tri[4] = e11; tri[5] = e10;
            tri_count = 2;
          }

          for (int t = 0; t < tri_count; ++t) {
            if (ntri >= max_tris) return -1;
            std::memcpy(out_verts + ntri * 9, &tri[t * 3], 9 * sizeof(float));
            ++ntri;
          }
        }
      }
    }
  }
  return ntri;
}

}  // extern "C"
