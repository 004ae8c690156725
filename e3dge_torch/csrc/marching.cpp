// Marching tetrahedra for the mesh export of the PyTorch port
// and the z-buffer rasterizer of the depth-mesh and projected-noise videos
// (e3dge_torch/utils/mesh.py), the port's own copy of the JAX package's
// e3dge_tpu/native/marching.cpp.
//
// The reference extracts meshes with scikit-image marching cubes on the CPU
// (project/utils/mesh_utils.py:48-69). Here the SDF grid comes from the field
// kernel (VolumeFeatureRenderer.render_sdf_grid) and this host code extracts
// the surface: each grid cell is split into 6 tetrahedra whose iso-crossings
// are triangulated by linear interpolation. No case tables are needed and the
// surface is watertight.
//
// C ABI (ctypes): march_tetrahedra(...) returns a triangle soup; the Python
// side welds the vertices and writes .obj. rasterize(...) fills a color and
// a depth image. Built with the host C++ compiler
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

// ---------------------------------------------------------------------------
// Z-buffered triangle rasterizer for the noise projection and the depth mesh.
//
// The reference renders meshes with pytorch3d: the marching-cubes mesh to
// re-project a fixed per-vertex noise texture into each view
// (project/models/stylesdf_model.py:423-457, utils/mesh_utils.py:145-219) and
// the Phong-shaded depth mesh (trainer.py:2251-2346). Here: screen-space
// verts + per-vertex scalar -> barycentric-interpolated color and depth
// images; the port's copy of e3dge_tpu/native/marching.cpp:135-197.
// e3dge_torch/utils/mesh.py::rasterize_reference is its plain numpy version,
// equal bit for bit (built with -ffp-contract=off: no fused multiply-adds).
//
// verts: [V, 3] (x_pix, y_pix, depth), faces: [F, 3], color: [V]
// out_color/out_depth: [H, W]; background: color 0, depth 0 (invalid).
int64_t rasterize(const float* verts, int64_t n_verts, const int32_t* faces,
                  int64_t n_faces, const float* color, int64_t height,
                  int64_t width, float* out_color, float* out_depth) {
  for (int64_t i = 0; i < height * width; ++i) {
    out_color[i] = 0.f;
    out_depth[i] = 0.f;
  }
  // z-buffer holds nearest depth (smaller = closer)
  std::vector<float> zbuf((size_t)(height * width), 1e30f);

  for (int64_t f = 0; f < n_faces; ++f) {
    int32_t i0 = faces[f * 3], i1 = faces[f * 3 + 1], i2 = faces[f * 3 + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n_verts || i1 >= n_verts ||
        i2 >= n_verts)
      continue;
    float x0 = verts[i0 * 3], y0 = verts[i0 * 3 + 1], z0 = verts[i0 * 3 + 2];
    float x1 = verts[i1 * 3], y1 = verts[i1 * 3 + 1], z1 = verts[i1 * 3 + 2];
    float x2 = verts[i2 * 3], y2 = verts[i2 * 3 + 1], z2 = verts[i2 * 3 + 2];

    float minx = std::fmin(x0, std::fmin(x1, x2));
    float maxx = std::fmax(x0, std::fmax(x1, x2));
    float miny = std::fmin(y0, std::fmin(y1, y2));
    float maxy = std::fmax(y0, std::fmax(y1, y2));
    int64_t px0 = std::max<int64_t>(0, (int64_t)std::floor(minx));
    int64_t px1 = std::min<int64_t>(width - 1, (int64_t)std::ceil(maxx));
    int64_t py0 = std::max<int64_t>(0, (int64_t)std::floor(miny));
    int64_t py1 = std::min<int64_t>(height - 1, (int64_t)std::ceil(maxy));
    if (px0 > px1 || py0 > py1) continue;

    float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;

    for (int64_t py = py0; py <= py1; ++py) {
      for (int64_t px = px0; px <= px1; ++px) {
        float x = px + 0.5f, y = py + 0.5f;
        float w0 = ((y1 - y2) * (x - x2) + (x2 - x1) * (y - y2)) / denom;
        float w1 = ((y2 - y0) * (x - x2) + (x0 - x2) * (y - y2)) / denom;
        float w2 = 1.f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        float z = w0 * z0 + w1 * z1 + w2 * z2;
        size_t idx = (size_t)(py * width + px);
        if (z < zbuf[idx]) {
          zbuf[idx] = z;
          out_depth[idx] = z;
          out_color[idx] = w0 * color[i0] + w1 * color[i1] + w2 * color[i2];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
