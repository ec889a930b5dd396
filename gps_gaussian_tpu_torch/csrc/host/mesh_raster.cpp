// Offline textured-mesh rasterizer (C++17, std::thread).
//
// Native equivalent of the reference's vendored taichi_three renderer
// (prepare_data/taichi_three/geometry.py:7-83, scene.py:65-73): perspective
// projection, backface cull, barycentric triangle fill with an INVERSE-z
// z-buffer (the whole pipeline's depth convention, SURVEY.md §3.5),
// texture bilerp or vertex colors, lambert shading with directional lights.
//
// Parallelism: triangles are partitioned across threads, each rendering
// into its own framebuffer; buffers merge by inverse-z (ties keep the
// lowest thread id -> deterministic output).  C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 normalize(Vec3 a) {
  float n = std::sqrt(dot(a, a)) + 1e-12f;
  return {a.x / n, a.y / n, a.z / n};
}

struct Buffers {
  std::vector<float> rgb;    // h*w*3
  std::vector<float> invz;   // h*w
  std::vector<float> normal; // h*w*3
};

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(std::min(n, 16u));
}

}  // namespace

extern "C" {

// verts: (nv, 3) world f32; faces: (nf, 3) i32;
// vert_color: (nv, 3) f32 (albedo; if tex != nullptr, sampled instead);
// uv: (nv, 2) f32 or nullptr; tex: (th, tw, 3) f32 or nullptr;
// K: (3, 3) f32 row-major; E: (3, 4) f32 world->cam;
// lights: (nl, 6) f32 rows [dir_xyz, color_rgb];  ambient: scalar;
// out_rgb: (h, w, 3) f32; out_invz: (h, w) f32; out_mask: (h, w) u8;
// out_normal: (h, w, 3) f32 (camera-space shading normals).
void rasterize_mesh(const float* verts, int nv, const int32_t* faces, int nf,
                    const float* vert_color, const float* uv,
                    const float* tex, int th, int tw, const float* K,
                    const float* E, const float* lights, int nl,
                    float ambient, int h, int w, float* out_rgb,
                    float* out_invz, uint8_t* out_mask, float* out_normal) {
  // project all vertices once: cam = E * [p;1], screen via K
  std::vector<float> sx(nv), sy(nv), sz(nv);
  for (int i = 0; i < nv; ++i) {
    const float* p = verts + 3 * i;
    float cx = E[0] * p[0] + E[1] * p[1] + E[2] * p[2] + E[3];
    float cy = E[4] * p[0] + E[5] * p[1] + E[6] * p[2] + E[7];
    float cz = E[8] * p[0] + E[9] * p[1] + E[10] * p[2] + E[11];
    sz[i] = cz;
    float iz = 1.0f / (cz > 1e-6f ? cz : 1e-6f);
    sx[i] = (K[0] * cx + K[2] * cz) * iz;
    sy[i] = (K[4] * cy + K[5] * cz) * iz;
  }

  int nt = std::min(hardware_threads(), std::max(nf, 1));
  std::vector<Buffers> bufs(nt);
  size_t npx = static_cast<size_t>(h) * w;
  for (auto& b : bufs) {
    b.rgb.assign(npx * 3, 0.f);
    b.invz.assign(npx, 0.f);
    b.normal.assign(npx * 3, 0.f);
  }

  auto shade = [&](Vec3 n, const float* albedo, float* out) {
    float r = ambient, g = ambient, b = ambient;
    for (int l = 0; l < nl; ++l) {
      const float* L = lights + 6 * l;
      Vec3 ld = normalize({L[0], L[1], L[2]});
      float lam = std::max(0.f, dot(n, ld));
      r += lam * L[3];
      g += lam * L[4];
      b += lam * L[5];
    }
    out[0] = std::min(1.f, albedo[0] * r);
    out[1] = std::min(1.f, albedo[1] * g);
    out[2] = std::min(1.f, albedo[2] * b);
  };

  auto raster_range = [&](int t, int f0, int f1) {
    Buffers& B = bufs[t];
    for (int f = f0; f < f1; ++f) {
      int ia = faces[3 * f], ib = faces[3 * f + 1], ic = faces[3 * f + 2];
      if (sz[ia] <= 1e-6f || sz[ib] <= 1e-6f || sz[ic] <= 1e-6f) continue;
      float ax = sx[ia], ay = sy[ia];
      float bx = sx[ib], by = sy[ib];
      float cx = sx[ic], cy = sy[ic];
      float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      if (std::fabs(area) < 1e-12f) continue;

      // world-space geometric normal for shading
      Vec3 pa{verts[3 * ia], verts[3 * ia + 1], verts[3 * ia + 2]};
      Vec3 pb{verts[3 * ib], verts[3 * ib + 1], verts[3 * ib + 2]};
      Vec3 pc{verts[3 * ic], verts[3 * ic + 1], verts[3 * ic + 2]};
      Vec3 nrm = normalize(cross(sub(pb, pa), sub(pc, pa)));

      int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
      int x1 = std::min(w - 1, (int)std::ceil(std::max({ax, bx, cx})));
      int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy})));
      int y1 = std::min(h - 1, (int)std::ceil(std::max({ay, by, cy})));
      float inv_area = 1.0f / area;
      float iza = 1.0f / sz[ia], izb = 1.0f / sz[ib], izc = 1.0f / sz[ic];

      for (int y = y0; y <= y1; ++y) {
        for (int x = x0; x <= x1; ++x) {
          float px = x + 0.5f, py = y + 0.5f;
          float w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv_area;
          float w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv_area;
          float w2 = 1.0f - w0 - w1;
          if (w0 < 0 || w1 < 0 || w2 < 0) continue;
          // perspective-correct inverse depth
          float iz = w0 * iza + w1 * izb + w2 * izc;
          size_t pix = static_cast<size_t>(y) * w + x;
          if (iz <= B.invz[pix]) continue;
          B.invz[pix] = iz;

          // perspective-correct attribute weights
          float q0 = w0 * iza / iz, q1 = w1 * izb / iz, q2 = w2 * izc / iz;
          float albedo[3];
          if (tex != nullptr && uv != nullptr) {
            float u = q0 * uv[2 * ia] + q1 * uv[2 * ib] + q2 * uv[2 * ic];
            float v = q0 * uv[2 * ia + 1] + q1 * uv[2 * ib + 1] +
                      q2 * uv[2 * ic + 1];
            // wrap + bilerp (v up -> texture row down)
            u = u - std::floor(u);
            v = v - std::floor(v);
            float fx = u * (tw - 1), fy = (1.f - v) * (th - 1);
            int tx0 = (int)fx, ty0 = (int)fy;
            int tx1 = std::min(tw - 1, tx0 + 1);
            int ty1 = std::min(th - 1, ty0 + 1);
            float axx = fx - tx0, ayy = fy - ty0;
            for (int k = 0; k < 3; ++k) {
              float v00 = tex[(ty0 * tw + tx0) * 3 + k];
              float v01 = tex[(ty0 * tw + tx1) * 3 + k];
              float v10 = tex[(ty1 * tw + tx0) * 3 + k];
              float v11 = tex[(ty1 * tw + tx1) * 3 + k];
              albedo[k] = (v00 * (1 - axx) + v01 * axx) * (1 - ayy) +
                          (v10 * (1 - axx) + v11 * axx) * ayy;
            }
          } else {
            for (int k = 0; k < 3; ++k) {
              albedo[k] = q0 * vert_color[3 * ia + k] +
                          q1 * vert_color[3 * ib + k] +
                          q2 * vert_color[3 * ic + k];
            }
          }
          shade(nrm, albedo, &B.rgb[pix * 3]);
          B.normal[pix * 3] = nrm.x;
          B.normal[pix * 3 + 1] = nrm.y;
          B.normal[pix * 3 + 2] = nrm.z;
        }
      }
    }
  };

  std::vector<std::thread> ts;
  int chunk = (nf + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int f0 = t * chunk, f1 = std::min(nf, f0 + chunk);
    if (f0 >= f1) break;
    ts.emplace_back(raster_range, t, f0, f1);
  }
  for (auto& t : ts) t.join();

  // deterministic merge: max inverse-z wins, ties -> lowest thread id
  for (size_t pix = 0; pix < npx; ++pix) {
    float best = 0.f;
    int bt = -1;
    for (int t = 0; t < (int)bufs.size(); ++t) {
      if (bufs[t].invz[pix] > best) {
        best = bufs[t].invz[pix];
        bt = t;
      }
    }
    out_invz[pix] = best;
    out_mask[pix] = bt >= 0 ? 255 : 0;
    for (int k = 0; k < 3; ++k) {
      out_rgb[pix * 3 + k] = bt >= 0 ? bufs[bt].rgb[pix * 3 + k] : 0.f;
      out_normal[pix * 3 + k] = bt >= 0 ? bufs[bt].normal[pix * 3 + k] : 0.f;
    }
  }
}

}  // extern "C"
