// Host-side image kernels for the data pipeline (C++17, std::thread).
//
// A copy of native/src/image_ops.cpp for gps_gaussian_tpu_torch/native.py:
// built with the same flags, it gives the same bits.
//
// Native equivalent of the cv2 calls on the reference's rectification hot
// path (lib/human_loader.py:278-308): bilinear remap with zero border and
// 3x3 erosion.  Exposed through a C ABI for ctypes (no pybind11 in the
// image).  All functions are deterministic; threading partitions output
// rows, so there are no write conflicts.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(std::min(n, 16u));
}

template <typename F>
void parallel_rows(int rows, F&& fn) {
  int nt = std::min(hardware_threads(), rows);
  if (nt <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int y0 = t * chunk;
    int y1 = std::min(rows, y0 + chunk);
    if (y0 >= y1) break;
    ts.emplace_back([=, &fn] { fn(y0, y1); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Bilinear remap, zero border (cv2.remap INTER_LINEAR semantics).
// src: (h, w, c) f32 row-major; map_x/map_y: (oh, ow) f32 source coords;
// dst: (oh, ow, c) f32.
void remap_bilinear_f32(const float* src, int h, int w, int c,
                        const float* map_x, const float* map_y, int oh,
                        int ow, float* dst) {
  parallel_rows(oh, [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      for (int x = 0; x < ow; ++x) {
        float sx = map_x[y * ow + x];
        float sy = map_y[y * ow + x];
        float fx0 = std::floor(sx);
        float fy0 = std::floor(sy);
        int x0 = static_cast<int>(fx0);
        int y0i = static_cast<int>(fy0);
        float ax = sx - fx0;
        float ay = sy - fy0;
        float* out = dst + (static_cast<size_t>(y) * ow + x) * c;
        for (int k = 0; k < c; ++k) out[k] = 0.f;
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            int xx = x0 + dx;
            int yy = y0i + dy;
            if (xx < 0 || xx >= w || yy < 0 || yy >= h) continue;
            float wgt = (dx ? ax : 1.f - ax) * (dy ? ay : 1.f - ay);
            const float* p = src + (static_cast<size_t>(yy) * w + xx) * c;
            for (int k = 0; k < c; ++k) out[k] += wgt * p[k];
          }
        }
      }
    }
  });
}

// 3x3 erosion (local min), border treated as +inf (cv2.erode default).
// src/dst: (h, w) f32.
void erode3x3_f32(const float* src, int h, int w, float* dst) {
  parallel_rows(h, [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      for (int x = 0; x < w; ++x) {
        float m = src[y * w + x];
        for (int dy = -1; dy <= 1; ++dy) {
          int yy = y + dy;
          if (yy < 0 || yy >= h) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            int xx = x + dx;
            if (xx < 0 || xx >= w) continue;
            m = std::min(m, src[yy * w + xx]);
          }
        }
        dst[y * w + x] = m;
      }
    }
  });
}

}  // extern "C"
