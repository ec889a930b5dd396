// Online rectification of one source view in one pass (C++17, std::thread),
// for gps_gaussian_tpu_torch/native.py `rectify_view`.
//
// Takes a decoded 8-bit image and mask straight to the network's input. For
// each rectified pixel it computes the source coordinate (what
// geometry/stereo.py `rectify_map` computes, in f64, cast to f32), samples
// the image and the mask with the taps of image_ops.cpp `remap_bilinear_f32`
// (zero border, f32 weights, each weighted tap fused into the sum, in the
// same order), rounds the image to the nearest 8-bit level, and normalises
// as data/thuman.py did after those remaps:
//
//   img  = (2 * (v / 255) - 1) * (m / 255)      v: the rounded image level
//   mask = (m / 255 >= 0.5)                      m: the mask, unrounded
//
// The result is the composition's (maps, two remaps, the NumPy
// normalisation) bit for bit, with no map, no f32 copy of the source and no
// full-size intermediate array. Contraction is off in this file: every
// product and sum rounds on its own as NumPy's do, and the only fused
// operations are the explicit std::fma calls. Rows are split over threads;
// there are no write conflicts.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
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

// Row r of iR @ [u, v, 1] as NumPy's f64 matmul rounds it (OpenBLAS dgemm:
// the first product rounded, the second fused into it, then the constant).
inline double ray(const double* a, double u, double v) {
  return std::fma(a[1], v, a[0] * u) + a[2];
}

// Output rows [y0, y1) of one view, in three passes a row: the source
// coordinates (a loop the compiler vectorises), the taps, and the rounding
// and normalisation (vectorised too). C is the channel count where it is
// known at compile time (0: cc).
template <int C>
void rectify_rows(const uint8_t* img, const uint8_t* mask, int h, int w,
                  int cc, const double* i_r, const double* k_src, int ow,
                  float* out_img, float* out_mask, int y0, int y1) {
  const int c = C > 0 ? C : cc;
  std::vector<float> sxs(ow), sys(ow), ms(ow);
  std::vector<float> accs(static_cast<size_t>(ow) * c);
  for (int y = y0; y < y1; ++y) {
    const double v = y;
    for (int x = 0; x < ow; ++x) {
      const double u = x;
      const double q0 = ray(i_r, u, v);
      const double q1 = ray(i_r + 3, u, v);
      const double q2 = ray(i_r + 6, u, v);
      sxs[x] = static_cast<float>(q0 / q2 * k_src[0] + k_src[2]);
      sys[x] = static_cast<float>(q1 / q2 * k_src[4] + k_src[5]);
    }
    for (int x = 0; x < ow; ++x) {
      const float fx0 = std::floor(sxs[x]);
      const float fy0 = std::floor(sys[x]);
      const int x0 = static_cast<int>(fx0);
      const int y0i = static_cast<int>(fy0);
      const float ax = sxs[x] - fx0;
      const float ay = sys[x] - fy0;
      float* acc = accs.data() + static_cast<size_t>(x) * c;
      for (int k = 0; k < c; ++k) acc[k] = 0.f;
      float m = 0.f;
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          const int yy = y0i + dy;
          if (xx < 0 || xx >= w || yy < 0 || yy >= h) continue;
          const float wgt = (dx ? ax : 1.f - ax) * (dy ? ay : 1.f - ay);
          const size_t at = static_cast<size_t>(yy) * w + xx;
          const uint8_t* p = img + at * c;
          for (int k = 0; k < c; ++k)
            acc[k] = std::fma(wgt, static_cast<float>(p[k]), acc[k]);
          m = std::fma(wgt, static_cast<float>(mask[at]), m);
        }
      }
      ms[x] = m;
    }
    float* om = out_mask + static_cast<size_t>(y) * ow;
    float* oi = out_img + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float share = ms[x] / 255.f;
      om[x] = share >= 0.5f ? 1.f : 0.f;
      for (int k = 0; k < c; ++k) {
        const size_t i = static_cast<size_t>(x) * c + k;
        const float level =
            std::min(std::max(std::nearbyint(accs[i]), 0.f), 255.f);
        oi[i] = (2.f * (level / 255.f) - 1.f) * share;
      }
    }
  }
}

}  // namespace

extern "C" {

// img: (h, w, c) u8; mask: (h, w) u8; i_r: (3, 3) f64, the view's
// (K_new @ R)^-1; k_src: (3, 3) f64, its source intrinsics.
// out_img: (oh, ow, c) f32; out_mask: (oh, ow) f32.
void rectify_view_u8(const uint8_t* img, const uint8_t* mask, int h, int w,
                     int c, const double* i_r, const double* k_src, int oh,
                     int ow, float* out_img, float* out_mask) {
  parallel_rows(oh, [&](int y0, int y1) {
    if (c == 3)
      rectify_rows<3>(img, mask, h, w, c, i_r, k_src, ow, out_img, out_mask,
                      y0, y1);
    else
      rectify_rows<0>(img, mask, h, w, c, i_r, k_src, ow, out_img, out_mask,
                      y0, y1);
  });
}

}  // extern "C"
