// Tiled front-to-back Gaussian alpha compositing, forward (Hopper, sm_90a).
//
// Replaces gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py:767
// `_fwd_kernel` (launched by `_run_fwd` :983). It computes the same
// function: for every 16x16 pixel tile, walk the tile's depth-sorted pair
// segment [start, start + count) front to back; a pair is included iff
// power <= 0 and alpha = min(op * exp(power), 0.99) >= 1/255; a pair whose
// blend would push T below 1e-4 ends the pixel (it and everything behind it
// are dropped); the output is rgb accumulated with weight alpha * T plus the
// final T over blended pairs only. bg * T is added by the caller.
//
// What bounds it on this card: the work is pair-pixel arithmetic, about 25
// f32 operations and one expf for each (pair, pixel) walked, against 36
// bytes read per pair and 16 bytes written per pixel. At the serving shape
// every pair is read by 256 pixels, so it is bound by operations (the
// expf and the f32 pipe), not by HBM bytes.
//
// Design (not the TPU kernel's chunk and lane-scan structure):
//   * one block per tile, one thread per pixel (256 threads); blocks run in
//     any order, so nothing carries between tiles;
//   * the block stages its segment into shared memory in batches of 256
//     pairs, each thread loading one pair's 9 values (coalesced: the pair
//     array is structure-of-arrays), so each pair is read from HBM once per
//     tile and then from shared memory by all 256 pixels;
//   * each thread then walks the batch sequentially, carrying T in a
//     register; the TPU's Hillis-Steele cumprod becomes the plain sequential
//     product, which agrees with it to about one ulp;
//   * the block exits once all 256 pixels are done (__syncthreads_count),
//     the CUDA form of the TPU kernel's whole-tile early exit.
//
// Build with --fmad=false and without --use_fast_math: every multiply and
// add is then rounded on its own and expf stays expf, exactly as in the
// plain PyTorch version (composite.py composite_fwd_plain), so both reach
// the same T_EPS decisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kProps = 9;            // mx my ca cb cc op r g b
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ props, int64_t num_pairs,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ count, int tiles_x,
                     int tiles_per_sample, float* __restrict__ out) {
  __shared__ float sh[kProps][kPix];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int local = t % tiles_per_sample;
  const float px = static_cast<float>((local % tiles_x) * kTile + (i % kTile));
  const float py = static_cast<float>((local / tiles_x) * kTile + (i / kTile));
  const int64_t seg = start[t];
  const int n = count[t];

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int done = 0;
  for (int base = 0; base < n; base += kPix) {
    const int m = min(kPix, n - base);
    __syncthreads();  // the previous batch is consumed
    if (i < m) {
      const float* p = props + seg + base + i;
#pragma unroll
      for (int k = 0; k < kProps; ++k) sh[k][i] = p[k * num_pairs];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < m; ++j) {
        const float dx = px - sh[0][j];
        const float dy = py - sh[1][j];
        const float power = -0.5f * (sh[2][j] * dx * dx + sh[4][j] * dy * dy)
                            - sh[3][j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(sh[5][j] * expf(power), kAlphaMax);
        if (alpha < kAlphaMin) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < kTEps) {
          done = 1;
          break;
        }
        const float w = alpha * T;
        r += w * sh[6][j];
        g += w * sh[7][j];
        b += w * sh[8][j];
        T = test_T;
      }
    }
    if (__syncthreads_count(done) == kPix) break;
  }
  float4* o = reinterpret_cast<float4*>(out) + static_cast<int64_t>(t) * kPix + i;
  *o = make_float4(r, g, b, T);
}

}  // namespace

// props: (9, num_pairs) f32, rows mx my ca cb cc op r g b, pairs sorted by
// (tile, depth); start/count: (num_tiles,) i32 segment of each tile;
// out: (num_tiles, 256, 4) f32. Returns cudaGetLastError() after launch.
extern "C" int composite_fwd(const float* props, int64_t num_pairs,
                             const int32_t* start, const int32_t* count,
                             int num_tiles, int tiles_x, int tiles_per_sample,
                             float* out, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        props, num_pairs, start, count, tiles_x, tiles_per_sample, out);
  }
  return static_cast<int>(cudaGetLastError());
}
