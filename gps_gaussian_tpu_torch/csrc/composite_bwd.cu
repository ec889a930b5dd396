// Tiled front-to-back Gaussian alpha compositing, backward (Hopper, sm_90a).
//
// Replaces gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py:836
// `_bwd_kernel` (launched by `_run_bwd` :1006 through `_composite_core_bwd`
// :1063). It computes the same function: re-walk every 16x16 tile's
// depth-sorted pair segment exactly as the forward kernel
// (composite_fwd.cu) walks it, and from the forward's saved output
// (rgb_pre, T_final) and the cotangents (g_rgb, g_T) give every pair the
// gradient of its nine properties mx my ca cb cc op r g b, summed over the
// tile's 256 pixels. With gc = g_rgb . color, w = alpha * T and the running
// inclusive sum p_gc of w * gc over the pixel's blended pairs,
//   g_alpha = gc * T - (g_rgb . rgb_pre + g_T * T_final - p_gc)
//                      / max(1 - alpha, 1e-6)
//   g_power = g_alpha * alpha_un * [alpha_un < 0.99]
// and the nine sums are g_power * d power / d (mx my ca cb cc),
// g_alpha * exp(power) * [alpha_un < 0.99] and g_rgb * w. The TPU kernel
// recovers exp(power) as alpha_un / op; this thread still holds expf(power)
// and uses it (the two agree to about 1 ulp).
//
// What bounds it on this card: arithmetic, about 70 f32 operations for each
// (pair, pixel) walked, plus the reduction over pixels, which the forward
// did not have: every pair needs nine sums over the block's 256 threads.
// HBM traffic is 36 bytes read and 36 written per pair and 32 bytes read
// per pixel, far below the arithmetic at 256 pixels per pair.
//
// Design (not the TPU kernel's chunk, lane-scan and merge-DMA structure):
//   * one block per tile, one thread per pixel; T and p_gc live in
//     registers and the per-thread walk is sequential, so the TPU's
//     Hillis-Steele cumprod and cumsum over 128 lanes have no counterpart;
//   * pairs are staged in shared memory in batches of 128 (structure of
//     arrays, coalesced) and all threads step through a batch together,
//     because every pair ends in a reduction over the block;
//   * per pair, each warp whose lanes blend it reduces its nine values with
//     a shuffle tree in a fixed order and parks them in shared memory; a warp
//     in which no lane blends the pair skips the tree (__ballot_sync), and a
//     warp whose 32 pixels are all done leaves the batch;
//   * after the batch, the eight warps' partials are added in warp order and
//     written to the pair's own columns of the (9, P) gradient, coalesced.
//     No float atomics anywhere: the order of every sum is fixed, so two
//     launches give the same bits;
//   * a pair belongs to one tile, so those writes are race-free and the TPU
//     kernel's read-modify-write merge of a chunk shared by two tiles is
//     gone. Pairs the walk never reaches (behind the early exit or outside
//     every segment) keep the zeros the wrapper allocated.
//
// Build with --fmad=false and without --use_fast_math, as the forward is:
// the walk must reach the forward kernel's include and T_EPS decisions bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kWarps = kPix / 32;
constexpr int kProps = 9;            // mx my ca cb cc op r g b
constexpr int kBatch = 128;          // pairs staged per step
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ props, int64_t num_pairs,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ count, int tiles_x,
                     int tiles_per_sample, const float* __restrict__ out,
                     const float* __restrict__ g_out,
                     float* __restrict__ gprops) {
  __shared__ float sh[kProps][kBatch];
  __shared__ float part[kWarps][kProps][kBatch];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int local = t % tiles_per_sample;
  const float px = static_cast<float>((local % tiles_x) * kTile + (i % kTile));
  const float py = static_cast<float>((local / tiles_x) * kTile + (i / kTile));
  const int64_t seg = start[t];
  const int n = count[t];

  const float4 res =
      reinterpret_cast<const float4*>(out)[static_cast<int64_t>(t) * kPix + i];
  const float4 g =
      reinterpret_cast<const float4*>(g_out)[static_cast<int64_t>(t) * kPix + i];
  // dL/dalpha suffix constant: g_rgb . rgb_pre + g_T * T_final
  const float suffix = g.x * res.x + g.y * res.y + g.z * res.z + g.w * res.w;

  float T = 1.0f, p_gc = 0.0f;
  int done = 0;
  for (int base = 0; base < n; base += kBatch) {
    const int m = min(kBatch, n - base);
    __syncthreads();  // the previous batch is consumed and written out
    for (int e = i; e < kProps * m; e += kPix) {
      const int k = e / m, j = e - k * m;
      sh[k][j] = props[k * num_pairs + seg + base + j];
    }
    __syncthreads();

    for (int j = 0; j < m; ++j) {
      float v[kProps];
      bool blend = false;
      if (!done) {
        const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
        const float dx = px - sh[0][j];
        const float dy = py - sh[1][j];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy)
                            - cb * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha_un = sh[5][j] * G;
          const float alpha = fminf(alpha_un, kAlphaMax);
          if (alpha >= kAlphaMin) {
            const float test_T = T * (1.0f - alpha);
            if (test_T < kTEps) {
              done = 1;
            } else {
              blend = true;
              const float w = alpha * T;
              const float gc = g.x * sh[6][j] + g.y * sh[7][j]
                               + g.z * sh[8][j];
              p_gc += w * gc;
              const float one_m = fmaxf(1.0f - alpha, 1e-6f);
              const float g_alpha = gc * T - (suffix - p_gc) / one_m;
              const float nc = alpha_un < kAlphaMax ? 1.0f : 0.0f;
              const float gp = g_alpha * alpha_un * nc;
              v[0] = gp * (ca * dx + cb * dy);
              v[1] = gp * (cc * dy + cb * dx);
              v[2] = gp * (-0.5f * dx * dx);
              v[3] = gp * (-dx * dy);
              v[4] = gp * (-0.5f * dy * dy);
              v[5] = g_alpha * G * nc;
              v[6] = g.x * w;
              v[7] = g.y * w;
              v[8] = g.z * w;
              T = test_T;
            }
          }
        }
      }
      if (__ballot_sync(kFull, blend) == 0u) {
        if (__all_sync(kFull, done)) {
          // this warp's pixels are finished: zero its partials for the
          // rest of the batch and leave
          for (int e = lane; e < kProps * (m - j); e += 32) {
            const int k = e / (m - j), jj = j + e - k * (m - j);
            part[warp][k][jj] = 0.0f;
          }
          break;
        }
        if (lane < kProps) part[warp][lane][j] = 0.0f;
        continue;
      }
#pragma unroll
      for (int k = 0; k < kProps; ++k) {
        float x = blend ? v[k] : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(kFull, x, off);
        if (lane == 0) part[warp][k][j] = x;
      }
    }

    const int all_done = __syncthreads_count(done) == kPix;
    for (int e = i; e < kProps * m; e += kPix) {
      const int k = e / m, j = e - k * m;
      float s = part[0][k][j];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) s += part[wi][k][j];
      gprops[k * num_pairs + seg + base + j] = s;
    }
    if (all_done) break;
  }
}

}  // namespace

// props: (9, num_pairs) f32, rows mx my ca cb cc op r g b, pairs sorted by
// (tile, depth); start/count: (num_tiles,) i32 segment of each tile; out:
// the forward's (num_tiles, 256, 4) result; g_out: its cotangent, same
// shape; gprops: (9, num_pairs) f32, zero on entry. Returns
// cudaGetLastError() after launch.
extern "C" int composite_bwd(const float* props, int64_t num_pairs,
                             const int32_t* start, const int32_t* count,
                             int num_tiles, int tiles_x, int tiles_per_sample,
                             const float* out, const float* g_out,
                             float* gprops, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        props, num_pairs, start, count, tiles_x, tiles_per_sample, out, g_out,
        gprops);
  }
  return static_cast<int>(cudaGetLastError());
}
