// Shared by composite_fwd.cu and composite_bwd.cu: the tile geometry, the
// staging of pairs into shared memory, and the conservative row cull.
//
// In both kernels a warp owns kRows "rows" of a 16x16 tile, a row being 32
// pixels, and a lane one pixel of each row; a row is a kSubW x (32 / kSubW)
// pixel rectangle (8x4 by default: compact, like a splat's footprint).
// Pairs are staged 32 at a time (one per lane) as three float4 per pair,
// {mx my op .} {ca cb cc .} {r g b .}, with 4-byte cp.async copies: the
// (9, P) structure-of-arrays layout is only 4-byte aligned.

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace composite {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kProps = 9;   // mx my ca cb cc op r g b
constexpr int kBatch = 32;  // pairs staged per step: one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Row `grp` (0..7, left to right, then top to bottom) of a tile: the
// offset of its first pixel.
template <int kSubW>
__device__ __forceinline__ constexpr int row_x(int grp) {
  return (grp % (kTile / kSubW)) * kSubW;
}
template <int kSubW>
__device__ __forceinline__ constexpr int row_y(int grp) {
  return (grp / (kTile / kSubW)) * (32 / kSubW);
}

// Row q of the warp that walks part `part` of a tile. A warp's rows form a
// block as compact as their number allows: two 8x4 rows stack to 8x8.
template <int kRows, int kSubW>
__device__ __forceinline__ constexpr int row_of(int part, int q) {
  return (kRows == 2 && kSubW == 8)
             ? ((part >> 1) * 2 + q) * 2 + (part & 1)
             : part * kRows + q;
}

// How many rows a warp takes (pixels per lane) for a launch over num_tiles
// tiles: more rows mean fewer reductions and barriers, but 8 / rows warps
// per tile, and a small launch needs its warps to fill the card. So: the
// largest power of two up to max_rows that still gives every SM its 64
// resident warps, else 1.
inline int pick_rows(int num_tiles, int max_rows) {
  static int sms = 0;  // of the current device, asked once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess) {
      sms = 132;
    }
  }
  for (int rows = max_rows; rows > 1; rows >>= 1) {
    if (static_cast<int64_t>(num_tiles) * (kPix / 32 / rows)
        >= static_cast<int64_t>(64) * sms) {
      return rows;
    }
  }
  return 1;
}

// Where property k of the (9, P) layout lands in a pair's staged record.
__device__ __forceinline__ constexpr int stage_slot(int k) {
  return k < 2 ? k : k < 5 ? 4 + (k - 2) : k == 5 ? 2 : 8 + (k - 6);
}

// Start the copies of pairs [col0, col0 + m) into one stage buffer: lane j
// copies pair j, each warp its share of the nine property rows.
template <int kWarps>
__device__ __forceinline__ void stage(float4 (*dst)[kBatch],
                                      const float* __restrict__ props,
                                      int64_t num_pairs, int64_t col0, int m,
                                      int warp, int lane) {
  float* d = reinterpret_cast<float*>(dst);
  if (lane < m) {
#pragma unroll
    for (int k0 = 0; k0 < kProps; k0 += kWarps) {
      const int k = k0 + warp;
      if (k < kProps) {
        const int slot = stage_slot(k);
        __pipeline_memcpy_async(
            d + ((slot >> 2) * kBatch + lane) * 4 + (slot & 3),
            props + k * num_pairs + col0 + lane, 4);
      }
    }
  }
  __pipeline_commit();
}

// Barrier over the block that also counts a predicate; a one-warp block
// needs only the warp's own.
template <int kWarps>
__device__ __forceinline__ int block_sync_count(bool pred) {
  if (kWarps == 1) {
    __syncwarp();
    return __popc(__ballot_sync(kFull, pred));
  }
  return __syncthreads_count(pred);
}

template <int kWarps>
__device__ __forceinline__ void block_sync() {
  if (kWarps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The conservative row cull. For the staged pair `lane` of a batch, bit q
// of the result says that NO pixel of row q of the warp that walks `part`
// can pass the include test alpha >= 1/255, so the row may skip the pair's
// decision chain: the walk's decisions, and with them every output bit,
// stay what they were.
//
// A pixel at offset d from the mean passes only if
//   quad(d) = (ca dx^2 + cc dy^2) / 2 + cb dx dy <= tau = ln(255 op).
// quad is convex with its minimum 0 at d = 0, so over the row's rectangle
// [x0, x1] x [y0, y1] of offsets it is least on a side that faces the mean:
// on dx = xc (the x nearest to 0) at dy = clamp(-cb xc / cc), or on
// dy = yc at dx = clamp(-cb yc / ca). The row is culled when the smaller of
// the two values exceeds tau. The margins make that safe against every
// rounding on the way: tau is raised by 0.01 and then by 1%, where the
// chain's f32 power and this minimum are each within 0.2% of the exact form
// when det = ca cc - cb^2 >= 1e-3 ca cc, expf and the opacity product within
// a few ulp, and __logf within 1e-6 here. A needle (det below that), a form
// that is not positive definite, or anything not finite culls nothing. An
// opacity below exp(-0.01) / 255 never passes (exp(power) <= 1): every row
// is culled.
template <int kRows, int kSubW>
__device__ __forceinline__ unsigned cull_rows(const float4 (*st)[kBatch],
                                              int lane, int part,
                                              float tile_x, float tile_y) {
  const float4 A = st[0][lane];  // mx my op
  const float4 B = st[1][lane];  // ca cb cc
  const float ca = B.x, cb = B.y, cc = B.z;
  const float tau = 1.01f * (__logf(255.0f * A.z) + 0.01f);
  if (!(tau > 0.0f)) return A.z < kAlphaMin ? (1u << kRows) - 1u : 0u;
  if (!(ca > 0.0f && cc > 0.0f && ca * cc - cb * cb >= 1e-3f * ca * cc
        && tau < 1e30f)) {
    return 0u;
  }
  const float slope_y = -cb / cc, slope_x = -cb / ca;
  unsigned cull = 0u;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int grp = row_of<kRows, kSubW>(part, q);
    const float x0 = tile_x + static_cast<float>(row_x<kSubW>(grp)) - A.x;
    const float y0 = tile_y + static_cast<float>(row_y<kSubW>(grp)) - A.y;
    const float x1 = x0 + static_cast<float>(kSubW - 1);
    const float y1 = y0 + static_cast<float>(32 / kSubW - 1);
    const float xc = fminf(fmaxf(0.0f, x0), x1);
    const float yc = fminf(fmaxf(0.0f, y0), y1);
    const float ye = fminf(fmaxf(slope_y * xc, y0), y1);
    const float xe = fminf(fmaxf(slope_x * yc, x0), x1);
    const float on_x = 0.5f * (ca * xc * xc + cc * ye * ye) + cb * xc * ye;
    const float on_y = 0.5f * (ca * xe * xe + cc * yc * yc) + cb * xe * yc;
    cull |= fminf(on_x, on_y) > tau ? 1u << q : 0u;
  }
  return cull;
}

}  // namespace composite
