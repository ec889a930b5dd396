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
// What bounds it on this card: instruction rate. The work is pair-pixel
// arithmetic, about 25 f32 operations and one expf for each (pair, pixel)
// walked, against 36 bytes read per pair and 16 bytes written per pixel; at
// the serving shape every pair is read by 256 pixels, so HBM is far away.
// The decision chain below is unfused by contract, so the kernel executes
// about 31 instructions per evaluation where a bound at the card's FMA rate
// reckons 12.5: its own ceiling is above twice the published-peak bound.
// The first version of this kernel (one thread per pixel, 256-pair batches
// between two block barriers) took 0.78 ms at the serving shape on an H100;
// its time followed the evaluations walked, not its longest tile
// (tools/torch_composite_bench.py --cap-sweep), and 60% of the (32-pixel
// row, pair) combinations it walked had no pixel that passed the include
// test.
//
// Design:
//   * a warp walks one part of a tile on its own: COMPOSITE_FWD_PPL "rows"
//     of 32 pixels, a lane owning one pixel of each. A row is a compact 8x4
//     pixel block (COMPOSITE_FWD_SUB_W = 8; 16 gives 16x2 strips), whose
//     pixels see about the same splats and saturate at about the same pair,
//     so a row's lanes end together. Each warp stages the tile's pairs for
//     itself, so no warp ever waits at a barrier for another; a block is
//     just COMPOSITE_FWD_WARPS such warps. The pairs a tile's warps read
//     more than once come from L2. One row per warp is the default: two
//     were 3% faster at the serving shape and 7% at the training shape
//     (large splats, random weights) but 20% slower on small splats (the
//     silhouette scene at 2048^2; tools/torch_composite_bench.py --sweep);
//   * the row cull (composite_common.cuh cull_rows): once per batch every
//     lane takes one staged pair and finds, for each of its warp's rows, the
//     least value of the quadratic form over the row's rectangle; where even
//     that cannot reach alpha >= 1/255 the pair cannot touch the row. One
//     ballot per row turns the answers into a warp-uniform mask of the
//     batch's pairs that may touch it, and the warp visits, in order, only
//     the pairs that may touch one of its rows: a culled pair costs it
//     nothing. The test is conservative with stated margins, so no decision
//     and no output bit changes;
//   * a row that has ended costs one predicated branch per visited pair, a
//     lane whose rows have all ended leaves the batch, a warp whose pixels
//     have all ended leaves the segment (the TPU kernel's whole-tile early
//     exit, per part);
//   * pairs are staged 32 at a time as three float4 per pair ({mx my op .},
//     {ca cb cc .}, {r g b .}): two 16-byte broadcast loads per pair and
//     warp for the chain, the third only where a lane blends;
//   * the stage is a ring of three buffers filled with 4-byte cp.async
//     copies (the (9, P) layout is only 4-byte aligned), so the next batch
//     loads under this batch's walk and one __syncwarp per batch is enough.
//
// Fused by hand with __fmaf_rn: the three colour accumulations
// rgb += w * color. That moves rgb by rounding only. NOT fused: the
// decision chain dx, dy, power, expf, alpha, 1 - alpha, test_T and T
// itself. The file is built with --fmad=false and without --use_fast_math,
// so every multiply and add there is rounded on its own and expf stays
// expf, exactly as in the plain PyTorch version (composite.py
// composite_fwd_plain): both reach the same include and T_EPS decisions and
// the T channel is bit-equal. Tensor cores have no place here: the
// quadratic form could be a small matrix product, but TF32 would round the
// conic and the offsets and break those decisions.

#include "composite_common.cuh"

#ifndef COMPOSITE_FWD_PPL
#define COMPOSITE_FWD_PPL 1  // pixels per lane: 1, 2, 4 or 8
#endif
#ifndef COMPOSITE_FWD_WARPS
#define COMPOSITE_FWD_WARPS 4  // independent warps per block
#endif
#ifndef COMPOSITE_FWD_SUB_W
#define COMPOSITE_FWD_SUB_W 8  // a row is SUB_W x (32 / SUB_W) pixels
#endif
#ifndef COMPOSITE_FWD_CULL
#define COMPOSITE_FWD_CULL 1  // 0: visit every pair in every live row
#endif

namespace {

using namespace composite;

constexpr int kRows = COMPOSITE_FWD_PPL;  // rows (32-pixel groups) per warp
constexpr int kParts = kPix / 32 / kRows;  // warps that share a tile
constexpr int kWarps = COMPOSITE_FWD_WARPS;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSubW = COMPOSITE_FWD_SUB_W;
constexpr int kStages = 3;

static_assert(kSubW == 8 || kSubW == 16, "COMPOSITE_FWD_SUB_W: 8 or 16");

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ props, int64_t num_pairs,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ count, int num_tiles,
                     int tiles_x, int tiles_per_sample,
                     float* __restrict__ out) {
  constexpr unsigned kAllRows = (1u << kRows) - 1u;
  static_assert(kRows == 1 || kRows == 2 || kRows == 4 || kRows == 8,
                "pixels per lane: 1, 2, 4 or 8");
  __shared__ float4 stages[kWarps][kStages][3][kBatch];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // every warp walks its own part of a tile, on its own stage: no warp
  // ever waits for another
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (unit >= static_cast<int64_t>(num_tiles) * kParts) return;
  const int t = static_cast<int>(unit / kParts);
  const int part = static_cast<int>(unit % kParts);
  float4 (*st)[3][kBatch] = stages[warp];

  const int local = t % tiles_per_sample;
  const float tile_x = static_cast<float>((local % tiles_x) * kTile);
  const float tile_y = static_cast<float>((local / tiles_x) * kTile);
  const float px0 = tile_x + static_cast<float>(lane % kSubW);
  const float py0 = tile_y + static_cast<float>(lane / kSubW);
  const int64_t seg = start[t];
  const int n = count[t];

  float T[kRows], r[kRows], g[kRows], b[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    T[q] = 1.0f;
    r[q] = g[q] = b[q] = 0.0f;
  }

  unsigned done = 0u;  // bit q: this lane's pixel of row q has ended
  int cur = 0;
  if (n > 0) stage<1>(st[0], props, num_pairs, seg, min(kBatch, n), 0, lane);
  for (int base = 0; base < n; base += kBatch) {
    const int m = min(kBatch, n - base);
    const int nxt = cur + 1 == kStages ? 0 : cur + 1;
    if (base + kBatch < n) {
      // the buffer two batches back: every lane left it before the last
      // __syncwarp
      stage<1>(st[nxt], props, num_pairs, seg + base + kBatch,
               min(kBatch, n - base - kBatch), 0, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // publishes this batch to the warp; all its pixels ended: leave
    if (block_sync_count<1>(done == kAllRows) == 32) break;

    // bit j of live[q]: pair j of the batch may touch this warp's row q
    // (warp-uniform); the walk visits only pairs that may touch some row
    const unsigned culled =
        COMPOSITE_FWD_CULL
            ? cull_rows<kRows, kSubW>(st[cur], lane, part, tile_x, tile_y)
            : 0u;
    unsigned live[kRows], any = 0u;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      live[q] = __ballot_sync(kFull, lane < m && !((culled >> q) & 1u));
      any |= live[q];
    }

    while (any != 0u) {
      if (done == kAllRows) break;
      const int j = __ffs(any) - 1;
      any &= any - 1u;
      const float4 A = st[cur][0][j];  // mx my op
      const float4 B = st[cur][1][j];  // ca cb cc
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (((done >> q) & 1u) || !((live[q] >> j) & 1u)) continue;
        const float px = px0 + static_cast<float>(
            row_x<kSubW>(row_of<kRows, kSubW>(part, q)));
        const float py = py0 + static_cast<float>(
            row_y<kSubW>(row_of<kRows, kSubW>(part, q)));
        // the decision chain: unfused
        const float dx = px - A.x;
        const float dy = py - A.y;
        const float power = -0.5f * (B.x * dx * dx + B.z * dy * dy)
                            - B.y * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(A.z * expf(power), kAlphaMax);
        if (alpha < kAlphaMin) continue;
        const float test_T = T[q] * (1.0f - alpha);
        if (test_T < kTEps) {
          done |= 1u << q;
          continue;
        }
        const float4 C = st[cur][2][j];  // r g b
        const float w = alpha * T[q];
        r[q] = __fmaf_rn(w, C.x, r[q]);
        g[q] = __fmaf_rn(w, C.y, g[q]);
        b[q] = __fmaf_rn(w, C.z, b[q]);
        T[q] = test_T;
      }
    }
    cur = nxt;
  }
  __pipeline_wait_prior(0);  // a batch staged ahead of an early exit

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int grp = row_of<kRows, kSubW>(part, q);
    const int x = row_x<kSubW>(grp) + lane % kSubW;
    const int y = row_y<kSubW>(grp) + lane / kSubW;
    reinterpret_cast<float4*>(out)[static_cast<int64_t>(t) * kPix + y * kTile
                                   + x] = make_float4(r[q], g[q], b[q], T[q]);
  }
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
    const int64_t units = static_cast<int64_t>(num_tiles) * kParts;
    composite_fwd_kernel<<<static_cast<unsigned>((units + kWarps - 1)
                                                 / kWarps),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        props, num_pairs, start, count, num_tiles, tiles_x, tiles_per_sample,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Of the kernel a launch over num_tiles tiles runs (the same for every
// num_tiles here; composite_bwd_occupancy has the same form): pixels per
// lane, resident blocks per SM and block size. Returns the CUDA error of the
// query.
extern "C" int composite_fwd_occupancy(int /*num_tiles*/,
                                       int* pixels_per_lane,
                                       int* blocks_per_sm,
                                       int* threads_per_block) {
  *pixels_per_lane = kRows;
  *threads_per_block = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, composite_fwd_kernel, kThreads, 0));
}
