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
// What bounds it on this card: instruction rate, not HBM (36 bytes read
// per pair reached, 36 written per pair, 32 read per pixel). Every (pair,
// pixel) walked costs the decision chain, about 30 instructions with expf,
// every blended one about 40 more, and every pair needs nine sums over the
// tile's 256 pixels. The first version of this kernel (one thread per
// pixel, eight warps per tile, nine five-step shuffle trees for every warp
// and pair in which a lane blended) took 4.8 ms at the stage-2 training
// shape on an H100. Taking out its trees, its zero stores and its gradient
// stores together left 3.4 ms (tools/torch_composite_bench.py --ablate): the
// walk itself was the larger part, and more than half of the (32-pixel
// row, pair) combinations it walked had no pixel that passed the include
// test.
//
// Design:
//   * one block per tile; a lane owns 1 or 2 pixels, one from each of its
//     warp's "rows" (the launch picks how many, see below). A row is a
//     compact 8x4 pixel block (COMPOSITE_BWD_SUB_W = 8; 16 gives 16x2
//     strips): a splat's footprint is compact, so a compact row either
//     blends it with many lanes or not at all, and its pixels saturate at
//     about the same pair. T, p_gc and the pixel's cotangent live in
//     registers per row;
//   * the row cull (composite_common.cuh cull_rows): once per batch every
//     lane takes one staged pair and finds, for each of its warp's rows, the
//     least value of the quadratic form over the row's rectangle; where even
//     that cannot reach alpha >= 1/255 the pair cannot touch the row. One
//     ballot per row turns the answers into a warp-uniform mask of the
//     batch's pairs that may touch it, and the warp visits, in order, only
//     the pairs that may touch one of its rows: a culled pair costs it
//     nothing, no vote and no branch. The test is conservative with stated
//     margins, so no decision and no output bit changes;
//   * a lane first adds the nine values of its own pixels in row order, in
//     registers; only then does the warp reduce across lanes, once per pair
//     and warp, with a transposing butterfly: at each of four steps a lane
//     keeps half of its values and sends the other half to its partner
//     (9 -> 5 -> 3 -> 2 -> 1 values), then one last exchange: 12 shuffles
//     where nine trees took 45. Every sum has a fixed order (rows, then the
//     butterfly, then warps in warp order), and there are no float atomics:
//     two launches give the same bits;
//   * a warp that blends a pair parks its nine sums in shared memory and
//     sets the pair's bit in a per-warp mask; nothing is stored for a pair
//     it does not blend. After the batch the block adds the partials whose
//     bit is set and writes the pair's columns of the (9, P) gradient,
//     coalesced. Pairs the walk never reaches keep the wrapper's zeros;
//   * a finished row costs one predicated branch per visited pair, a
//     finished warp leaves the batch, a finished block leaves the segment;
//     an empty tile's block leaves before it loads anything;
//   * pairs are staged 32 at a time as three float4 per pair ({mx my op .},
//     {ca cb cc .}, {r g b .}: three 16-byte broadcast loads per pair and
//     warp where there were nine scalar ones per pair and 32 pixels), double
//     buffered with 4-byte cp.async copies (the (9, P) layout is only
//     4-byte aligned), so the next batch's global load runs under this
//     batch's walk.
// More pixels per lane mean fewer butterflies and barriers, but fewer warps
// to hide latency and more registers. Which count is fastest depends on the
// scene (tools/torch_composite_bench.py --sweep, H100): with splats that
// cover many rows (the stage-2 training shape on random weights) 2 and 4 are
// level and 1 is a third slower; with small splats (the silhouette scene at
// 2048^2) 1 and 2 are level and 4 is 12% slower; a small launch (512^2,
// 1024 tiles) wants 1, for the warps. The launch takes 2 where that still
// gives every SM its 64 resident warps, else 1 (composite_common.cuh
// pick_rows). -DCOMPOSITE_BWD_PPL=n builds one count only: 1, 2, 4 or 8.
//
// Fused or reordered by hand, all after a pair is known to blend and all
// moving results by rounding only: gc, p_gc and g_alpha's product with
// __fmaf_rn; the division by max(1 - alpha, 1e-6) with __fdividef (2 ulp);
// the five geometry terms as fused sums of gp dx and gp dy products, their
// constant factors -1/2, -1, -1/2 applied once per pair after the sums; the
// opacity and colour terms and the per-lane accumulation over rows with
// __fmaf_rn. NOT fused: the decision chain dx, dy, power, expf, alpha,
// 1 - alpha, test_T. It must reach the forward kernel's and the plain
// version's include and T_EPS decisions bit for bit, so the file is built
// with --fmad=false and without --use_fast_math, and every multiply and add
// there is rounded on its own. Tensor cores have no place here: the
// quadratic form could be written as a small matrix product, but TF32 would
// round the conic and the offsets and break those decisions.

#include "composite_common.cuh"

#ifndef COMPOSITE_BWD_SUB_W
#define COMPOSITE_BWD_SUB_W 8  // a row is SUB_W x (32 / SUB_W) pixels
#endif
#ifndef COMPOSITE_BWD_CULL
#define COMPOSITE_BWD_CULL 1  // 0: visit every pair in every live row
#endif
// COMPOSITE_BWD_PPL (1, 2, 4 or 8), when defined, fixes the pixels per lane
// for every launch; by default the launch picks them (pick_rows).

namespace {

using namespace composite;

constexpr int kMaxRows = 2;  // pixels per lane a launch may pick
constexpr int kSubW = COMPOSITE_BWD_SUB_W;

static_assert(kSubW == 8 || kSubW == 16, "COMPOSITE_BWD_SUB_W: 8 or 16");

// One step of the transposing butterfly: of N values, lanes whose `upper`
// bit is clear keep the first ceil(N/2) and receive their partner's copies
// of them, the others keep the rest (padded with 0).
template <int N>
__device__ __forceinline__ void fold(const float (&in)[N],
                                     float (&out)[(N + 1) / 2], bool upper,
                                     int lane_xor) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float lo = in[k];
    const float hi = (k + H < N) ? in[k + H] : 0.0f;
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    out[k] = keep + __shfl_xor_sync(kFull, send, lane_xor);
  }
}

// Sum each of the nine values over the warp's 32 lanes in a fixed order.
// Afterwards lane l holds the sum of value slot_of(l), see below.
__device__ __forceinline__ float butterfly9(const float (&v)[kProps],
                                            int lane) {
  float a[5], b[3], c[2], d[1];
  fold<9>(v, a, lane & 16, 16);
  fold<5>(a, b, lane & 8, 8);
  fold<3>(b, c, lane & 4, 4);
  fold<2>(c, d, lane & 2, 2);
  return d[0] + __shfl_xor_sync(kFull, d[0], 1);
}

// Which of the nine values butterfly9 leaves in this lane, or -1 where the
// lane holds padding or a duplicate (odd lanes).
__device__ __forceinline__ int slot_of(int lane) {
  const int bi = ((lane & 4) ? 2 : 0) + ((lane & 2) ? 1 : 0);
  const int ai = ((lane & 8) ? 3 : 0) + bi;
  const int vi = ((lane & 16) ? 5 : 0) + ai;
  return ((lane & 1) || bi >= 3 || ai >= 5 || vi >= kProps) ? -1 : vi;
}

// kRows: rows (32-pixel groups) per warp, that is pixels per lane.
template <int kRows>
__global__ void __launch_bounds__(kPix / kRows)
composite_bwd_kernel(const float* __restrict__ props, int64_t num_pairs,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ count, int tiles_x,
                     int tiles_per_sample, const float* __restrict__ out,
                     const float* __restrict__ g_out,
                     float* __restrict__ gprops) {
  constexpr int kWarps = kPix / 32 / kRows;  // warps per block
  constexpr int kThreads = 32 * kWarps;
  constexpr unsigned kAllRows = (1u << kRows) - 1u;
  static_assert(kRows == 1 || kRows == 2 || kRows == 4 || kRows == 8,
                "pixels per lane: 1, 2, 4 or 8");
  __shared__ float4 st[2][3][kBatch];
  __shared__ float part[kWarps][kBatch][kProps];
  __shared__ unsigned blended[kWarps];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = kWarps == 1 ? 0 : tid >> 5;
  const int local = t % tiles_per_sample;
  const float tile_x = static_cast<float>((local % tiles_x) * kTile);
  const float tile_y = static_cast<float>((local / tiles_x) * kTile);
  const float px0 = tile_x + static_cast<float>(lane % kSubW);
  const float py0 = tile_y + static_cast<float>(lane / kSubW);
  const int64_t seg = start[t];
  const int n = count[t];
  if (n == 0) return;  // an empty tile has no pair to give a gradient to
  const int my_slot = slot_of(lane);

  // per row: the pixel's cotangent, dL/dalpha's suffix constant
  // g_rgb . rgb_pre + g_T * T_final, and the walk's state
  float gx[kRows], gy[kRows], gz[kRows], suffix[kRows], T[kRows], p_gc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int grp = row_of<kRows, kSubW>(warp, q);
    const int x = row_x<kSubW>(grp) + lane % kSubW;
    const int y = row_y<kSubW>(grp) + lane / kSubW;
    const int64_t pix = static_cast<int64_t>(t) * kPix + y * kTile + x;
    const float4 res = reinterpret_cast<const float4*>(out)[pix];
    const float4 g = reinterpret_cast<const float4*>(g_out)[pix];
    gx[q] = g.x;
    gy[q] = g.y;
    gz[q] = g.z;
    suffix[q] = g.x * res.x + g.y * res.y + g.z * res.z + g.w * res.w;
    T[q] = 1.0f;
    p_gc[q] = 0.0f;
  }

  unsigned done = 0u;  // bit q: this lane's pixel of row q has ended
  int buf = 0;
  stage<kWarps>(st[0], props, num_pairs, seg, min(kBatch, n), warp, lane);
  for (int base = 0; base < n; base += kBatch) {
    const int m = min(kBatch, n - base);
    if (base + kBatch < n) {
      stage<kWarps>(st[buf ^ 1], props, num_pairs, seg + base + kBatch,
                    min(kBatch, n - base - kBatch), warp, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // this batch is staged; the last one's sums are written
    block_sync<kWarps>();

    // bit j of live[q]: pair j of the batch may touch this warp's row q
    // (warp-uniform); the warp visits only pairs that may touch some row
    const unsigned culled =
        COMPOSITE_BWD_CULL
            ? cull_rows<kRows, kSubW>(st[buf], lane, warp, tile_x, tile_y)
            : 0u;
    unsigned live[kRows], any_live = 0u;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      live[q] = __ballot_sync(kFull, lane < m && !((culled >> q) & 1u));
      any_live |= live[q];
    }

    unsigned mask = 0u;  // bit j: this warp blended pair j (warp-uniform)
    while (any_live != 0u) {
      const int j = __ffs(any_live) - 1;
      any_live &= any_live - 1u;
      float v[kProps];
#pragma unroll
      for (int k = 0; k < kProps; ++k) v[k] = 0.0f;
      bool any = false;
      if (done != kAllRows) {
        const float4 A = st[buf][0][j];  // mx my op
        const float4 B = st[buf][1][j];  // ca cb cc
        const float4 C = st[buf][2][j];  // r g b
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (((done >> q) & 1u) || !((live[q] >> j) & 1u)) continue;
          const float px = px0 + static_cast<float>(
              row_x<kSubW>(row_of<kRows, kSubW>(warp, q)));
          const float py = py0 + static_cast<float>(
              row_y<kSubW>(row_of<kRows, kSubW>(warp, q)));
          // the decision chain: unfused, in the forward's order
          const float ca = B.x, cb = B.y, cc = B.z;
          const float dx = px - A.x;
          const float dy = py - A.y;
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy)
                              - cb * dx * dy;
          if (power > 0.0f) continue;
          const float G = expf(power);
          const float alpha_un = A.z * G;
          const float alpha = fminf(alpha_un, kAlphaMax);
          if (alpha < kAlphaMin) continue;
          const float one_m_raw = 1.0f - alpha;
          const float test_T = T[q] * one_m_raw;
          if (test_T < kTEps) {
            done |= 1u << q;
            continue;
          }
          // the pair blends: from here on fused by hand
          any = true;
          const float Tq = T[q];
          const float w = alpha * Tq;
          const float gc =
              __fmaf_rn(gz[q], C.z, __fmaf_rn(gy[q], C.y, gx[q] * C.x));
          p_gc[q] = __fmaf_rn(w, gc, p_gc[q]);
          const float one_m = fmaxf(one_m_raw, 1e-6f);
          const float g_alpha = __fmaf_rn(
              gc, Tq, -__fdividef(suffix[q] - p_gc[q], one_m));
          const bool nc = alpha_un < kAlphaMax;
          const float gp = nc ? g_alpha * alpha_un : 0.0f;
          // d power / d (mx my ca cb cc) = (ca dx + cb dy, cc dy + cb dx,
          // -dx^2 / 2, -dx dy, -dy^2 / 2); the three constant factors are
          // applied once per pair, after the sums
          const float hx = gp * dx, hy = gp * dy;
          v[0] = __fmaf_rn(ca, hx, __fmaf_rn(cb, hy, v[0]));
          v[1] = __fmaf_rn(cc, hy, __fmaf_rn(cb, hx, v[1]));
          v[2] = __fmaf_rn(hx, dx, v[2]);
          v[3] = __fmaf_rn(hx, dy, v[3]);
          v[4] = __fmaf_rn(hy, dy, v[4]);
          v[5] = __fmaf_rn(g_alpha, nc ? G : 0.0f, v[5]);
          v[6] = __fmaf_rn(gx[q], w, v[6]);
          v[7] = __fmaf_rn(gy[q], w, v[7]);
          v[8] = __fmaf_rn(gz[q], w, v[8]);
          T[q] = test_T;
        }
      }
      if (__ballot_sync(kFull, any) != 0u) {
        const float s = butterfly9(v, lane);
        if (my_slot >= 0) part[warp][j][my_slot] = s;
        mask |= 1u << j;
      } else if (__all_sync(kFull, done == kAllRows)) {
        break;  // every pixel of this warp has ended
      }
    }
    if (lane == 0) blended[warp] = mask;

    const bool all_done =
        block_sync_count<kWarps>(done == kAllRows) == kThreads;
    // add the warps' partials in warp order; a pair that no warp blended
    // (but the walk reached) gets its 0 written
    if (lane < m) {
#pragma unroll
      for (int k0 = 0; k0 < kProps; k0 += kWarps) {
        const int k = k0 + warp;
        if (k < kProps) {
          float s = 0.0f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) {
            if ((blended[wi] >> lane) & 1u) s += part[wi][lane][k];
          }
          const float factor = (k == 2 || k == 4) ? -0.5f
                               : k == 3           ? -1.0f
                                                  : 1.0f;
          gprops[k * num_pairs + seg + base + lane] = factor * s;
        }
      }
    }
    if (all_done) break;
    buf ^= 1;
  }
  __pipeline_wait_prior(0);  // a batch staged ahead of an early exit
}

template <int kRows>
int launch(const float* props, int64_t num_pairs, const int32_t* start,
           const int32_t* count, int num_tiles, int tiles_x,
           int tiles_per_sample, const float* out, const float* g_out,
           float* gprops, cudaStream_t stream) {
  composite_bwd_kernel<kRows><<<num_tiles, kPix / kRows, 0, stream>>>(
      props, num_pairs, start, count, tiles_x, tiles_per_sample, out, g_out,
      gprops);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int occupancy(int* blocks_per_sm, int* threads_per_block) {
  *threads_per_block = kPix / kRows;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, composite_bwd_kernel<kRows>, kPix / kRows, 0));
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
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef COMPOSITE_BWD_PPL
  return launch<COMPOSITE_BWD_PPL>(props, num_pairs, start, count, num_tiles,
                                   tiles_x, tiles_per_sample, out, g_out,
                                   gprops, s);
#else
  switch (pick_rows(num_tiles, kMaxRows)) {
    case 2:
      return launch<2>(props, num_pairs, start, count, num_tiles, tiles_x,
                       tiles_per_sample, out, g_out, gprops, s);
    default:
      return launch<1>(props, num_pairs, start, count, num_tiles, tiles_x,
                       tiles_per_sample, out, g_out, gprops, s);
  }
#endif
}

// Of the kernel a launch over num_tiles tiles runs: pixels per lane,
// resident blocks per SM and block size. Returns the CUDA error of the query.
extern "C" int composite_bwd_occupancy(int num_tiles, int* pixels_per_lane,
                                       int* blocks_per_sm,
                                       int* threads_per_block) {
#ifdef COMPOSITE_BWD_PPL
  *pixels_per_lane = COMPOSITE_BWD_PPL;
  return occupancy<COMPOSITE_BWD_PPL>(blocks_per_sm, threads_per_block);
#else
  *pixels_per_lane = pick_rows(num_tiles, kMaxRows);
  switch (*pixels_per_lane) {
    case 2: return occupancy<2>(blocks_per_sm, threads_per_block);
    default: return occupancy<1>(blocks_per_sm, threads_per_block);
  }
#endif
}
