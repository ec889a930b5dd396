"""Tile binning, the (tile | depth) pair sort and the sorted renders.

Counterpart of gps_gaussian_tpu/kernels/rasterizer/pallas_kernel.py. The
legacy uniform-K path: `stack_rows` :102, `tile_rects` :120,
`expand_rect_offsets` :147, `pack_sort_key` :210, `_pair_sort` :251/:275
with its backward `_pair_sort_bwd` :322, and `render_sorted` :1081. The
span staircase: `ellipse_radii` :168, `tile_rects_xy` :191,
`sort_rows_by_key` :377, `_pair_sort_pre` :427-504,
`validate_span_schedule` :507 and `render_sorted_staircase` :530. The
composite itself is `composite.composite` (the CUDA kernels on the GPU,
forward and backward).

Differences from the JAX code, none of which changes a result:
* tile ids, keys, `start` and `count` stay integers end to end (JAX carries
  tile ids through f32, exact only below 2^24);
* torch has no multi-operand sort, so one stable sort of the packed i32 key
  gives the permutation and the 9 property rows are gathered by it; ties
  keep slot order (Gaussian, duplicate k) as JAX's stable sort does;
* pairs are laid out (9, P) structure-of-arrays, not (chunks, 16, 128);
* the backward un-sorts pair gradients with a unique-index copy at the kept
  permutation, where JAX sorts a second time by slot id (sorts are the cheap
  primitive on a TPU, scattered copies on a GPU); both then sum each
  Gaussian's K duplicates in slot order;
* the staircase breaks ties of the packed key by the pair's original row,
  as the legacy stable sort does (JAX sorts it unstably), so a one-class
  schedule at K gives the legacy path's bits at K, images and gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gps_gaussian_tpu_torch.kernels.rasterizer.compaction import \
    take_rows_unique
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (TILE,
                                                                 composite)

NPROP = 9     # kernel property columns: mx my ca cb cc op r g b
STACKW = 11   # + depth (9) and radius (10), which feed binning only
CHUNK = 128   # JAX rounds the pair budget up to whole 128-pair chunks


def stack_rows(mean2d, conic, opacity, color, depth, radius):
    """Per-Gaussian properties as (N, 11) rows: columns 0..8 feed the
    composite, 9 = depth and 10 = radius feed the binning."""
    n = mean2d.shape[0]
    return torch.cat([mean2d, conic, opacity.reshape(n, 1), color,
                      depth.reshape(n, 1), radius.reshape(n, 1)], dim=1)


def tile_rects(mean2d, radius, tiles_y: int, tiles_x: int, tile: int,
               max_tiles: int):
    """Exclusive-max tile rectangle per Gaussian, clamped (CUDA getRect).

    Returns (x_min, y_min, span_x, total_capped, total_uncapped), int32;
    the totals are 0 for culled Gaussians."""
    def edge(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    x_min = edge(mean2d[:, 0] - radius, tiles_x)
    x_max = edge(mean2d[:, 0] + radius + tile - 1, tiles_x)
    y_min = edge(mean2d[:, 1] - radius, tiles_y)
    y_max = edge(mean2d[:, 1] + radius + tile - 1, tiles_y)
    span_x = x_max - x_min
    total = torch.where(radius > 0.0, span_x * (y_max - y_min), 0)
    return x_min, y_min, span_x, torch.clamp_max(total, max_tiles), total


def expand_rect_offsets(span_x, max_tiles: int):
    """(dx, dy) tile offsets of duplicate k = dy * span_x + dx, each
    (N, max_tiles). span_x must be >= 1."""
    k = torch.arange(max_tiles, dtype=torch.int32, device=span_x.device)
    span = span_x[:, None]
    dy = torch.div(k[None, :], span, rounding_mode="floor")
    return k[None, :] - dy * span, dy


def ellipse_radii(conic, radius):
    """Per-axis 3-sigma half-extents of the ellipse's bounding box, from the
    conic (a, b, c) = inverse 2D covariance: rx = ceil(3 sqrt(c / det)),
    ry = ceil(3 sqrt(a / det)), det = a c - b^2, each clamped to the
    circumscribed `radius` the legacy rectangles use; (0, 0) for culled
    rows. Pairs outside the 3-sigma ellipse that the circle would bin have
    alpha <= opacity * exp(-4.5)."""
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    det = torch.clamp_min(ca * cc - cb * cb, 1e-12)
    live = radius > 0.0
    rx = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(cc / det, 0.0)))
    ry = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(ca / det, 0.0)))
    rx = torch.where(live, torch.minimum(rx, radius), 0.0)
    ry = torch.where(live, torch.minimum(ry, radius), 0.0)
    return rx, ry


def tile_rects_xy(mean2d, rx, ry, tiles_y: int, tiles_x: int, tile: int,
                  max_tiles: int):
    """`tile_rects` with independent x and y half-extents (the ellipse's
    bounding box); the totals are 0 unless both are positive."""
    def edge(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    x_min = edge(mean2d[:, 0] - rx, tiles_x)
    x_max = edge(mean2d[:, 0] + rx + tile - 1, tiles_x)
    y_min = edge(mean2d[:, 1] - ry, tiles_y)
    y_max = edge(mean2d[:, 1] + ry + tile - 1, tiles_y)
    span_x = x_max - x_min
    total = torch.where((rx > 0.0) & (ry > 0.0), span_x * (y_max - y_min), 0)
    return x_min, y_min, span_x, torch.clamp_max(total, max_tiles), total


class DepthKey(NamedTuple):
    """How `pack_sort_key` quantizes depth: over [dmin, dmax] into qbits."""

    dmin: torch.Tensor
    dmax: torch.Tensor
    qbits: int


def _qbits(total_tiles: int) -> int:
    qbits = 31 - int(total_tiles + 1).bit_length()
    if qbits < 12:
        raise ValueError(
            f"pack_sort_key: only {qbits} depth bits left under "
            f"{total_tiles} tile ids (batch * tiles too large for the packed "
            f"i32 sort key); shrink the batch")
    return qbits


def _depth_range(depth, live):
    """(min, max) of depth where live; (0, 1) when nothing is."""
    dmin = torch.where(live, depth, torch.inf).min()
    dmax = torch.where(live, depth, -torch.inf).max()
    return (torch.where(torch.isfinite(dmin), dmin, 0.0),
            torch.where(torch.isfinite(dmax), dmax, 1.0))


def pack_sort_key(tile_i, depth, total_tiles: int,
                  depth_key: Optional[DepthKey] = None):
    """(tile, depth) packed into ONE i32 key, exactly as JAX packs it.

    Depth is quantized to the qbits = 31 - bit_length(total_tiles + 1) bits
    under the tile id, over [dmin, dmax] of the LIVE pairs, and clamped in
    integers; `depth_key` imposes another range and qbits (a band of a view
    takes the whole view's, `view_depth_key`). Dead pairs carry the
    sentinel tile `total_tiles` and sort last. Returns (key, qbits)."""
    live = tile_i < total_tiles
    if depth_key is None:
        qbits = _qbits(total_tiles)
        dmin, dmax = _depth_range(depth, live)
    else:
        dmin, dmax, qbits = depth_key
        if (total_tiles + 1) << qbits > 1 << 31:
            raise ValueError(f"pack_sort_key: {total_tiles} tile ids do not "
                             f"fit above {qbits} depth bits")
    dd = torch.where(live, depth, dmin)
    levels = torch.tensor(2.0 ** qbits - 1.0, dtype=torch.float32,
                          device=depth.device)
    scale = levels / torch.clamp_min(dmax - dmin, 1e-20)
    qd = torch.clamp(torch.clamp_min((dd - dmin) * scale, 0.0)
                     .to(torch.int32), 0, (1 << qbits) - 1)
    return tile_i * (1 << qbits) + qd, qbits


def view_depth_key(stacked, height: int, width: int,
                   ellipse: bool = False) -> DepthKey:
    """The DepthKey with which a one-view render of the (N, 11) rows
    `stacked` sorts its pairs: the depth range of the rows whose rectangle
    (circle, or with `ellipse` the ellipse's box) covers a tile, and the
    qbits of the view's tile count."""
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    if ellipse:
        rx, ry = ellipse_radii(stacked[:, 2:5], stacked[:, 10])
        total = tile_rects_xy(stacked[:, 0:2], rx, ry, tiles_y, tiles_x,
                              TILE, 1)[3]
    else:
        total = tile_rects(stacked[:, 0:2], stacked[:, 10], tiles_y,
                           tiles_x, TILE, 1)[3]
    dmin, dmax = _depth_range(stacked[:, 9], total > 0)
    return DepthKey(dmin, dmax, _qbits(tiles_y * tiles_x))


class _GatherPairs(torch.autograd.Function):
    """Sorted pair columns from per-Gaussian rows: pair p takes columns
    0..8 of row slot[p] // K, where slot = the kept head of the sort's
    permutation of the n * K (Gaussian, duplicate) slots.

    The backward is the counterpart of `_pair_sort_bwd` (:322): the pair
    gradients go back to their pre-sort slots with a copy (the slots are
    unique, so nothing accumulates and no atomics run), then each
    Gaussian's K duplicates are summed in slot order. Two runs give the same
    bits, which autograd's index_put backward of `flat[gauss]` does not."""

    @staticmethod
    def forward(ctx, flat, slot, max_tiles: int):
        ctx.save_for_backward(slot)
        ctx.shape = (flat.shape[0], max_tiles)
        return flat[slot // max_tiles, :NPROP].t().contiguous()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_props):
        (slot,) = ctx.saved_tensors
        n, k = ctx.shape
        buf = g_props.new_zeros((NPROP, n * k))
        buf.index_copy_(1, slot, g_props)
        g_flat = g_props.new_zeros((n, STACKW))
        g_flat[:, :NPROP] = buf.reshape(NPROP, n, k).sum(dim=2).t()
        return g_flat, None, None


def sort_pairs(stacked, height: int, width: int, max_tiles: int,
               max_per_tile: int, pair_budget,
               depth_key: Optional[DepthKey] = None):
    """Duplicate each Gaussian into its tiles and sort by (tile, depth).

    stacked: (B, C, 11) rows from `stack_rows`. The whole batch shares one
    sort, tile ids offset by b * tiles per sample.
    Returns (props (9, P) f32, start (B*T,) i32, count (B*T,) i32,
    num_dup_dropped (B,), num_pair_dropped (B,)), with the counters int64:
    pairs lost to the duplication cap, and to max_per_tile / pair_budget.
    `props` is differentiable with respect to columns 0..8 of `stacked`;
    the binning keys (mean2d and radius for the rectangles, depth for the
    order) are positional and carry no gradient.
    """
    batch, n = stacked.shape[0], stacked.shape[1]
    dev = stacked.device
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    num_tiles = tiles_y * tiles_x
    rows = stacked.reshape(batch * n, STACKW)
    flat = rows.detach()

    x_min, y_min, span_x, total, total_uncapped = tile_rects(
        flat[:, 0:2], flat[:, 10], tiles_y, tiles_x, TILE, max_tiles)
    num_dropped = (total_uncapped - total).reshape(batch, n).sum(1)

    dx, dy = expand_rect_offsets(torch.clamp_min(span_x, 1), max_tiles)
    k = torch.arange(max_tiles, dtype=torch.int32, device=dev)
    pair_live = k[None, :] < total[:, None]
    tile_id = (y_min[:, None] + dy) * tiles_x + (x_min[:, None] + dx)
    boff = torch.arange(batch, dtype=torch.int32, device=dev) * num_tiles
    tile_id = tile_id + boff.repeat_interleave(n)[:, None]
    tile_id = torch.where(pair_live, tile_id, batch * num_tiles)

    nK = batch * n * max_tiles
    p_lim = nK if pair_budget is None else min(batch * int(pair_budget), nK)
    P = -(-p_lim // CHUNK) * CHUNK

    depth_b = flat[:, 9:10].expand(-1, max_tiles).reshape(-1)
    key, qbits = pack_sort_key(tile_id.reshape(-1), depth_b,
                               batch * num_tiles, depth_key)
    key_s, perm = torch.sort(key, stable=True)

    marks = torch.arange(batch * num_tiles + 1, dtype=torch.int32,
                         device=dev) * (1 << qbits)
    bounds = torch.searchsorted(key_s, marks)
    start = torch.clamp_max(bounds[:-1], P)
    end = torch.clamp_max(bounds[1:], P)
    count = torch.clamp_max(end - start, max_per_tile)

    props = _GatherPairs.apply(rows, perm[:min(P, nK)], max_tiles)
    num_pair_dropped = (total.reshape(batch, n).sum(1)
                        - count.reshape(batch, num_tiles).sum(1))
    return (props, start.to(torch.int32), count.to(torch.int32),
            num_dropped, num_pair_dropped)


def untile(x, batch: int, height: int, width: int):
    """(B*T, 256, C) tile-major pixels -> (B, H, W, C)."""
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    ch = x.shape[-1]
    x = x.reshape(batch, tiles_y, tiles_x, TILE, TILE, ch)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, tiles_y * TILE, tiles_x * TILE,
                     ch)[:, :height, :width]


def _composite_images(props, start, count, batch: int, height: int,
                      width: int, bg_color):
    """Composite sorted pairs: (image (B, H, W, 3) over `bg_color`,
    transmittance (B, H, W, 1))."""
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    out = composite(props, start, count, tiles_y, tiles_x)
    img_tiles = out[..., 0:3] + out[..., 3:4] * bg_color[None, None, :]
    return (untile(img_tiles, batch, height, width),
            untile(out[..., 3:4], batch, height, width))


def render_sorted(stacked, height: int, width: int, max_tiles: int,
                  max_per_tile: int, pair_budget, bg_color,
                  depth_key: Optional[DepthKey] = None):
    """(B, C, 11) stacked rows -> (image (B, H, W, 3), transmittance
    (B, H, W, 1), num_dup_dropped (B,), num_pair_dropped (B,)).

    pair_budget is per sample; when it binds, truncation falls on the
    globally last sorted pairs (the highest batch indices' deepest tiles),
    and the drops are counted per sample either way. Differentiable with
    respect to columns 0..8 of `stacked` (`sort_pairs`, `composite`)."""
    props, start, count, num_dropped, num_pair_dropped = sort_pairs(
        stacked, height, width, max_tiles, max_per_tile, pair_budget,
        depth_key)
    return _composite_images(props, start, count, stacked.shape[0], height,
                             width, bg_color) + (num_dropped,
                                                 num_pair_dropped)


# ------------------------------------------------------------- the staircase
#
# The legacy path gives every row max_tiles_per_gaussian duplicate slots, so
# its sort runs over rows * K pairs, most of them dead. The staircase sorts
# each sample's rows by descending tile span and hands out slots by rank: the
# first count_0 rows get K_0 slots, the next count_1 get K_1, and so on.
# Spans beyond a row's class capacity, and every span of the rows past the
# schedule, are counted in num_dropped like the legacy cap.

SPAN_KEY_MAX = 63   # the span field of the row key is 6 bits


def validate_span_schedule(span_schedule, fg_cap: int, batch: int = 1):
    """The JAX package's static checks of a staircase schedule (:507-527);
    raises ValueError on any violation. The limits come from its i32 row key
    b (3 bits) | 63 - span (6) | slot (22); the port packs the same fields
    into int64 and keeps the same limits."""
    if batch * (1 << 28) > 2 ** 31:
        raise ValueError("staircase span key packs b|span|slot into i32: "
                         f"batch {batch} > 8 unsupported")
    if fg_cap > 1 << 22:
        raise ValueError(f"staircase span key: fg_cap {fg_cap} > 2^22")
    counts = [c for _, c in span_schedule]
    if sum(counts) > fg_cap:
        raise ValueError(f"span_schedule covers {sum(counts)} rows > "
                         f"fg_cap {fg_cap}")
    if any(k > SPAN_KEY_MAX for k, _ in span_schedule):
        raise ValueError("span_schedule K > 63 (span key uses 6 bits)")


def sort_rows_by_key(key, rows):
    """rows (N, C) reordered by the UNIQUE integer `key`: returns (sorted
    rows, the permutation). The backward un-sorts the rows' gradient with a
    copy (`take_rows_unique`), the counterpart of JAX's second sort."""
    perm = torch.sort(key).indices
    return take_rows_unique(rows, perm), perm


class _BroadcastRows(torch.autograd.Function):
    """(M, 9) rows -> (9, M * K) pair columns, row m's K duplicates at
    m * K .. m * K + K - 1. The backward sums each row's K pair gradients
    with the same reduction, on the same layout, as `_GatherPairs`."""

    @staticmethod
    def forward(ctx, rows, k: int):
        ctx.k = k
        return rows.t()[:, :, None].expand(-1, -1, k).reshape(
            NPROP, rows.shape[0] * k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return g.reshape(NPROP, -1, ctx.k).sum(dim=2).t(), None


class _SortPairsPre(torch.autograd.Function):
    """Sorted pair columns (9, len(perm)) taken from pre-broadcast ones
    (9, P_in). The backward copies each pair's gradient back to its
    pre-sort slot: the slots are unique, so nothing accumulates and no
    atomics run (JAX sorts a second time by slot)."""

    @staticmethod
    def forward(ctx, props_in, perm):
        ctx.save_for_backward(perm)
        ctx.n = props_in.shape[1]
        return props_in[:, perm].contiguous()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        g_in = g.new_zeros((NPROP, ctx.n))
        g_in.index_copy_(1, perm, g)
        return g_in, None


def sort_pairs_pre(props_in, tile_id, depth, tie, P: int, num_tiles: int,
                   max_per_tile: int, depth_key: Optional[DepthKey] = None):
    """The pair sort of pre-broadcast pairs (`_pair_sort_pre` :427-504).

    props_in (9, P_in) pair columns, tile_id (P_in,) int32 (sentinel
    `num_tiles` for dead pairs), depth (P_in,), tie (P_in,) int64 in
    [0, 2^31): a unique order among pairs of one packed (tile | depth) key.
    Returns (props (9, min(P, P_in)), start, count (num_tiles,) int32),
    differentiable with respect to props_in."""
    key, qbits = pack_sort_key(tile_id, depth, num_tiles, depth_key)
    key_s, perm = torch.sort((key.to(torch.int64) << 31) | tie)
    marks = (torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=key.device) << qbits) << 31
    bounds = torch.searchsorted(key_s, marks)
    start = torch.clamp_max(bounds[:-1], P)
    end = torch.clamp_max(bounds[1:], P)
    count = torch.clamp_max(end - start, max_per_tile)
    props = _SortPairsPre.apply(props_in, perm[:min(P, perm.shape[0])])
    return props, start.to(torch.int32), count.to(torch.int32)


def staircase_pairs(stacked, height: int, width: int, span_schedule,
                    max_per_tile: int, pair_budget, ellipse: bool = False,
                    depth_key: Optional[DepthKey] = None):
    """`sort_pairs` with the span-staircase expansion (:530-640).

    span_schedule: ((K_0, count_0), (K_1, count_1), ...) per sample, K
    descending; rank r of a sample's span-sorted rows gets the K of its
    class, and the pair sort runs over batch * sum(K_c count_c) pairs.
    ellipse=True bins with the 3-sigma ellipse's bounding box
    (`ellipse_radii`) instead of the circumscribed circle. pair_budget is
    per sample. Ties of the packed key go to the lower original row, then
    duplicate, as in the legacy stable sort. Returns what `sort_pairs`
    returns."""
    batch, n = stacked.shape[0], stacked.shape[1]
    dev = stacked.device
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    num_tiles = tiles_y * tiles_x
    validate_span_schedule(span_schedule, n, batch)
    rows = stacked.reshape(batch * n, STACKW)
    flat = rows.detach()

    def rects(meta, k_cap):
        if ellipse:
            rx, ry = ellipse_radii(meta[:, 2:5], meta[:, 10])
            return tile_rects_xy(meta[:, 0:2], rx, ry, tiles_y, tiles_x,
                                 TILE, k_cap)
        return tile_rects(meta[:, 0:2], meta[:, 10], tiles_y, tiles_x, TILE,
                          k_cap)

    # each sample's rows by descending span (uncapped, clamped to 6 bits),
    # then by slot: b | 63 - span | slot, unique
    span6 = torch.clamp(rects(flat, SPAN_KEY_MAX)[4], 0, SPAN_KEY_MAX)
    slot = torch.arange(batch * n, dtype=torch.int64, device=dev)
    key = ((slot // n) << 28) + ((SPAN_KEY_MAX - span6.long()) << 22) \
        + slot % n
    rows_s, order = sort_rows_by_key(key, rows[:, :NPROP])
    meta = flat[order].reshape(batch, n, STACKW)
    rows_s = rows_s.reshape(batch, n, NPROP)
    orig = order.reshape(batch, n)

    num_dropped = torch.zeros(batch, dtype=torch.int64, device=dev)
    total_capped = torch.zeros(batch, dtype=torch.int64, device=dev)
    pieces, tiles, depths, ties = [], [], [], []
    boff = torch.arange(batch, dtype=torch.int32, device=dev) * num_tiles
    off = 0
    for k_c, cnt in span_schedule:
        m = meta[:, off:off + cnt].reshape(batch * cnt, STACKW)
        x_min, y_min, span_x, tc, tu = rects(m, k_c)
        num_dropped += (tu - tc).reshape(batch, cnt).sum(1)
        total_capped += tc.reshape(batch, cnt).sum(1)
        dx, dy = expand_rect_offsets(torch.clamp_min(span_x, 1), k_c)
        kk = torch.arange(k_c, dtype=torch.int32, device=dev)
        tid = (y_min[:, None] + dy) * tiles_x + (x_min[:, None] + dx) \
            + boff.repeat_interleave(cnt)[:, None]
        tid = torch.where(kk[None, :] < tc[:, None], tid, batch * num_tiles)
        tiles.append(tid.reshape(-1))
        depths.append(m[:, 9:10].expand(-1, k_c).reshape(-1))
        ties.append((orig[:, off:off + cnt].reshape(-1, 1) * (
            SPAN_KEY_MAX + 1) + kk[None, :]).reshape(-1))
        pieces.append(_BroadcastRows.apply(
            rows_s[:, off:off + cnt].reshape(batch * cnt, NPROP), k_c))
        off += cnt
    if off < n:
        tail = meta[:, off:].reshape(batch * (n - off), STACKW)
        num_dropped += rects(tail, SPAN_KEY_MAX)[4].reshape(
            batch, n - off).sum(1)

    props_in = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
    p_in = props_in.shape[1]
    p_lim = p_in if pair_budget is None else min(batch * int(pair_budget),
                                                 p_in)
    props, start, count = sort_pairs_pre(
        props_in, torch.cat(tiles), torch.cat(depths), torch.cat(ties),
        -(-p_lim // CHUNK) * CHUNK, batch * num_tiles, max_per_tile,
        depth_key)
    num_pair_dropped = total_capped - count.reshape(batch, num_tiles).sum(1)
    return props, start, count, num_dropped, num_pair_dropped


def render_sorted_staircase(stacked, height: int, width: int, span_schedule,
                            max_per_tile: int, pair_budget, bg_color,
                            ellipse: bool = False,
                            depth_key: Optional[DepthKey] = None):
    """`render_sorted` with the span-staircase expansion
    (`staircase_pairs`, :530-651). Returns what `render_sorted` returns."""
    props, start, count, num_dropped, num_pair_dropped = staircase_pairs(
        stacked, height, width, span_schedule, max_per_tile, pair_budget,
        ellipse, depth_key)
    return _composite_images(props, start, count, stacked.shape[0], height,
                             width, bg_color) + (num_dropped,
                                                 num_pair_dropped)
