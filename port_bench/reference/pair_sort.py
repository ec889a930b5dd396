# Frozen copy of gps_gaussian_tpu_torch/kernels/rasterizer/pair_sort.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Tile binning, the (tile | depth) pair sort and the sorted render, on
the legacy uniform-K path: `stack_rows`, `tile_rects`,
`expand_rect_offsets`, `pack_sort_key`, `sort_pairs` (one stable sort of
the packed i32 key; ties keep slot order) with its backward
(`_GatherPairs`: pair gradients copied back to their unique slots, then
each Gaussian's K duplicates summed in slot order), and `render_sorted`.
Pairs are laid out (9, P) structure-of-arrays."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from port_bench.reference.composite import (TILE,
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
