"""Tile-row-sharded rendering over a torch.distributed group.

Counterpart of gps_gaussian_tpu/kernels/rasterizer/sharded.py: the novel
image's rows of 16-pixel tiles are cut into one band per rank. Every rank
holds the same Gaussians (the caller broadcasts them), keeps those whose
screen rectangle overlaps its band (`_band_compact`, :38-62), renders its
band with the usual pair sort and composite kernels, and the bands are
gathered into the full image. Per-rank work (pair sort length, kernel
pairs, output pixels) shrinks with the number of ranks.

One difference from the JAX package: JAX quantizes each band's sort depths
over that band's own pairs and tile count, so pairs of near-equal depth
can blend in another order than in the whole view's render (on a trained
2048^2 frame the images differ by up to 0.03). Here every band sorts with
the whole view's quantization (`view_depth_key`), so the bands give the
one-process render's pair order, and its image wherever no cap binds.

`render_band` is one rank's part; `render_bands` computes every band in one
process (the same bits as the group's render, for checking it);
`rasterize_tile_sharded` runs over a process group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeAux,
                                                       RasterizeConfig,
                                                       _dispatch_render)
from gps_gaussian_tpu_torch.kernels.rasterizer.compaction import (
    live_first_order, take_rows_unique)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import TILE
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    stack_rows, view_depth_key)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians, NovelCamera
from gps_gaussian_tpu_torch.utils.device import resolve_device


def band_height(height: int, world: int) -> int:
    """Pixel rows of one band: the tile rows padded up to a multiple of
    `world`, split evenly (:79-84)."""
    tiles_y = -(-height // TILE)
    return -(-tiles_y // world) * TILE


def band_cap(n: int, world: int, cfg: RasterizeConfig) -> int:
    """Rows a band keeps (:91-95): cfg.fg_cap when set, else twice an even
    split rounded up to 128, at least 1024 and at most n."""
    if cfg.fg_cap is not None:
        return cfg.fg_cap
    return min(n, max(-(-2 * n // (world * 128)) * 128, 1024))


def _band_compact(stacked, y0: float, band_h: int, cap: int):
    """Keep the rows whose screen rectangle overlaps pixel rows
    [y0, y0 + band_h), in order, in `cap` rows; shift their mean's row by
    -y0 and kill the slots past the kept rows through radius * live.
    Returns (stacked (cap, 11), n_dropped ())."""
    my, radius = stacked[:, 1], stacked[:, 10]
    keep = (radius > 0.0) & (my + radius >= y0) & (my - radius < y0 + band_h)
    n = stacked.shape[0]
    idx, live, n_dropped = live_first_order(keep, cap)
    if idx is not None:
        stacked = take_rows_unique(stacked, idx)
    elif cap > n:
        stacked = torch.nn.functional.pad(stacked, (0, 0, 0, cap - n))
    stacked = torch.cat([stacked[:, 0:1], stacked[:, 1:2] - y0,
                         stacked[:, 2:10], stacked[:, 10:11] * live[:, None]],
                        dim=1)
    return stacked, n_dropped


def render_band(gaussians: FlatGaussians, camera: NovelCamera, bg_color,
                cfg: RasterizeConfig, rank: int, world: int, device="cuda"):
    """Band `rank` of `world` of a batch-1 render (the body of `shard_fn`,
    :97-129). Projects at the true H x W; the band is `band_height` pixel
    rows from row rank * band_height. Returns (image (1, band_h, W, 3),
    RasterizeAux of the band: transmittance (1, band_h, W, 1) and counters
    (1,), num_fg_dropped counting the rows the band cap dropped)."""
    if gaussians.xyz.shape[0] != 1:
        raise ValueError("tile-sharded rendering is per frame (batch 1): "
                         "the ranks share the tile grid, not the batch")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = resolve_device(device)
    g = gaussians.to(dev)
    cam = camera.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    band_h = band_height(cam.height, world)
    cap = band_cap(g.xyz.shape[1], world, cfg)
    p = project_gaussians(g.xyz[0], g.rot[0], g.scale[0], g.opacity[0],
                          g.rgb[0], g.valid[0], cam.view[0], cam.proj[0],
                          cam.tanfovx[0], cam.tanfovy[0], cam.height,
                          cam.width)
    stacked = stack_rows(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                         p.radius)
    key = view_depth_key(stacked.detach(), cam.height, cam.width,
                         cfg.span_schedule is not None and cfg.ellipse_rects)
    stacked, band_dropped = _band_compact(stacked, float(rank * band_h),
                                          band_h, cap)
    img, trans, num_dropped, num_pair_dropped = _dispatch_render(
        stacked[None], band_h, cam.width, cfg, bg, key)
    return img, RasterizeAux(transmittance=trans, num_dropped=num_dropped,
                             num_fg_dropped=band_dropped[None],
                             num_pair_dropped=num_pair_dropped)


def _assemble(bands, counters, height: int):
    """(1, band_h, W, 4) bands in rank order and summed (3,) counters ->
    (image, RasterizeAux) cropped to `height` rows."""
    full = torch.cat(bands, dim=1)[:, :height]
    return full[..., 0:3], RasterizeAux(
        transmittance=full[..., 3:4], num_dropped=counters[0:1],
        num_fg_dropped=counters[1:2], num_pair_dropped=counters[2:3])


def _band_out(img, aux):
    counters = torch.stack([aux.num_dropped[0], aux.num_fg_dropped[0],
                            aux.num_pair_dropped[0]]).to(torch.int64)
    return torch.cat([img, aux.transmittance], dim=-1).contiguous(), counters


def render_bands(gaussians: FlatGaussians, camera: NovelCamera, bg_color,
                 cfg: RasterizeConfig, world: int, device="cuda"):
    """The result of `rasterize_tile_sharded` over `world` ranks, computed
    band by band in one process. Returns (image (1, H, W, 3), RasterizeAux
    with the counters summed over the bands)."""
    outs = [_band_out(*render_band(gaussians, camera, bg_color, cfg, r,
                                   world, device)) for r in range(world)]
    return _assemble([b for b, _ in outs],
                     torch.stack([c for _, c in outs]).sum(0),
                     camera.height)


def rasterize_tile_sharded(gaussians: FlatGaussians, camera: NovelCamera,
                           bg_color, cfg: RasterizeConfig,
                           group: Optional[dist.ProcessGroup] = None,
                           device="cuda"):
    """Render batch-1 Gaussians into one camera, the tile rows sharded over
    the ranks of `group` (:65-144). Every rank must pass the same Gaussians
    and camera. Each renders its band, the bands are all-gathered and the
    counters summed over the group, so every rank returns the whole
    (image (1, H, W, 3), RasterizeAux) that `render_bands` gives."""
    world = dist.get_world_size(group)
    band, counters = _band_out(*render_band(
        gaussians, camera, bg_color, cfg, dist.get_rank(group), world,
        device))
    bands = [torch.empty_like(band) for _ in range(world)]
    dist.all_gather(bands, band, group=group)
    dist.all_reduce(counters, group=group)
    return _assemble(bands, counters, camera.height)
