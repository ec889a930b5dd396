"""Differentiable tile-binned Gaussian-splat rasterizer (public API).

Counterpart of gps_gaussian_tpu/kernels/rasterizer/__init__.py on its
Pallas route: optional foreground compaction, EWA projection, one
(tile | depth) pair sort for the whole batch (the legacy uniform-K binning,
or the span staircase when `span_schedule` is set), then the tiled
composite (`composite.composite`: the CUDA kernels on
the GPU, their plain versions on the CPU). Capacities are static and every
drop is counted in `RasterizeAux`, never silent. Gradients flow to xyz,
rot, scale, opacity and rgb; the sort order and the tile rectangles are
treated as fixed, and culled or invalid rows get exactly zero. Spans
(utils/profiling.py): `raster.project` (compaction and projection of each
sample), `raster.sort` (binning and the pair sort, pair_sort.py) and
`raster.composite` (the composite's forward launch).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gps_gaussian_tpu_torch.kernels.rasterizer.compaction import (
    live_first_order, take_rows_unique)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    render_sorted, render_sorted_staircase, stack_rows)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import \
    composite_reference
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians, NovelCamera
from gps_gaussian_tpu_torch.utils.device import resolve_device
from gps_gaussian_tpu_torch.utils.profiling import device_span


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static capacities; every cap counts what it drops. Tiles are
    16 x 16 pixels."""

    max_tiles_per_gaussian: int = 64   # per-Gaussian tile-duplication cap
    max_per_tile: int = 1024           # depth-sorted per-tile blend cap
    fg_cap: Optional[int] = None       # foreground compaction (None = off)
    pair_budget: Optional[int] = None  # cap on sorted pairs per sample
    # span staircase: ((K_c, count_c), ...) per sample, K descending; rows
    # span-sorted, rank classes get K_c duplicate slots. None = the uniform
    # max_tiles_per_gaussian expansion
    span_schedule: Optional[tuple] = None
    # staircase only: bin with the 3-sigma ellipse's bounding box instead
    # of the circumscribed circle (never more pairs)
    ellipse_rects: bool = False


class RasterizeAux(NamedTuple):
    transmittance: torch.Tensor     # (B, H, W, 1) final per-pixel T
    num_dropped: torch.Tensor       # (B,) pairs lost to the duplication cap
    num_fg_dropped: torch.Tensor    # (B,) gaussians lost to fg_cap
    num_pair_dropped: torch.Tensor  # (B,) pairs lost to max_per_tile /
                                    # pair_budget


def compact_super_rows(fields, valid_f: torch.Tensor, cap: int):
    """Keep the first cap / 8 groups of 8 consecutive rows that hold a valid
    row, whole: their dead rows come along with valid 0.

    The port of the JAX package's super-row compaction
    (compact_gaussian_inputs :100-169, compact_valid freeview.py:30-85),
    with its row layout: kept row i is JAX's kept row i. Rows are padded
    with zeros to a multiple of 8; slots past the live groups are zero.
    Each field is gathered on its own (`take_rows_unique`), so outputs and
    gradients stay contiguous. `fields` are (N, c) tensors, `valid_f` is
    (N,) in {0, 1}, `cap` < N is a multiple of 8. Returns (the fields with
    `cap` rows, valid (cap,), n_dropped ()): the valid rows of the groups
    past the cap, int64."""
    npad = (-valid_f.shape[0]) % 8
    if npad:
        fields = [torch.nn.functional.pad(f, (0, 0, 0, npad)) for f in fields]
        valid_f = torch.nn.functional.pad(valid_f, (0, npad))
    n8 = valid_f.shape[0] // 8
    per_group = valid_f.reshape(n8, 8).to(torch.int64).sum(1)
    live_group = per_group > 0
    idx, slot_live, _ = live_first_order(live_group, cap // 8)
    rank = torch.cumsum(live_group.to(torch.int64), 0) - live_group.long()
    kept = live_group & (rank < cap // 8)
    n_dropped = per_group.sum() - (per_group * kept).sum()
    rows = (idx[:, None] * 8 + torch.arange(8, device=idx.device)).reshape(-1)
    live = slot_live.repeat_interleave(8)
    out = tuple(take_rows_unique(f.float(), rows) * live[:, None]
                for f in fields)
    return out + (valid_f[rows] * live,), n_dropped


def compact_gaussian_inputs(g: FlatGaussians, b: int, cap: int):
    """Pack sample b's valid Gaussians into `cap` rows (`compact_super_rows`:
    groups of 8 rows that hold a valid row are kept whole, in order, and the
    valid rows of the groups past the cap are counted). A cap of at least N
    pads in place; a smaller one must be a multiple of 8, and N is padded up
    to one. Returns ((xyz, rot, scale, opacity (cap, 1), rgb, valid),
    n_dropped)."""
    fields = (g.xyz[b], g.rot[b], g.scale[b], g.opacity[b].reshape(-1, 1),
              g.rgb[b])
    n = fields[0].shape[0]
    valid_f = (g.valid[b].reshape(n) > 0.5).float()
    if cap >= n:
        pad = cap - n
        out = tuple(torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                    for x in fields)
        live = torch.nn.functional.pad(valid_f, (0, pad))
        return out + (live,), torch.zeros((), dtype=torch.int64,
                                          device=valid_f.device)
    if cap % 8:
        raise ValueError(
            f"compact_gaussian_inputs: cap={cap} must be a multiple of 8 "
            f"(rows are kept in groups of 8)")
    return compact_super_rows(fields, valid_f, cap)


def _dispatch_render(stacked, height: int, width: int,
                     cfg: RasterizeConfig, bg, depth_key=None):
    """The sorted render of `cfg`'s binning (JAX :172-185): the staircase
    when `span_schedule` is set, else the uniform-K expansion. `depth_key`
    (pair_sort.DepthKey) imposes the depth quantization."""
    if cfg.span_schedule is not None:
        return render_sorted_staircase(
            stacked, height, width, cfg.span_schedule, cfg.max_per_tile,
            cfg.pair_budget, bg, ellipse=cfg.ellipse_rects,
            depth_key=depth_key)
    return render_sorted(stacked, height, width, cfg.max_tiles_per_gaussian,
                         cfg.max_per_tile, cfg.pair_budget, bg, depth_key)


def rasterize(gaussians: FlatGaussians, camera: NovelCamera, bg_color,
              cfg: RasterizeConfig = RasterizeConfig(), device="cuda"):
    """Batched render: (B, N) Gaussians into (B,) cameras.

    Runs on `device` (CUDA unless the caller asks for the CPU); inputs are
    moved there. Differentiable with respect to the Gaussians' xyz, rot,
    scale, opacity and rgb. Returns (images (B, H, W, 3), RasterizeAux with
    per-sample counters (B,) and transmittance (B, H, W, 1)).
    """
    dev = resolve_device(device)
    gaussians = gaussians.to(dev)
    camera = camera.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    h, w = camera.height, camera.width

    stacked, fg_dropped = [], []
    with device_span("raster.project", dev):
        for b in range(gaussians.xyz.shape[0]):
            if cfg.fg_cap is not None:
                (xyz, rot, scale, opacity, rgb, valid), n_drop = \
                    compact_gaussian_inputs(gaussians, b, cfg.fg_cap)
            else:
                xyz, rot, scale, opacity, rgb, valid = (
                    gaussians.xyz[b], gaussians.rot[b], gaussians.scale[b],
                    gaussians.opacity[b], gaussians.rgb[b],
                    gaussians.valid[b])
                n_drop = torch.zeros((), dtype=torch.int64, device=dev)
            projd = project_gaussians(xyz, rot, scale, opacity, rgb, valid,
                                      camera.view[b], camera.proj[b],
                                      camera.tanfovx[b], camera.tanfovy[b],
                                      h, w)
            stacked.append(stack_rows(projd.mean2d, projd.conic,
                                      projd.opacity, projd.color,
                                      projd.depth, projd.radius))
            fg_dropped.append(n_drop)
    img, trans, num_dropped, num_pair_dropped = _dispatch_render(
        torch.stack(stacked), h, w, cfg, bg)
    return img, RasterizeAux(transmittance=trans, num_dropped=num_dropped,
                             num_fg_dropped=torch.stack(fg_dropped),
                             num_pair_dropped=num_pair_dropped)


def rasterize_single(xyz, rot, scale, opacity, color, valid, view, proj,
                     tanfovx, tanfovy, height: int, width: int, bg_color,
                     cfg: RasterizeConfig = RasterizeConfig(),
                     device="cuda"):
    """One Gaussian set (N, ...) into one camera: `rasterize` at batch 1.
    Returns (image (H, W, 3), RasterizeAux with scalar counters and
    transmittance (H, W, 1))."""
    gauss = FlatGaussians(xyz=xyz[None], rgb=color[None], rot=rot[None],
                          scale=scale[None], opacity=opacity[None],
                          valid=valid[None])
    cam = NovelCamera(view=view[None], proj=proj[None],
                      cam_center=torch.zeros((1, 3), dtype=view.dtype,
                                             device=view.device),
                      tanfovx=torch.as_tensor(tanfovx,
                                              dtype=torch.float32).reshape(1),
                      tanfovy=torch.as_tensor(tanfovy,
                                              dtype=torch.float32).reshape(1),
                      height=height, width=width)
    img, aux = rasterize(gauss, cam, bg_color, cfg, device=device)
    return img[0], RasterizeAux(*(x[0] for x in aux))


def rasterize_reference_single(xyz, rot, scale, opacity, color, valid,
                               view, proj, tanfovx, tanfovy, height: int,
                               width: int, bg_color) -> torch.Tensor:
    """The exact slow oracle of `rasterize_single` (JAX :248): every pixel
    composites all N Gaussians (`reference.composite_reference`), on the
    inputs' device. Returns the image (H, W, 3); differentiable."""
    projd = project_gaussians(xyz, rot, scale, opacity, color, valid, view,
                              proj, tanfovx, tanfovy, height, width)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=xyz.device)
    return composite_reference(projd, bg, height, width)
