"""Differentiable tile-binned Gaussian-splat rasterizer (public API).

Counterpart of gps_gaussian_tpu/kernels/rasterizer/__init__.py on its
Pallas route with the legacy uniform-K binning: optional foreground
compaction, EWA projection, one (tile | depth) pair sort for the whole
batch, then the tiled composite (`composite.composite`: the CUDA kernels on
the GPU, their plain versions on the CPU). Capacities are static and every
drop is counted in `RasterizeAux`, never silent. Gradients flow to xyz,
rot, scale, opacity and rgb; the sort order and the tile rectangles are
treated as fixed, and culled or invalid rows get exactly zero.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gps_gaussian_tpu_torch.kernels.rasterizer.compaction import \
    live_first_order
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    render_sorted, stack_rows)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians, NovelCamera
from gps_gaussian_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static capacities; every cap counts what it drops. Tiles are
    16 x 16 pixels."""

    max_tiles_per_gaussian: int = 64   # per-Gaussian tile-duplication cap
    max_per_tile: int = 1024           # depth-sorted per-tile blend cap
    fg_cap: Optional[int] = None       # foreground compaction (None = off)
    pair_budget: Optional[int] = None  # cap on sorted pairs per sample


class RasterizeAux(NamedTuple):
    transmittance: torch.Tensor     # (B, H, W, 1) final per-pixel T
    num_dropped: torch.Tensor       # (B,) pairs lost to the duplication cap
    num_fg_dropped: torch.Tensor    # (B,) gaussians lost to fg_cap
    num_pair_dropped: torch.Tensor  # (B,) pairs lost to max_per_tile /
                                    # pair_budget


class _TakeRowsUnique(torch.autograd.Function):
    """x[idx] for UNIQUE row indices, with a copy as its backward.

    Counterpart of `take_rows_unique` (pallas_kernel.py:72-99). Autograd's
    own backward of x[idx] is index_put with accumulation, which on CUDA
    adds with float atomics; the indices are unique, so a plain row copy
    into zeros gives the same gradient with the same bits every run."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        out.index_copy_(0, idx, g)
        return out, None


def take_rows_unique(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather x[idx]; `idx` (int64) must hold no index twice."""
    return _TakeRowsUnique.apply(x, idx)


def compact_gaussian_inputs(g: FlatGaussians, b: int, cap: int):
    """Pack sample b's valid Gaussians into the first `cap` rows.

    Row-exact: the first `cap` valid rows are kept in order, and the valid
    rows beyond the cap are counted. The JAX package moves 8-row super-rows
    instead (a TPU DMA layout, compact_gaussian_inputs :100); when the cap
    does not bind both render the same image, since dead rows make no
    pairs. When it binds, JAX keeps only the valid rows of the first cap/8
    live super-rows, so the two drop different rows and count differently.
    Returns ((xyz, rot, scale, opacity, rgb, valid), n_dropped).
    """
    fields = (g.xyz[b], g.rot[b], g.scale[b], g.opacity[b].reshape(-1, 1),
              g.rgb[b])
    n = fields[0].shape[0]
    keep = g.valid[b].reshape(n) > 0.5
    idx, live, n_dropped = live_first_order(keep, cap)
    if idx is None:
        pad = cap - n
        out = tuple(torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                    for x in fields)
        return out + (live,), n_dropped
    out = tuple(take_rows_unique(x.float(), idx) * live[:, None]
                for x in fields)
    return out + (live,), n_dropped


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
    for b in range(gaussians.xyz.shape[0]):
        if cfg.fg_cap is not None:
            (xyz, rot, scale, opacity, rgb, valid), n_drop = \
                compact_gaussian_inputs(gaussians, b, cfg.fg_cap)
        else:
            xyz, rot, scale, opacity, rgb, valid = (
                gaussians.xyz[b], gaussians.rot[b], gaussians.scale[b],
                gaussians.opacity[b], gaussians.rgb[b], gaussians.valid[b])
            n_drop = torch.zeros((), dtype=torch.int64, device=dev)
        projd = project_gaussians(xyz, rot, scale, opacity, rgb, valid,
                                  camera.view[b], camera.proj[b],
                                  camera.tanfovx[b], camera.tanfovy[b], h, w)
        stacked.append(stack_rows(projd.mean2d, projd.conic, projd.opacity,
                                  projd.color, projd.depth, projd.radius))
        fg_dropped.append(n_drop)
    img, trans, num_dropped, num_pair_dropped = render_sorted(
        torch.stack(stacked), h, w, cfg.max_tiles_per_gaussian,
        cfg.max_per_tile, cfg.pair_budget, bg)
    return img, RasterizeAux(transmittance=trans, num_dropped=num_dropped,
                             num_fg_dropped=torch.stack(fg_dropped),
                             num_pair_dropped=num_pair_dropped)
