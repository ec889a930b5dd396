"""The least time the composite kernels' work allows on one H100, counted
by the benchmark's own reference on the pair lists it bins itself.

Frozen from chip_smoke.py at commit 19aea69 (`HBM_BYTES_PER_S`,
`F32_FLOPS`, `OPS_PER_EVAL`, `BWD_OPS_PER_WALK`, `BWD_OPS_PER_BLEND` and the
byte formulas of `phase_main_shape` and `phase_main_shape_training`). The
work is what these inputs need, not the most they could: a pixel walks its
tile's pairs up to and including the one that ends it.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference import raster
from port_bench.reference.composite import TILE, composite_fwd
from port_bench.reference.containers import FlatGaussians
from port_bench.reference.pair_sort import sort_pairs, stack_rows
from port_bench.reference.preprocess import project_gaussians

# NVIDIA's data sheet, H100 SXM, dense: HBM bytes/s and f32 FLOP/s outside
# the tensor cores (the composites are f32 CUDA-core arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per walked (pair, pixel) in the forward, expf as one:
# dx dy (2), power (9), exp and opacity (2), clamp (1), the two include
# tests (2), 1 - alpha and test_T (2), the T_EPS test (1), w (1), rgb (6)
OPS_PER_EVAL = 25
# the backward: per walked (pair, pixel) up to the T_EPS test 20; per
# blended one 46 more (w, gc, p_gc, the floor of 1 - alpha, g_alpha, the
# clamp flag, gp, the five geometry terms, opacity, rgb, nine sums)
BWD_OPS_PER_WALK = 20
BWD_OPS_PER_BLEND = 46


def fwd_bound_s(work: dict) -> float:
    """Read 36 B a live pair and 8 B of segment a tile, write 16 B a pixel;
    or the operations, whichever takes longer."""
    nbytes = (36 * work["pairs"] + 8 * work["tiles"]
              + 16 * work["tiles"] * 256)
    return max(nbytes / HBM_BYTES_PER_S,
               work["walked"] * OPS_PER_EVAL / F32_FLOPS)


def bwd_bound_s(work: dict) -> float:
    """Read 36 B a pair the walk reaches, write 36 B a live pair, 8 B of
    segment a tile, the saved output and its cotangent at 16 B a pixel each;
    or the operations, whichever takes longer."""
    nbytes = (36 * work["reached"] + 36 * work["pairs"] + 8 * work["tiles"]
              + 32 * work["tiles"] * 256)
    ops = (work["walked"] * BWD_OPS_PER_WALK
           + work["blended"] * BWD_OPS_PER_BLEND)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


@torch.no_grad()
def composite_work(gauss: dict, camera: dict, height: int, width: int,
                   rcfg: raster.RasterizeConfig) -> dict:
    """Bin a batch of Gaussians as the configuration's rasterizer does and
    walk the pairs: {"pairs", "tiles", "walked", "blended", "reached"}.

    `gauss`: (B, N, c) tensors xyz, rot, scale, opacity, rgb and valid
    (B, N); `camera`: (B, ...) tensors view, proj, tanfovx, tanfovy."""
    g = FlatGaussians(**{k: gauss[k].detach().float() for k in
                         ("xyz", "rgb", "rot", "scale", "opacity", "valid")})
    stacked = []
    for b in range(g.xyz.shape[0]):
        if rcfg.fg_cap is not None:
            (xyz, rot, scale, opacity, rgb, valid), _ = \
                raster.compact_gaussian_inputs(g, b, rcfg.fg_cap)
        else:
            xyz, rot, scale, opacity, rgb, valid = (
                g.xyz[b], g.rot[b], g.scale[b], g.opacity[b], g.rgb[b],
                g.valid[b])
        p = project_gaussians(xyz, rot, scale, opacity, rgb, valid,
                              camera["view"][b], camera["proj"][b],
                              camera["tanfovx"][b], camera["tanfovy"][b],
                              height, width)
        stacked.append(stack_rows(p.mean2d, p.conic, p.opacity, p.color,
                                  p.depth, p.radius))
    props, start, count, _, _ = sort_pairs(
        torch.stack(stacked), height, width, rcfg.max_tiles_per_gaussian,
        rcfg.max_per_tile, rcfg.pair_budget)
    tiles_y, tiles_x = -(-height // TILE), -(-width // TILE)
    _, (walked, blended, reached) = composite_fwd(
        props.contiguous(), start, count, tiles_y, tiles_x, return_work=True)
    return {"pairs": int(count.sum()), "tiles": int(start.shape[0]),
            "walked": walked, "blended": blended, "reached": reached}


def camera_dict(cam) -> dict:
    """Either side's NovelCamera as the tensors `composite_work` reads."""
    return {k: getattr(cam, k) for k in ("view", "proj", "tanfovx",
                                         "tanfovy")}


def serve_config(rcfg: raster.RasterizeConfig) -> raster.RasterizeConfig:
    """A view's binning: compaction ran once per frame, before it."""
    return dataclasses.replace(rcfg, fg_cap=None)

