"""Slow exact oracle: per-pixel alpha compositing over ALL Gaussians.

Counterpart of gps_gaussian_tpu/kernels/rasterizer/reference.py: the forward
semantics of the reference rasterizer (alpha tests power <= 0,
alpha >= 1/255, clamp at 0.99; a Gaussian whose blend would push
transmittance below 1e-4 is dropped with everything behind it), including
the 3-sigma tile-rectangle cull. O(pixels x N): tests only.
"""

from __future__ import annotations

import torch

from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import Projected

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def composite_reference(proj: Projected, bg_color: torch.Tensor,
                        height: int, width: int,
                        tile: int = 16) -> torch.Tensor:
    """Depth-sort all N Gaussians and over-composite per pixel -> (H, W, 3)."""
    live = proj.radius > 0.0
    sort_key = torch.where(live, proj.depth, torch.inf)
    order = torch.sort(sort_key, stable=True).indices
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    opacity = proj.opacity[order]
    color = proj.color[order]
    live = live[order]
    radius = proj.radius[order]
    dev = mean2d.device

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([xx, yy], dim=-1).reshape(-1, 2)          # (P, 2)

    d = pix[:, None, :] - mean2d[None, :, :]                    # (P, N, 2)
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = (-0.5 * (a[None] * dx * dx + c[None] * dy * dy)
             - b[None] * dx * dy)

    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    x_min = torch.clamp(torch.floor((mean2d[:, 0] - radius) / tile), 0,
                        tiles_x)
    x_max = torch.clamp(torch.floor((mean2d[:, 0] + radius + tile - 1)
                                    / tile), 0, tiles_x)
    y_min = torch.clamp(torch.floor((mean2d[:, 1] - radius) / tile), 0,
                        tiles_y)
    y_max = torch.clamp(torch.floor((mean2d[:, 1] + radius + tile - 1)
                                    / tile), 0, tiles_y)
    ptx = torch.floor(pix[:, 0] / tile)
    pty = torch.floor(pix[:, 1] / tile)
    in_rect = ((ptx[:, None] >= x_min[None]) & (ptx[:, None] < x_max[None])
               & (pty[:, None] >= y_min[None]) & (pty[:, None] < y_max[None]))

    alpha = torch.clamp_max(opacity[None] * torch.exp(power), ALPHA_MAX)
    include = live[None] & in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(include, alpha, 0.0)

    log1m = torch.log1p(-alpha)
    t_excl = torch.exp(torch.cumsum(log1m, dim=1) - log1m)
    viol = include & (t_excl * (1.0 - alpha) < T_EPS)
    blend = include & (torch.cumsum(viol.to(torch.int32), dim=1) == 0)

    w = torch.where(blend, alpha * t_excl, 0.0)
    img = w @ color
    t_final = torch.exp(torch.sum(torch.where(blend, log1m, 0.0), dim=1))
    img = img + t_final[:, None] * bg_color[None, :]
    return img.reshape(height, width, 3)
