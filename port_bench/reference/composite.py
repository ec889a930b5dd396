# Frozen from gps_gaussian_tpu_torch/kernels/rasterizer/composite.py at
# commit 19aea69 (`composite_fwd_plain`, `composite_bwd_plain`, `_Composite`),
# rewritten to stand alone: plain PyTorch only, on any device.
"""Tiled front-to-back alpha compositing over depth-sorted pair segments.

Layout:

* `props`: (9, P) f32, rows mx, my, conic a, b, c, opacity, r, g, b;
  columns are pairs sorted by (tile, depth).
* `start`, `count`: (num_tiles,) i32; tile t owns pairs
  [start[t], start[t] + count[t]). Tiles are numbered
  (b * tiles_y + ty) * tiles_x + tx over the batch.
* output: (num_tiles, 256, 4) f32: pixel i of a tile at
  (tx * 16 + i % 16, ty * 16 + i // 16); r, g, b (weighted by alpha * T,
  no background) and the final transmittance T.

Each walk steps pair position k = 0, 1, ... of every tile at once, all
256 pixels of a tile in parallel: include iff power <= 0 and
alpha >= 1/255; a pair whose blend would push T below T_EPS ends the pixel;
the final T is over blended pairs only. Tiles are walked longest segment
first, so step k touches only the tiles whose segment is longer than k; the
arithmetic of each pixel is that of a walk over all tiles.
"""

from __future__ import annotations

import numpy as np
import torch

# kernels/rasterizer/reference.py: the reference rasterizer's alpha tests
# (alpha >= 1/255, clamped at 0.99) and its transmittance floor
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

TILE = 16
PIX = TILE * TILE
NPROP = 9
ONE_M_MIN = 1e-6  # floor of 1 - alpha under the suffix term's division


class _Walk:
    """Tiles ordered by descending segment length, with the pixel
    coordinates of each, and how many tiles are still walking at step k."""

    def __init__(self, start, count, tiles_y: int, tiles_x: int):
        dev = start.device
        num_tiles = start.shape[0]
        counts = count.to(torch.int64)
        self.order = torch.sort(counts, descending=True, stable=True).indices
        ordered = counts[self.order].cpu().numpy()
        self.steps = int(ordered[0]) if num_tiles else 0
        # tiles whose count exceeds k, for k = 0 .. steps - 1
        asc = ordered[::-1]
        ks = np.arange(self.steps)
        self.active = (num_tiles
                       - np.searchsorted(asc, ks, side="right")).tolist()
        idx = torch.arange(PIX, device=dev)
        local = self.order % (tiles_y * tiles_x)
        self.px = (((local % tiles_x) * TILE)[:, None]
                   + (idx % TILE)[None, :]).to(torch.float32)
        self.py = (((local // tiles_x) * TILE)[:, None]
                   + (idx // TILE)[None, :]).to(torch.float32)
        self.start = start.to(torch.int64)[self.order]
        self.num_tiles = num_tiles


@torch.no_grad()
def composite_fwd(props: torch.Tensor, start: torch.Tensor,
                  count: torch.Tensor, tiles_y: int, tiles_x: int,
                  return_work: bool = False):
    """(9, P) sorted pairs + per-tile segments -> (num_tiles, 256, 4).

    With `return_work` also returns (walked, blended, reached): the
    (pair, pixel) evaluations the walk needs (each pixel counts the pairs
    of its segment up to and including the one that ends it), how many of
    them blend, and how many pairs some pixel of their tile still needs
    when the walk comes to them."""
    walk = _Walk(start, count, tiles_y, tiles_x)
    dev = props.device
    nt = walk.num_tiles
    T = torch.ones((nt, PIX), dtype=torch.float32, device=dev)
    acc = torch.zeros((3, nt, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((nt, PIX), dtype=torch.bool, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev)
    for k in range(walk.steps):
        n = walk.active[k]
        live = ~done[:n]
        p = props[:, walk.start[:n] + k][:, :, None]          # (9, n, 1)
        dx = walk.px[:n] - p[0]
        dy = walk.py[:n] - p[1]
        power = (-0.5 * (p[2] * dx * dx + p[4] * dy * dy)
                 - p[3] * dx * dy)
        alpha = torch.clamp_max(p[5] * torch.exp(power), ALPHA_MAX)
        include = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
        Tn = T[:n]
        test_T = Tn * (1.0 - alpha)
        viol = include & (test_T < T_EPS)
        blend = include & ~viol
        w = torch.where(blend, alpha * Tn, 0.0)
        acc[:, :n] = acc[:, :n] + w * p[6:9]
        T[:n] = torch.where(blend, test_T, Tn)
        if return_work:
            work += torch.stack([live.sum(), blend.sum(),
                                 live.any(dim=1).sum()])
        done[:n] = done[:n] | viol
    out = torch.empty((nt, PIX, 4), dtype=torch.float32, device=dev)
    out[walk.order, :, 0:3] = acc.permute(1, 2, 0)
    out[walk.order, :, 3] = T
    if return_work:
        return out, tuple(int(v) for v in work.cpu())
    return out


@torch.no_grad()
def composite_bwd(props: torch.Tensor, start: torch.Tensor,
                  count: torch.Tensor, out: torch.Tensor,
                  g_out: torch.Tensor, tiles_y: int,
                  tiles_x: int) -> torch.Tensor:
    """Gradient of `composite_fwd` with respect to `props`: (9, P).

    Per pixel the running inclusive sum p_gc of w * (g_rgb . color); for a
    blended pair g_alpha = gc * T - (suffix - p_gc) / max(1 - alpha, 1e-6)
    and g_power = g_alpha * alpha_un where alpha was not clamped; the nine
    values are summed over the tile's 256 pixels. Pairs that no pixel
    blended get exactly 0."""
    walk = _Walk(start, count, tiles_y, tiles_x)
    dev = props.device
    P = props.shape[1]
    nt = walk.num_tiles
    gprops = torch.zeros((NPROP, P), dtype=torch.float32, device=dev)
    res, g = out[walk.order], g_out[walk.order]
    g3 = g[..., 0:3].permute(2, 0, 1)                          # (3, nt, PIX)
    suffix = (g[..., 0] * res[..., 0] + g[..., 1] * res[..., 1]
              + g[..., 2] * res[..., 2] + g[..., 3] * res[..., 3])
    T = torch.ones((nt, PIX), dtype=torch.float32, device=dev)
    p_gc = torch.zeros((nt, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((nt, PIX), dtype=torch.bool, device=dev)
    for k in range(walk.steps):
        n = walk.active[k]
        live = ~done[:n]
        cols = walk.start[:n] + k
        p = props[:, cols][:, :, None]
        ca, cb, cc = p[2], p[3], p[4]
        dx = walk.px[:n] - p[0]
        dy = walk.py[:n] - p[1]
        power = (-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy)
        G = torch.exp(power)
        alpha_un = p[5] * G
        alpha = torch.clamp_max(alpha_un, ALPHA_MAX)
        include = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
        Tn = T[:n]
        test_T = Tn * (1.0 - alpha)
        viol = include & (test_T < T_EPS)
        blend = include & ~viol
        w = torch.where(blend, alpha * Tn, 0.0)
        gn = g3[:, :n]
        gc = gn[0] * p[6] + gn[1] * p[7] + gn[2] * p[8]
        p_gc[:n] = p_gc[:n] + w * gc
        one_m = torch.clamp_min(1.0 - alpha, ONE_M_MIN)
        g_alpha = torch.where(blend,
                              gc * Tn - (suffix[:n] - p_gc[:n]) / one_m, 0.0)
        nc = (alpha_un < ALPHA_MAX).to(torch.float32)
        gp = g_alpha * alpha_un * nc
        vals = torch.stack([
            gp * (ca * dx + cb * dy), gp * (cc * dy + cb * dx),
            gp * (-0.5 * dx * dx), gp * (-dx * dy),
            gp * (-0.5 * dy * dy), g_alpha * G * nc,
            gn[0] * w, gn[1] * w, gn[2] * w])                  # (9, n, PIX)
        gprops[:, cols] = vals.sum(dim=2)
        T[:n] = torch.where(blend, test_T, Tn)
        done[:n] = done[:n] | viol
    return gprops


class _Composite(torch.autograd.Function):
    """`composite_fwd` with `composite_bwd` as its backward."""

    @staticmethod
    def forward(ctx, props, start, count, tiles_y, tiles_x):
        out = composite_fwd(props, start, count, tiles_y, tiles_x)
        ctx.save_for_backward(props, start, count, out)
        ctx.tiles = (tiles_y, tiles_x)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        props, start, count, out = ctx.saved_tensors
        gprops = composite_bwd(props, start, count, out, g_out.contiguous(),
                               *ctx.tiles)
        return gprops, None, None, None, None


def composite(props: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
              tiles_y: int, tiles_x: int) -> torch.Tensor:
    """Differentiable composite with respect to `props`."""
    return _Composite.apply(props, start, count, tiles_y, tiles_x)
