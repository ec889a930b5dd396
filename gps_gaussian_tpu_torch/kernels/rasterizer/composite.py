"""Tiled front-to-back alpha compositing over depth-sorted pair segments.

Counterpart of `_composite_core` (gps_gaussian_tpu/kernels/rasterizer/
pallas_kernel.py:1044) and its forward kernel `_fwd_kernel` (:767), which on
the GPU is the hand-written CUDA kernel `csrc/composite_fwd.cu`.

Layout taken by both versions (the port's own; the TPU's (chunks, 16, 128)
with 7 padding rows was a DMA shape):

* `props`: (9, P) f32, structure of arrays, contiguous. Rows are mx, my,
  conic a, b, c, opacity, r, g, b; columns are pairs sorted by (tile, depth).
* `start`, `count`: (num_tiles,) i32. Tile t owns pairs
  [start[t], start[t] + count[t]), which must lie inside [0, P). Tiles are
  numbered (b * tiles_y + ty) * tiles_x + tx over the batch.
* output: (num_tiles, 256, 4) f32, pixel i of a tile at
  (tx * 16 + i % 16, ty * 16 + i // 16); channels r, g, b (weighted by
  alpha * T, no background) and the final transmittance T.
"""

from __future__ import annotations

import ctypes

import torch

from gps_gaussian_tpu_torch.kernels import build
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import (ALPHA_MAX,
                                                                 ALPHA_MIN,
                                                                 T_EPS)

TILE = 16
PIX = TILE * TILE
NPROP = 9
KERNEL = "composite_fwd"
PLAIN_TILES_PER_BLOCK = 4096  # bounds the plain version's working memory


def _check(props, start, count, tiles_y, tiles_x):
    if props.dtype != torch.float32 or props.dim() != 2 \
            or props.shape[0] != NPROP:
        raise ValueError(f"props must be (9, P) float32, got "
                         f"{tuple(props.shape)} {props.dtype}")
    for name, x in (("props", props), ("start", start), ("count", count)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("start", start), ("count", count)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != props.device:
            raise ValueError(f"{name} is on {x.device}, props on "
                             f"{props.device}")
    if start.shape != count.shape or start.shape[0] % (tiles_y * tiles_x):
        raise ValueError(f"start/count {tuple(start.shape)} do not cover "
                         f"whole samples of {tiles_y}x{tiles_x} tiles")


def composite_fwd(props: torch.Tensor, start: torch.Tensor,
                  count: torch.Tensor, tiles_y: int,
                  tiles_x: int) -> torch.Tensor:
    """(9, P) sorted pairs + per-tile segments -> (num_tiles, 256, 4).

    CUDA tensors launch the CUDA kernel on the current stream; CPU tensors
    take the plain version. There is no fallback between the two.
    """
    _check(props, start, count, tiles_y, tiles_x)
    if props.device.type == "cpu":
        return composite_fwd_plain(props, start, count, tiles_y, tiles_x)
    if props.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {props.device}")
    num_tiles = start.shape[0]
    out = torch.empty((num_tiles, PIX, 4), dtype=torch.float32,
                      device=props.device)
    fn = build.load(KERNEL).composite_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(props.device).cuda_stream
    err = fn(props.data_ptr(), props.shape[1], start.data_ptr(),
             count.data_ptr(), num_tiles, tiles_x, tiles_y * tiles_x,
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(KERNEL)
    return out


def composite_fwd_plain(props: torch.Tensor, start: torch.Tensor,
                        count: torch.Tensor, tiles_y: int, tiles_x: int,
                        return_work: bool = False):
    """Plain PyTorch version of `composite_fwd`, on any device.

    Walks pair position k = 0, 1, ... of every tile of a block of tiles at
    once, all 256 pixels in parallel, with the same arithmetic in the same
    order as the kernel (and as `_chunk_terms`, pallas_kernel.py:709):
    include iff power <= 0 and alpha >= 1/255; a pair whose blend would push
    T below T_EPS ends the pixel; final T over blended pairs only. Memory is
    O(PLAIN_TILES_PER_BLOCK * 256). With `return_work` it also returns the number
    of (pair, pixel) evaluations the walk needs: each pixel counts the
    pairs of its segment up to and including the one that ends it.
    """
    num_tiles = start.shape[0]
    dev = props.device
    out = torch.empty((num_tiles, PIX, 4), dtype=torch.float32, device=dev)
    work = torch.zeros((), dtype=torch.int64, device=dev)
    idx = torch.arange(PIX, device=dev)
    local = torch.arange(num_tiles, device=dev) % (tiles_y * tiles_x)
    px_all = ((local % tiles_x) * TILE)[:, None] + (idx % TILE)[None, :]
    py_all = ((local // tiles_x) * TILE)[:, None] + (idx // TILE)[None, :]
    counts = count.to(torch.int64)
    for t0 in range(0, num_tiles, PLAIN_TILES_PER_BLOCK):
        sl = slice(t0, min(t0 + PLAIN_TILES_PER_BLOCK, num_tiles))
        px = px_all[sl].to(torch.float32)
        py = py_all[sl].to(torch.float32)
        st = start[sl].to(torch.int64)
        cnt = counts[sl]
        nb = cnt.shape[0]
        T = torch.ones((nb, PIX), dtype=torch.float32, device=dev)
        acc = torch.zeros((3, nb, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((nb, PIX), dtype=torch.bool, device=dev)
        steps = int(cnt.max()) if nb else 0
        for k in range(steps):
            live = (k < cnt)[:, None] & ~done                  # (nb, PIX)
            col = torch.where(k < cnt, st + k, 0)
            p = props[:, col][:, :, None]                      # (9, nb, 1)
            dx = px - p[0]
            dy = py - p[1]
            power = (-0.5 * (p[2] * dx * dx + p[4] * dy * dy)
                     - p[3] * dx * dy)
            alpha = torch.clamp_max(p[5] * torch.exp(power), ALPHA_MAX)
            include = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
            test_T = T * (1.0 - alpha)
            viol = include & (test_T < T_EPS)
            blend = include & ~viol
            w = torch.where(blend, alpha * T, 0.0)
            acc = acc + w * p[6:9]
            T = torch.where(blend, test_T, T)
            if return_work:
                work += live.sum()
            done = done | viol
        out[sl, :, 0:3] = acc.permute(1, 2, 0)
        out[sl, :, 3] = T
    return (out, work) if return_work else out
