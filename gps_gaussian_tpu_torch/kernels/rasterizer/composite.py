"""Tiled front-to-back alpha compositing over depth-sorted pair segments.

Counterpart of `_composite_core` (gps_gaussian_tpu/kernels/rasterizer/
pallas_kernel.py:1044) with its forward kernel `_fwd_kernel` (:767) and its
backward kernel `_bwd_kernel` (:836), which on the GPU are the hand-written
CUDA kernels `csrc/composite_fwd.cu` and `csrc/composite_bwd.cu`.
`composite` ties the two into one differentiable function.

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
* the backward takes that output and its cotangent, both (num_tiles, 256, 4),
  and returns the gradient of `props`, (9, P) f32; pairs that no pixel
  blended get exactly 0.
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
KERNEL_BWD = "composite_bwd"
ONE_M_MIN = 1e-6  # floor of 1 - alpha under the suffix term's division
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


@torch.no_grad()
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


def _check_bwd(props, out, g_out, num_tiles):
    for name, x in (("out", out), ("g_out", g_out)):
        if x.dtype != torch.float32 or tuple(x.shape) != (num_tiles, PIX, 4):
            raise ValueError(f"{name} must be ({num_tiles}, {PIX}, 4) "
                             f"float32, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != props.device:
            raise ValueError(f"{name} is on {x.device}, props on "
                             f"{props.device}")


def composite_bwd(props: torch.Tensor, start: torch.Tensor,
                  count: torch.Tensor, out: torch.Tensor,
                  g_out: torch.Tensor, tiles_y: int,
                  tiles_x: int) -> torch.Tensor:
    """Gradient of `composite_fwd` with respect to `props`: (9, P).

    `out` is the forward's result on the same (props, start, count) and
    `g_out` its cotangent. CUDA tensors launch the CUDA kernel on the
    current stream; CPU tensors take the plain version. There is no
    fallback between the two.
    """
    _check(props, start, count, tiles_y, tiles_x)
    num_tiles = start.shape[0]
    _check_bwd(props, out, g_out, num_tiles)
    if props.device.type == "cpu":
        return composite_bwd_plain(props, start, count, out, g_out, tiles_y,
                                   tiles_x)
    if props.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {props.device}")
    # zeros, not empty: the kernel writes only the pairs its walk reaches
    gprops = torch.zeros_like(props)
    fn = build.load(KERNEL_BWD).composite_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(props.device).cuda_stream
    err = fn(props.data_ptr(), props.shape[1], start.data_ptr(),
             count.data_ptr(), num_tiles, tiles_x, tiles_y * tiles_x,
             out.data_ptr(), g_out.data_ptr(), gprops.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(KERNEL_BWD)
    return gprops


@torch.no_grad()
def composite_bwd_plain(props: torch.Tensor, start: torch.Tensor,
                        count: torch.Tensor, out: torch.Tensor,
                        g_out: torch.Tensor, tiles_y: int, tiles_x: int,
                        return_work: bool = False):
    """Plain PyTorch version of `composite_bwd`, on any device.

    The walk of `composite_fwd_plain` extended with the gradient terms of
    `_bwd_kernel` (pallas_kernel.py:846-851, :914-956), in the kernel's
    order of operations: per pixel the running inclusive sum p_gc of
    w * (g_rgb . color); for a blended pair g_alpha = gc * T -
    (suffix - p_gc) / max(1 - alpha, 1e-6) and g_power = g_alpha * alpha_un
    where alpha was not clamped; the nine values are then summed over the
    tile's 256 pixels. exp(power) is used as computed, not recovered as
    alpha_un / opacity. With `return_work` it returns (gprops, walked,
    blended, reached): the number of (pair, pixel) evaluations the walk
    needs, as `composite_fwd_plain` counts them, how many of those blend
    (only these carry gradient arithmetic), and the number of pairs that
    some pixel of their tile still needs when the walk comes to them (only
    these must be read).
    """
    num_tiles = start.shape[0]
    dev = props.device
    P = props.shape[1]
    # one spare column takes the writes of tiles whose segment has ended
    gprops = torch.zeros((NPROP, P + 1), dtype=torch.float32, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev)
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
        res, g = out[sl], g_out[sl]
        g3 = g[..., 0:3].permute(2, 0, 1)                      # (3, nb, PIX)
        suffix = (g[..., 0] * res[..., 0] + g[..., 1] * res[..., 1]
                  + g[..., 2] * res[..., 2] + g[..., 3] * res[..., 3])
        T = torch.ones((nb, PIX), dtype=torch.float32, device=dev)
        p_gc = torch.zeros((nb, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((nb, PIX), dtype=torch.bool, device=dev)
        steps = int(cnt.max()) if nb else 0
        for k in range(steps):
            in_seg = k < cnt
            live = in_seg[:, None] & ~done                     # (nb, PIX)
            p = props[:, torch.where(in_seg, st + k, 0)][:, :, None]
            ca, cb, cc = p[2], p[3], p[4]
            dx = px - p[0]
            dy = py - p[1]
            power = (-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy)
            G = torch.exp(power)
            alpha_un = p[5] * G
            alpha = torch.clamp_max(alpha_un, ALPHA_MAX)
            include = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
            test_T = T * (1.0 - alpha)
            viol = include & (test_T < T_EPS)
            blend = include & ~viol
            w = torch.where(blend, alpha * T, 0.0)
            gc = g3[0] * p[6] + g3[1] * p[7] + g3[2] * p[8]
            p_gc = p_gc + w * gc
            one_m = torch.clamp_min(1.0 - alpha, ONE_M_MIN)
            g_alpha = torch.where(blend, gc * T - (suffix - p_gc) / one_m,
                                  0.0)
            nc = (alpha_un < ALPHA_MAX).to(torch.float32)
            gp = g_alpha * alpha_un * nc
            vals = torch.stack([
                gp * (ca * dx + cb * dy), gp * (cc * dy + cb * dx),
                gp * (-0.5 * dx * dx), gp * (-dx * dy),
                gp * (-0.5 * dy * dy), g_alpha * G * nc,
                g3[0] * w, g3[1] * w, g3[2] * w])              # (9, nb, PIX)
            gprops[:, torch.where(in_seg, st + k, P)] = vals.sum(dim=2)
            T = torch.where(blend, test_T, T)
            if return_work:
                work += torch.stack([live.sum(), blend.sum(),
                                     live.any(dim=1).sum()])
            done = done | viol
    gprops = gprops[:, :P].contiguous()
    return (gprops, *work) if return_work else gprops


class _Composite(torch.autograd.Function):
    """`composite_fwd` with `composite_bwd` as its backward (the
    counterpart of the custom VJP `_composite_core`, :1043-1073)."""

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
        # the cotangent comes out of untile's permute: not contiguous
        gprops = composite_bwd(props, start, count, out, g_out.contiguous(),
                               *ctx.tiles)
        return gprops, None, None, None, None


def composite(props: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
              tiles_y: int, tiles_x: int) -> torch.Tensor:
    """Differentiable composite: `composite_fwd` forward, `composite_bwd`
    backward with respect to `props`; `start` and `count` get no
    gradient."""
    return _Composite.apply(props, start, count, tiles_y, tiles_x)
