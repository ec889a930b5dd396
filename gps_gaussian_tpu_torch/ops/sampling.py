"""Grid sampling, flow grids, pooling and convex upsampling (NHWC at the
interface).

Counterpart of gps_gaussian_tpu/ops/sampling.py: `coords_grid` :16,
`bilinear_sample` :30, `interpolate_bilinear` :70, `avg_pool_2d` :89,
`avg_pool_lastdim` :104, `shift_patches_3x3` :110 and `convex_upsample`
:123.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, H, W, 2) integer pixel coordinate grid, channels (x, y)."""
    y = torch.arange(h, dtype=torch.float32, device=device)
    x = torch.arange(w, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)[None].expand(batch, h, w, 2)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample an NHWC image at pixel coordinates, zero padding:
    integer coordinates hit pixel centres (align_corners=True) and taps
    outside the image contribute zero (the reference's bilinear_sampler,
    grid_sample's default padding).

    img: (B, H, W, C); coords: (B, ..., 2), channels (x, y) in pixels.
    Returns (B, ..., C)."""
    b, h, w, c = img.shape
    lead = coords.shape[1:-1]
    coords = coords.reshape(b, -1, 2)
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat_img = img.reshape(b, h * w, c)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        flat = (yy.clamp(0, h - 1).long() * w
                + xx.clamp(0, w - 1).long())                   # (B, N)
        vals = torch.gather(flat_img, 1, flat[..., None].expand(-1, -1, c))
        return vals * inside[..., None].to(img.dtype)

    out = (tap(y0, x0) * (1 - fx) * (1 - fy)
           + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy
           + tap(y0 + 1, x0 + 1) * fx * fy)
    return out.reshape((b,) + tuple(lead) + (c,))


def interpolate_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Resize an NHWC image bilinearly (F.interpolate's semantics, through
    `bilinear_sample`)."""
    b, h, w, c = img.shape
    dev = img.device
    if align_corners and out_h > 1 and out_w > 1:
        ys = torch.linspace(0.0, h - 1.0, out_h, device=dev)
        xs = torch.linspace(0.0, w - 1.0, out_w, device=dev)
    else:  # half-pixel convention
        ys = (torch.arange(out_h, device=dev) + 0.5) * (h / out_h) - 0.5
        xs = (torch.arange(out_w, device=dev) + 0.5) * (w / out_w) - 0.5
        ys = ys.clamp(0, h - 1)
        xs = xs.clamp(0, w - 1)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([xx, yy], dim=-1)[None].expand(b, out_h, out_w, 2)
    return bilinear_sample(img, coords)


def avg_pool_2d(x: torch.Tensor, window: int, stride: int,
                padding: int) -> torch.Tensor:
    """Count-include-pad average pooling over the spatial axes of an NHWC
    map (F.avg_pool2d's default, the reference's pool2x / pool4x)."""
    x = F.pad(x, (0, 0, padding, padding, padding, padding))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


def avg_pool_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Average-pool the last axis by 2 (an odd tail element is dropped)."""
    n = x.shape[-1] // 2
    return x[..., :2 * n].reshape(x.shape[:-1] + (n, 2)).mean(dim=-1)


def shift_patches_3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9, C): the zero-padded 3x3 neighbourhood,
    taps row-major in (dy, dx) (F.unfold(x, 3, padding=1) order)."""
    b, h, w, c = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample(flow: torch.Tensor, mask_logits: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Learned convex x`factor` upsampling of a flow field: a softmax over 9
    logits mixes the 3x3 neighbourhood of factor * flow for each subpixel.

    flow: (B, h, w, D); mask_logits: (B, h, w, 9 * factor^2).
    Returns (B, h * factor, w * factor, D)."""
    b, h, w, d = flow.shape
    f2 = factor * factor
    mask = torch.softmax(mask_logits.reshape(b, h, w, 9, f2), dim=3)
    patches = shift_patches_3x3(flow * factor)               # (B,h,w,9,D)
    up = torch.einsum("bhwkf,bhwkd->bhwfd", mask, patches)
    up = up.reshape(b, h, w, factor, factor, d).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, h * factor, w * factor, d)
