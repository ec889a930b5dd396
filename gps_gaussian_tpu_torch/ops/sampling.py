"""Flow grids, pooling and convex upsampling (NHWC at the interface).

Counterpart of gps_gaussian_tpu/ops/sampling.py: `coords_grid` :16,
`avg_pool_lastdim` :104, `shift_patches_3x3` :110 and `convex_upsample`
:123, the functions the serving path calls.
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
