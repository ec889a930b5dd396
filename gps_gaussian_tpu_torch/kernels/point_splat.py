"""Non-differentiable nearest-pixel point splat with an inverse-z test.

Counterpart of gps_gaussian_tpu/kernels/point_splat.py `splat_points` :15,
which is a jnp scatter, not a Pallas kernel; this is plain PyTorch on any
device. Points are projected, rounded to the nearest pixel (half to even,
as jnp.round), and the nearest surface per pixel wins through a scatter-max
of inverse z. Used for the stage-1 validation preview only; the renderer is
kernels/rasterizer.

Points that tie at the same inverse z on one pixel all win, and which of
their colours lands is unspecified, here as in JAX (CUDA's `index_put_`
with duplicate indices is nondeterministic). Losers and points off the
image write to one sentinel slot past the image, which is dropped.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def splat_points(xyz: torch.Tensor, rgb: torch.Tensor, valid: torch.Tensor,
                 intr: torch.Tensor, extr: torch.Tensor,
                 height: int, width: int) -> torch.Tensor:
    """xyz (B, N, 3), rgb (B, N, 3) in [0, 1], valid (B, N), intr (B, 3, 3),
    extr (B, 3, 4) -> (B, H, W, 3) image (black background)."""
    b, n, _ = xyz.shape
    calib = torch.einsum("bij,bjk->bik", intr, extr)          # (B, 3, 4)
    p = (torch.einsum("bij,bnj->bni", calib[:, :, :3], xyz)
         + calib[:, :, 3][:, None, :])                        # (B, N, 3)
    z = p[..., 2]
    u = torch.round(p[..., 0] / z).to(torch.int64)
    v = torch.round(p[..., 1] / z).to(torch.int64)

    ok = ((valid > 0.5) & (z > 1e-6) & (u >= 0) & (u < width)
          & (v >= 0) & (v < height))
    inv_z = torch.where(ok, 1.0 / torch.clamp(z, min=1e-6),
                        torch.zeros_like(z))
    slots = height * width + 1                       # the last is the sentinel
    flat = torch.where(ok, v * width + u, torch.full_like(u, slots - 1))
    flat = flat + slots * torch.arange(b, device=xyz.device)[:, None]

    zbuf = torch.zeros(b * slots, dtype=torch.float32, device=xyz.device)
    zbuf.scatter_reduce_(0, flat.reshape(-1), inv_z.reshape(-1).float(),
                         "amax")
    win = (inv_z > 0) & (inv_z >= zbuf[flat])
    sentinel = slots * torch.arange(b, device=xyz.device)[:, None] + slots - 1
    dest = torch.where(win, flat, sentinel)
    img = torch.zeros(b * slots, 3, dtype=torch.float32, device=xyz.device)
    img.index_put_((dest.reshape(-1),), rgb.reshape(-1, 3).float())
    return img.reshape(b, slots, 3)[:, :-1].reshape(b, height, width, 3)
