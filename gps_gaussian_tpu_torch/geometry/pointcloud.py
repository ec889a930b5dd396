"""Flow -> inverse depth -> world points (batched, channel-last).

Counterpart of gps_gaussian_tpu/geometry/pointcloud.py `flow_to_inv_depth`
:91 and `inv_depth_to_points` :35. Every "depth" is INVERSE z. The 3x3
contraction is written elementwise in f32, so no TF32 path can touch it.
"""

from __future__ import annotations

import torch


def pixel_center_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel centres at half-integer offsets."""
    y = torch.linspace(0.5, h - 0.5, h, device=device)
    x = torch.linspace(0.5, w - 0.5, w, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def inv_depth_to_points(inv_depth: torch.Tensor, extr: torch.Tensor,
                        intr: torch.Tensor) -> torch.Tensor:
    """Per-pixel unprojection: z = 1 / (inv_depth + 1e-8),
    x = (u - cx) z / fx, y = (v - cy) z / fy, world = R^T (p_cam - t).

    inv_depth: (B, H, W); extr: (B, 3, 4); intr: (B, 3, 3).
    Returns (B, H, W, 3) world points."""
    b, h, w = inv_depth.shape
    grid = pixel_center_grid(h, w, inv_depth.device)
    z = 1.0 / (inv_depth + 1e-8)

    fx = intr[:, 0, 0][:, None, None]
    fy = intr[:, 1, 1][:, None, None]
    cx = intr[:, 0, 2][:, None, None]
    cy = intr[:, 1, 2][:, None, None]

    x = (grid[..., 0][None] - cx) * z / fx
    y = (grid[..., 1][None] - cy) * z / fy
    p = torch.stack([x, y, z], dim=-1) - extr[:, None, None, :3, 3]
    R = extr[:, :3, :3]
    # world_i = sum_j R_ji p_j
    return torch.stack([
        R[:, None, None, 0, i] * p[..., 0] + R[:, None, None, 1, i] * p[..., 1]
        + R[:, None, None, 2, i] * p[..., 2] for i in range(3)], dim=-1)


def flow_to_inv_depth(flow: torch.Tensor, intr: torch.Tensor,
                      ref_intr: torch.Tensor, tf_x: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Disparity-flow -> inverse depth, zero outside the mask.

    offset = ref_cx - cx; disparity = offset - flow;
    inv_depth = -disparity / tf_x. All (B, H, W, 1) but intr (B, 3, 3) and
    tf_x (B,)."""
    offset = ref_intr[:, 0, 2] - intr[:, 0, 2]
    disparity = offset[:, None, None, None] - flow
    inv_depth = -disparity / tf_x[:, None, None, None]
    return inv_depth * mask
