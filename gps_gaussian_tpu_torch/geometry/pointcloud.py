"""flow <-> disparity <-> inverse depth <-> world points (batched,
channel-last).

Counterpart of gps_gaussian_tpu/geometry/pointcloud.py: `inv_depth_to_points`
:35, `points_to_inv_depth` :72, `flow_to_inv_depth` :91,
`perspective_project` :113 and `stereo_flow_from_inv_depth` :128. Every
"depth" is INVERSE z. The 3x3 contractions are written elementwise in f32,
so no TF32 path can touch them.
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


def _affine_row(M: torch.Tensor, i: int, pts: torch.Tensor) -> torch.Tensor:
    """sum_j M[b, i, j] pts[b, ..., j] + M[b, i, 3], elementwise in f32;
    M (B, 3, 4), pts (B, ..., 3)."""
    shape = (M.shape[0],) + (1,) * (pts.dim() - 2)
    row = M[:, i].reshape(shape + (4,))
    return (row[..., 0] * pts[..., 0] + row[..., 1] * pts[..., 1]
            + row[..., 2] * pts[..., 2] + row[..., 3])


def points_to_inv_depth(pts: torch.Tensor, extr: torch.Tensor,
                        intr: torch.Tensor) -> torch.Tensor:
    """World point map (B, H, W, 3) -> inverse depth 1 / (z + 1e-8) (B, H,
    W) in the camera extr (B, 3, 4) (K's third row is [0, 0, 1], so `intr`
    leaves z as it is)."""
    return 1.0 / (_affine_row(extr, 2, pts) + 1e-8)


def perspective_project(pts: torch.Tensor,
                        calib: torch.Tensor) -> torch.Tensor:
    """Project world points (B, N, 3) with calib = K [R|t] (B, 3, 4):
    (B, N, 3) of (u, v, z_cam), xy divided by depth, z as it is."""
    p = [_affine_row(calib, i, pts) for i in range(3)]
    return torch.stack([p[0] / p[2], p[1] / p[2], p[2]], dim=-1)


def stereo_flow_from_inv_depth(inv_depth: torch.Tensor, intr: torch.Tensor,
                               ref_intr: torch.Tensor,
                               tf_x: torch.Tensor) -> torch.Tensor:
    """The inverse of `flow_to_inv_depth`, the ground-truth flow of a
    rectified inverse depth: disparity = -inv_depth * tf_x,
    flow = offset - disparity. inv_depth (B, H, W, 1) -> flow (B, H, W, 1)."""
    offset = ref_intr[:, 0, 2] - intr[:, 0, 2]
    disparity = -inv_depth * tf_x[:, None, None, None]
    return offset[:, None, None, None] - disparity
