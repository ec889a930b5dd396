# Frozen copy of gps_gaussian_tpu_torch/kernels/rasterizer/preprocess.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Per-Gaussian projection to screen space (EWA splatting).

Counterpart of gps_gaussian_tpu/kernels/rasterizer/preprocess.py
(`quat_to_rotmat` :40, `build_cov3d` :66, `project_gaussians` :75):
quaternion -> covariance, camera projection, EWA 2D covariance with the 0.3
low-pass, conic + radius, near and determinant cull.
The 3x3 and 4x4 contractions are written elementwise in the same order as
the JAX code, so both round alike. `view`/`proj` are column-vector 4x4
matrices (NovelCamera); pixel centres sit at integer coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projected(NamedTuple):
    """Screen-space Gaussians, fixed shape (N, ...); radius == 0 => culled."""

    mean2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # (N,) camera-space z
    radius: torch.Tensor   # (N,) extent in pixels (3 sigma), 0 if culled
    opacity: torch.Tensor  # (N,)
    color: torch.Tensor    # (N, 3)


def _rotation_entries(q: torch.Tensor):
    """The 3 x 3 entries of the rotation of unit quaternions (..., 4)
    (w, x, y, z), as nested tuples of (...) tensors."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    return torch.stack([torch.stack(row, dim=-1)
                        for row in _rotation_entries(q)], dim=-2)


def build_cov3d_rows(rot: torch.Tensor, scale: torch.Tensor):
    """Sigma = R diag(s^2) R^T as its 6 unique entries, each (N,):
    (s00, s01, s02, s11, s12, s22)."""
    R = _rotation_entries(rot)
    m = [[R[i][k] * scale[:, k] for k in range(3)] for i in range(3)]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def build_cov3d(rot: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T as (N, 3, 3) matrices."""
    s00, s01, s02, s11, s12, s22 = build_cov3d_rows(rot, scale)
    return torch.stack([torch.stack([s00, s01, s02], -1),
                        torch.stack([s01, s11, s12], -1),
                        torch.stack([s02, s12, s22], -1)], dim=-2)


def project_gaussians(xyz: torch.Tensor, rot: torch.Tensor,
                      scale: torch.Tensor, opacity: torch.Tensor,
                      color: torch.Tensor, valid: torch.Tensor,
                      view: torch.Tensor, proj: torch.Tensor, tanfovx,
                      tanfovy, height: int, width: int) -> Projected:
    """EWA-project N Gaussians into one camera. All f32.

    `view`, `proj`: (4, 4); `tanfovx`, `tanfovy`: python floats or 0-dim
    tensors."""
    xyz = xyz.float()
    n = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    view = view.float()
    proj = proj.float()

    def apply44(M, row):
        return M[row, 0] * x + M[row, 1] * y + M[row, 2] * z + M[row, 3]

    tvx = apply44(view, 0)
    tvy = apply44(view, 1)
    tz = apply44(view, 2)
    in_front = tz > 0.2

    hx = apply44(proj, 0)
    hy = apply44(proj, 1)
    hw = apply44(proj, 3)
    p_w = 1.0 / (hw + 1e-7)
    mean2d = torch.stack([
        ((hx * p_w + 1.0) * width - 1.0) * 0.5,
        ((hy * p_w + 1.0) * height - 1.0) * 0.5], dim=-1)

    s00, s01, s02, s11, s12, s22 = build_cov3d_rows(rot.float(),
                                                    scale.float())
    tanfovx = torch.as_tensor(tanfovx, dtype=torch.float32, device=xyz.device)
    tanfovy = torch.as_tensor(tanfovy, dtype=torch.float32, device=xyz.device)
    # tensor / tensor: `scalar / tensor` would round twice (reciprocal, then
    # multiply) where JAX divides once
    fx = torch.full_like(tanfovx, width) / (2.0 * tanfovx)
    fy = torch.full_like(tanfovy, height) / (2.0 * tanfovy)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz_safe = torch.where(in_front, tz, 1.0)
    inv_z = 1.0 / tz_safe
    tx = torch.maximum(torch.minimum(tvx * inv_z, limx), -limx) * tz_safe
    ty = torch.maximum(torch.minimum(tvy * inv_z, limy), -limy) * tz_safe

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z

    Wv = view[:3, :3]
    t0 = [j00 * Wv[0, k] + j02 * Wv[2, k] for k in range(3)]
    t1 = [j11 * Wv[1, k] + j12 * Wv[2, k] for k in range(3)]
    sig = ((s00, s01, s02), (s01, s11, s12), (s02, s12, s22))

    def tsig(t, l):
        return t[0] * sig[0][l] + t[1] * sig[1][l] + t[2] * sig[2][l]

    u0 = [tsig(t0, l) for l in range(3)]
    u1 = [tsig(t1, l) for l in range(3)]
    a = u0[0] * t0[0] + u0[1] * t0[1] + u0[2] * t0[2] + 0.3
    b = u0[0] * t1[0] + u0[1] * t1[1] + u0[2] * t1[2]
    c = u1[0] * t1[0] + u1[1] * t1[1] + u1[2] * t1[2] + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    keep = in_front & det_ok & (valid.reshape(n) > 0.5)
    radius = torch.where(keep, radius, 0.0)
    mean2d = torch.where(keep[:, None], mean2d, -1e4)
    conic = torch.where(keep[:, None], conic, 0.0)
    # radius only feeds the tile binning: no gradient (ceil has none anyway)
    return Projected(mean2d=mean2d, conic=conic, depth=tz,
                     radius=radius.detach(),
                     opacity=opacity.reshape(n).float(), color=color.float())
