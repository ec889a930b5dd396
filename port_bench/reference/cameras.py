# Frozen copy of gps_gaussian_tpu_torch/geometry/cameras.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Camera math: world<->view transforms, GL-style projection, pose interp.

Numpy copy of gps_gaussian_tpu/geometry/cameras.py (`camera_from_intr_extr`
:169, `interpolate_pose` :152, `make_novel_camera` :196,
`interpolated_novel_camera` :202 and their helpers), in plain column-vector
convention. Only `make_novel_camera` touches torch.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.containers import NovelCamera


def world_to_view(R_c2w_t: np.ndarray, t: np.ndarray,
                  translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """4x4 world->view matrix with optional recenter/rescale of the camera
    (R is passed transposed, as the reference's getWorld2View2 takes it)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R_c2w_t).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0

    c2w = np.linalg.inv(Rt)
    cam_center = (c2w[:3, 3] + np.asarray(translate)) * scale
    c2w[:3, 3] = cam_center
    return np.linalg.inv(c2w).astype(np.float32)


def extr_to_view(extr: np.ndarray, translate=(0.0, 0.0, 0.0),
                 scale: float = 1.0) -> np.ndarray:
    """4x4 world->view from a 3x4 [R|t] extrinsic."""
    extr = np.asarray(extr)
    R = extr[:3, :3].astype(np.float32).T
    t = extr[:3, 3].astype(np.float32)
    return world_to_view(R, t, translate, scale)


def projection_matrix(znear: float, zfar: float, K: np.ndarray,
                      h: int, w: int) -> np.ndarray:
    """Intrinsics-faithful off-center GL-style projection (w' = z)."""
    K = np.asarray(K)
    near_fx = znear / K[0, 0]
    near_fy = znear / K[1, 1]
    left = -(w - K[0, 2]) * near_fx
    right = K[0, 2] * near_fx
    bottom = (K[1, 2] - h) * near_fy
    top = K[1, 2] * near_fy

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * float(np.arctan(pixels / (2.0 * focal)))


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp_rotations(R0: np.ndarray, R1: np.ndarray,
                    ratio: float) -> np.ndarray:
    """Spherical interpolation between two rotation matrices."""
    q0 = mat_to_quat(R0)
    q1 = mat_to_quat(R1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1 = -q1
        dot = -dot
    dot = min(dot, 1.0)
    theta = np.arccos(dot)
    if theta < 1e-8:
        q = (1.0 - ratio) * q0 + ratio * q1
    else:
        s0 = np.sin((1.0 - ratio) * theta) / np.sin(theta)
        s1 = np.sin(ratio * theta) / np.sin(theta)
        q = s0 * q0 + s1 * q1
    q = q / np.linalg.norm(q)
    return quat_to_mat(q)


def interpolate_pose(intr0, extr0, intr1, extr1, ratio: float):
    """Slerp rotation + lerp translation/intrinsics between two cameras.
    Returns (intr_new (3, 3), extr_new (3, 4))."""
    intr0, intr1 = np.asarray(intr0), np.asarray(intr1)
    extr0, extr1 = np.asarray(extr0), np.asarray(extr1)
    R = slerp_rotations(extr0[:3, :3], extr1[:3, :3], ratio)
    t = (1.0 - ratio) * extr0[:3, 3] + ratio * extr1[:3, 3]
    extr_new = np.concatenate(
        [R.astype(np.float32), t.reshape(3, 1).astype(np.float32)], axis=1)
    intr_new = ((1.0 - ratio) * intr0 + ratio * intr1).astype(np.float32)
    return intr_new, extr_new


def camera_from_intr_extr(intr, extr, height: int, width: int,
                          znear: float = 0.01, zfar: float = 100.0,
                          translate=(0.0, 0.0, 0.0), scale: float = 1.0):
    """Per-sample camera arrays from K, [R|t]: dict of numpy view, proj
    (= P @ view), cam_center, tanfovx, tanfovy."""
    intr = np.asarray(intr, dtype=np.float32)
    extr = np.asarray(extr, dtype=np.float32)
    view = extr_to_view(extr, translate, scale)
    P = projection_matrix(znear, zfar, intr, height, width)
    proj = P @ view
    cam_center = np.linalg.inv(view)[:3, 3]
    fovx = focal2fov(intr[0, 0], width)
    fovy = focal2fov(intr[1, 1], height)
    return {
        "view": view.astype(np.float32),
        "proj": proj.astype(np.float32),
        "cam_center": cam_center.astype(np.float32),
        "tanfovx": np.float32(np.tan(fovx * 0.5)),
        "tanfovy": np.float32(np.tan(fovy * 0.5)),
    }


def make_novel_camera(cams: list[dict], height: int, width: int,
                      device="cpu") -> NovelCamera:
    """Stack per-sample camera dicts into a batched NovelCamera."""
    stack = {k: torch.as_tensor(np.stack([c[k] for c in cams]),
                                device=device) for k in cams[0]}
    return NovelCamera(height=height, width=width, **stack)


def interpolated_novel_camera(intr0, extr0, intr1, extr1, ratio: float,
                              height: int, width: int, *,
                              hr_scale: float = 1.0,
                              znear: float = 0.01, zfar: float = 100.0):
    """Interpolated camera for one sample; hr_scale multiplies the first two
    intrinsic rows (2.0 for the 2x high-res target).
    Returns (camera dict, intr_new, extr_new)."""
    intr_new, extr_new = interpolate_pose(intr0, extr0, intr1, extr1, ratio)
    if hr_scale != 1.0:
        intr_new = intr_new.copy()
        intr_new[:2] *= hr_scale
    cam = camera_from_intr_extr(intr_new, extr_new, height, width,
                                znear=znear, zfar=zfar)
    return cam, intr_new, extr_new
