"""Stereo rectification from scratch (replaces cv2.stereoRectify et al.).

A copy of gps_gaussian_tpu/geometry/stereo.py (the port imports nothing
from the JAX package); both give the same bits on the same inputs. The port
splits the pair's camera solve (`rectify_stereo_cameras`, which online
inference times as the span `read.rectify`) from the sampling maps
(`rectify_map`), which only the training/val build needs: online inference
samples each view from its `(iR, K_src)` in one native pass
(`native.rectify_view`) and builds no map.

The reference rectifies each view pair with cv2.stereoRectify +
cv2.initUndistortRectifyMap + cv2.remap (reference lib/human_loader.py:262-283)
and erodes the valid mask with cv2.erode (:298-308).  This module
reimplements that math in numpy (it runs offline in the host data pipeline —
SURVEY.md §7 hard part 3).  Distortion is always zero in this pipeline, so
only the pinhole path is implemented.

Conventions follow OpenCV's Bouguet rectification: given the relative pose
(R, T) of cam1 w.r.t. cam0 (x1 = R x0 + T), both cameras are rotated by half
the relative rotation, then a common rotation aligns the baseline with the
x-axis.  The rectified projections share one focal; principal points differ
horizontally (flags=0, i.e. no CALIB_ZERO_DISPARITY — the cx difference is
the `offset` consumed by flow_to_inv_depth, reference lib/utils.py:114).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Rodrigues
# ---------------------------------------------------------------------------

def rodrigues_to_mat(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix."""
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]],
                  [k[2], 0, -k[0]],
                  [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def mat_to_rodrigues(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector."""
    R = np.asarray(R, dtype=np.float64)
    cos_theta = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if abs(np.pi - theta) < 1e-6:
        # near pi: extract axis from R + I
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs using off-diagonals
        i = int(np.argmax(axis))
        if axis[i] > 0:
            for j in range(3):
                if j != i and A[i, j] < 0:
                    axis[j] = -axis[j]
        axis = axis / (np.linalg.norm(axis) + 1e-18)
        return axis * theta
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2.0 * np.sin(theta)) * theta


# ---------------------------------------------------------------------------
# Bouguet stereo rectification (pinhole, zero distortion)
# ---------------------------------------------------------------------------

def stereo_rectify(K0: np.ndarray, K1: np.ndarray, image_size: tuple[int, int],
                   R: np.ndarray, T: np.ndarray):
    """Rectifying rotations and projections for a stereo pair.

    Drop-in math equivalent of
    cv2.stereoRectify(K0, 0, K1, 0, (W, H), R, T, flags=0)
    as called by reference lib/human_loader.py:262.

    Args:
      K0, K1: (3, 3) intrinsics.
      image_size: (W, H).
      R, T: relative pose of cam1 w.r.t cam0 (x1 = R x0 + T).
    Returns:
      R0, R1: (3, 3) rectifying rotations (applied in camera frames).
      P0, P1: (3, 4) rectified projections; P1[idx, 3] = fc_new * baseline.
    """
    nx, ny = float(image_size[0]), float(image_size[1])
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64).reshape(3)

    # Half-rotation that brings both cameras to the average orientation.
    om = mat_to_rodrigues(R)
    r_r = rodrigues_to_mat(-0.5 * om)
    t = r_r @ T

    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # Rotation that aligns the (half-rotated) baseline with the x (or y) axis.
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww = ww * (np.arccos(np.clip(abs(c) / nt, -1.0, 1.0)) / nw)
    wR = rodrigues_to_mat(ww)

    R0 = wR @ r_r.T
    R1 = wR @ r_r
    t_new = R1 @ T

    # Shared focal: average of the two cross-axis focals (fy for horizontal).
    ratio = 0.5  # newImgSize == imageSize
    fc_new = (K0[idx ^ 1, idx ^ 1] + K1[idx ^ 1, idx ^ 1]) * ratio

    # Principal points: keep the average projection of the 4 image corners
    # centered in the rectified image.
    cc_new = np.zeros((2, 2))
    corners = np.array([[0.0, 0.0], [nx - 1, 0.0], [0.0, ny - 1],
                        [nx - 1, ny - 1]])
    for k, (K, Rk) in enumerate(((K0, R0), (K1, R1))):
        xn = (corners[:, 0] - K[0, 2]) / K[0, 0]
        yn = (corners[:, 1] - K[1, 2]) / K[1, 1]
        p = np.stack([xn, yn, np.ones_like(xn)], axis=0)  # (3, 4)
        p = Rk @ p
        u = fc_new * p[0] / p[2]
        v = fc_new * p[1] / p[2]
        cc_new[k, 0] = (nx - 1) / 2 - u.mean()
        cc_new[k, 1] = (ny - 1) / 2 - v.mean()

    # flags=0: average only the coordinate orthogonal to the baseline, so the
    # disparity offset (cx1 - cx0) survives (reference relies on it).
    if idx == 0:
        cc_new[:, 1] = cc_new[:, 1].mean()
    else:
        cc_new[:, 0] = cc_new[:, 0].mean()

    def proj(cc, with_baseline):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cc
        P[2, 2] = 1.0
        if with_baseline:
            P[idx, 3] = t_new[idx] * fc_new
        return P

    return R0, R1, proj(cc_new[0], False), proj(cc_new[1], True)


def rectify_map(iR: np.ndarray, K_src: np.ndarray,
                image_size: tuple[int, int]):
    """Sampling maps for rectification remap (cv2.initUndistortRectifyMap)
    of one view, from iR = (K_new @ R)^-1 and its source intrinsics.

    For each rectified pixel (u, v): source pixel = K_src @ normalize(
    iR @ [u, v, 1]), in f64, cast to f32.  Zero distortion path only.

    Returns map_x, map_y of shape (H, W) float32.
    """
    w, h = image_size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    ones = np.ones_like(u)
    p = np.stack([u, v, ones], axis=0).reshape(3, -1)  # (3, H*W)
    q = iR @ p
    x = q[0] / q[2]
    y = q[1] / q[2]
    K_src = np.asarray(K_src, dtype=np.float64)
    map_x = (x * K_src[0, 0] + K_src[0, 2]).reshape(h, w).astype(np.float32)
    map_y = (y * K_src[1, 1] + K_src[1, 2]).reshape(h, w).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap with constant-0 border (cv2.remap INTER_LINEAR).

    img: (H, W) or (H, W, C); map_x/map_y: (H', W') source coordinates.
    """
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape

    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]

    def fetch(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], vals.astype(np.float64), 0.0)

    out = (fetch(y0, x0) * (1 - fx) * (1 - fy)
           + fetch(y0, x0 + 1) * fx * (1 - fy)
           + fetch(y0 + 1, x0) * (1 - fx) * fy
           + fetch(y0 + 1, x0 + 1) * fx * fy)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(img.dtype).min,
                      np.iinfo(img.dtype).max)
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out


def erode3x3(mask: np.ndarray) -> np.ndarray:
    """3x3 erosion (local min), border treated as +inf (cv2.erode default)."""
    m = np.asarray(mask, dtype=np.float32)
    pad = np.pad(m, 1, mode="constant", constant_values=np.inf)
    out = m.copy()
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = np.minimum(out, pad[dy:dy + m.shape[0], dx:dx + m.shape[1]])
    return out


def relative_pose(extr0: np.ndarray, extr1: np.ndarray):
    """(R, T) of cam1 w.r.t cam0 from world->cam extrinsics.

    E = E1 @ E0^-1 (reference lib/human_loader.py:250-259).
    """
    extr0 = np.asarray(extr0, dtype=np.float64)
    extr1 = np.asarray(extr1, dtype=np.float64)
    r0, t0 = extr0[:3, :3], extr0[:3, 3:]
    r1, t1 = extr1[:3, :3], extr1[:3, 3:]
    E0 = np.eye(4)
    E0[:3, :3], E0[:3, 3:] = r0.T, -r0.T @ t0   # cam0 -> world
    E1 = np.eye(4)
    E1[:3, :3], E1[:3, 3:] = r1, t1             # world -> cam1
    E = E1 @ E0
    return E[:3, :3], E[:3, 3]


def rectify_stereo_cameras(intr0, extr0, intr1, extr1, image_size):
    """The rectification camera solve for one stereo pair, without maps.

    Equivalent of reference lib/human_loader.py:245-285
    (get_rectified_stereo_data camera math). Returns the rectified camera
    dict (intrinsics/extrinsics of both views and the signed baseline term
    Tf_x) and, per view, `(iR, K_src)`: iR = (K_new @ R)^-1, which takes a
    rectified pixel [u, v, 1] to its ray in the source camera, and the
    source intrinsics, f64, from which `rectify_map` or
    `native.rectify_view` samples the view.
    """
    intr0 = np.asarray(intr0, dtype=np.float64)
    intr1 = np.asarray(intr1, dtype=np.float64)
    extr0 = np.asarray(extr0, dtype=np.float64)
    extr1 = np.asarray(extr1, dtype=np.float64)

    R, T = relative_pose(extr0, extr1)
    R0, R1, P0, P1 = stereo_rectify(intr0, intr1, image_size, R, T)

    camera = {
        "intr0": P0[:3, :3].astype(np.float32),
        "intr1": P1[:3, :3].astype(np.float32),
        "extr0": (R0 @ extr0[:3, :]).astype(np.float32),
        "extr1": (R1 @ extr1[:3, :]).astype(np.float32),
        "tf_x": np.float32(P1[0, 3]),
    }
    views = tuple((np.linalg.inv(P[:3, :3] @ Rk), K)
                  for P, Rk, K in ((P0, R0, intr0), (P1, R1, intr1)))
    return camera, views


def rectify_stereo_pair(intr0, extr0, intr1, extr1, image_size):
    """Full rectification of one stereo pair: `rectify_stereo_cameras` and
    the remap grids (map_x, map_y) of both views."""
    camera, views = rectify_stereo_cameras(intr0, extr0, intr1, extr1,
                                           image_size)
    map0, map1 = (rectify_map(iR, K, image_size) for iR, K in views)
    return camera, map0, map1
