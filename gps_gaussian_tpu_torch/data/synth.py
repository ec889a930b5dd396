"""Procedural multi-view scene generator (synthetic stand-in for THuman2.0).

A copy of gps_gaussian_tpu/data/synth.py (the port imports nothing from the
JAX package): the same seed renders the same pixels in both.

Renders sphere-composite "human-ish" scenes with an analytic numpy
raytracer and writes the EXACT on-disk layout the reference's data-prep
produces (prepare_data/render_data.py:12-32, 213-228):

    <root>/<split>/img/<scan>/<vid>.jpg      (+ <vid>_hr.jpg for novel views)
    <root>/<split>/mask/<scan>/<vid>.png
    <root>/<split>/depth/<scan>/<vid>.png    uint16 = inverse-z * 2^15
    <root>/<split>/parm/<scan>/<vid>_intrinsic.npy / _extrinsic.npy

Camera rig mirrors the reference: 16-camera ring, radius 2.0 m, pitch -8
degrees, look-at (0, 0.85, 0); intrinsics fx=fy=0.8*res, cx=res/2,
cy=res/2 + 25*res/1024 (render_data.py:113-114, 153-161, 214-216).
Views 0,1 are the stereo sources (angle, angle+22.5 deg); 2,3,4 are novel
targets inside the arc (render_data.py:195-210).

Because depth is analytic (exact ray-sphere z), the GT disparity built from
it round-trips the full geometry pipeline with no discretisation error —
ideal test/benchmark fixtures.  THuman2.0 itself is not redistributable
(SURVEY.md §4d).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

RING_RADIUS = 2.0
PITCH_DEG = -8.0
LOOK_AT = np.array([0.0, 0.85, 0.0])
ARC_DEG = 22.5

_LIGHT_DIRS = np.array([
    [0.5, 0.7, 0.5], [-0.6, 0.4, 0.2], [0.1, 0.3, -0.9]])
_LIGHT_COLS = np.array([[1.0, 0.95, 0.9], [0.45, 0.5, 0.6], [0.5, 0.45, 0.4]])


def ring_camera(angle_rad: float, res: int):
    """Intrinsics + world->cam extrinsics for one ring position.

    OpenCV convention: x right, y down, z forward (positive depth)."""
    pitch = np.deg2rad(-PITCH_DEG)
    pos = LOOK_AT + RING_RADIUS * np.array([
        np.cos(pitch) * np.sin(angle_rad),
        np.sin(pitch),
        np.cos(pitch) * np.cos(angle_rad)])
    fwd = LOOK_AT - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])                   # world->cam rotation
    t = -R @ pos
    extr = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
    intr = np.array([[0.8 * res, 0.0, res / 2.0],
                     [0.0, 0.8 * res, res / 2.0 + 25.0 * res / 1024.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)
    return intr, extr


def humanoid_spheres(rng: np.random.Generator):
    """A randomized sphere-composite figure ~1.7 m tall near the origin."""
    centers, radii, colors = [], [], []

    def add(c, r, col):
        centers.append(c)
        radii.append(r)
        colors.append(col)

    jx, jz = rng.uniform(-0.1, 0.1, 2)
    skin = rng.uniform(0.45, 0.9, 3)
    shirt = rng.uniform(0.1, 0.95, 3)
    pants = rng.uniform(0.05, 0.6, 3)

    # head
    add([jx, 1.55, jz], 0.11, skin)
    # torso: stack of overlapping spheres
    for i, y in enumerate(np.linspace(1.0, 1.38, 5)):
        add([jx, y, jz], 0.16 - 0.01 * abs(i - 2), shirt)
    # arms
    for side in (-1, 1):
        swing = rng.uniform(-0.25, 0.25)
        for k, y in enumerate(np.linspace(1.32, 0.9, 5)):
            add([jx + side * (0.22 + 0.02 * k), y, jz + swing * k / 5],
                0.055, shirt if k < 2 else skin)
    # legs
    for side in (-1, 1):
        for y in np.linspace(0.78, 0.1, 6):
            add([jx + side * 0.09, y, jz], 0.08, pants)
    # feet
    for side in (-1, 1):
        add([jx + side * 0.09, 0.05, jz + 0.06], 0.07, pants * 0.6)

    return (np.asarray(centers, np.float64), np.asarray(radii, np.float64),
            np.asarray(colors, np.float64))


def render_spheres(centers, radii, colors, intr, extr, res: int):
    """Analytic ray-trace: returns (rgb uint8, mask uint8, inv_depth f32).

    Rays go through pixel centers (u+0.5, v+0.5); with unnormalised camera
    direction (z=1) the ray parameter t IS the camera z-depth, so the depth
    map is exact (no z-buffer quantisation)."""
    K = np.asarray(intr, np.float64)
    E = np.asarray(extr, np.float64)
    R, t = E[:3, :3], E[:3, 3]
    cam_pos = -R.T @ t

    u, v = np.meshgrid(np.arange(res) + 0.5, np.arange(res) + 0.5)
    d_cam = np.stack([(u - K[0, 2]) / K[0, 0],
                      (v - K[1, 2]) / K[1, 1],
                      np.ones_like(u)], axis=-1)        # (H, W, 3), z=1
    d_world = d_cam @ R                                  # R^T d
    o = cam_pos

    a = np.einsum("hwc,hwc->hw", d_world, d_world)       # (H, W)
    best_t = np.full((res, res), np.inf)
    best_i = np.full((res, res), -1, np.int64)
    for i, (c, r) in enumerate(zip(centers, radii)):
        oc = o - c
        b = 2.0 * d_world @ oc
        cq = oc @ oc - r * r
        disc = b * b - 4 * a * cq
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0 = (-b - sq) / (2 * a)
        t0 = np.where(t0 > 1e-4, t0, np.inf)
        closer = hit & (t0 < best_t)
        best_t = np.where(closer, t0, best_t)
        best_i = np.where(closer, i, best_i)

    mask = best_i >= 0
    inv_depth = np.where(mask, 1.0 / np.where(mask, best_t, 1.0), 0.0)

    # lambertian shading with a few directional lights + ambient
    pts = o + np.where(mask, best_t, 0.0)[..., None] * d_world
    rgb = np.zeros((res, res, 3))
    for i in range(len(centers)):
        sel = best_i == i
        if not sel.any():
            continue
        n = pts - centers[i]
        n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
        shade = 0.25 * np.ones((res, res, 3))
        for ld, lc in zip(_LIGHT_DIRS, _LIGHT_COLS):
            ldn = ld / np.linalg.norm(ld)
            lam = np.clip(n @ ldn, 0, 1)
            shade = shade + lam[..., None] * lc[None, None]
        rgb = np.where(sel[..., None], colors[i] * np.clip(shade, 0, 1.6) / 1.6,
                       rgb)

    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    rgb8 = np.where(mask[..., None], rgb8, 0)
    return rgb8, (mask * 255).astype(np.uint8), inv_depth.astype(np.float32)


def save_view(root: Path, scan: str, vid: int, rgb8, mask8, inv_depth,
              intr, extr, rgb8_hr=None):
    """Write one view in the reference layout (render_data.py:12-32)."""
    from PIL import Image

    for sub in ("img", "mask", "depth", "parm"):
        (root / sub / scan).mkdir(parents=True, exist_ok=True)
    Image.fromarray(rgb8).save(root / "img" / scan / f"{vid}.jpg", quality=95)
    if rgb8_hr is not None:
        Image.fromarray(rgb8_hr).save(root / "img" / scan / f"{vid}_hr.jpg",
                                      quality=95)
    Image.fromarray(mask8).convert("RGB").save(
        root / "mask" / scan / f"{vid}.png")
    depth16 = np.clip(inv_depth * (2.0 ** 15), 0, 65535).astype(np.uint16)
    Image.fromarray(depth16).save(root / "depth" / scan / f"{vid}.png")
    np.save(root / "parm" / scan / f"{vid}_intrinsic.npy",
            np.asarray(intr, np.float64))
    np.save(root / "parm" / scan / f"{vid}_extrinsic.npy",
            np.asarray(extr, np.float64))


def generate_scan(root: str | os.PathLike, scan: str, seed: int,
                  res: int = 256, hr: bool = True):
    """One scan = 2 source views + 3 novel views on a random ring arc
    (view ids and geometry as in render_data.py:195-210)."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    centers, radii, colors = humanoid_spheres(rng)

    base = rng.uniform(0, 2 * np.pi)
    arc = np.deg2rad(ARC_DEG)
    angles = {
        0: base,
        1: base + arc,
        2: base + rng.uniform(0.25, 0.75) * arc,
        3: base + 0.5 * arc,
        4: base + rng.uniform(0.1, 0.9) * arc,
    }
    for vid, ang in angles.items():
        intr, extr = ring_camera(ang, res)
        rgb8, mask8, invd = render_spheres(centers, radii, colors,
                                           intr, extr, res)
        rgb8_hr = None
        if hr and vid >= 2:   # novel views carry the 2x hi-res target
            intr_hr, _ = ring_camera(ang, res * 2)
            rgb8_hr, _, _ = render_spheres(centers, radii, colors,
                                           intr_hr, extr, res * 2)
        save_view(root, scan, vid, rgb8, mask8, invd, intr, extr, rgb8_hr)


def generate_dataset(root: str | os.PathLike, n_train: int = 4,
                     n_val: int = 2, res: int = 256, hr: bool = True,
                     seed: int = 1314):
    """Tiny train/val dataset in the reference directory structure."""
    root = Path(root)
    for i in range(n_train):
        generate_scan(root / "train", f"{i:04d}", seed + i, res, hr)
    for i in range(n_val):
        generate_scan(root / "val", f"{1000 + i:04d}", seed + 1000 + i,
                      res, hr)
    return root
