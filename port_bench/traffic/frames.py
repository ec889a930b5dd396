"""Free-view test frames written in the reference's on-disk layout.

Frozen from gps_gaussian_tpu_torch/data/synth.py at commit 19aea69
(`ring_camera`, `humanoid_spheres`, `render_spheres`, `save_view`), with the
ray-sphere tracer evaluated by torch on the run's device instead of numpy on
one host core. A mix file (traffic/<name>.json) sets:

    n_frames      frames of the sequence, cycled in order by the window
    res           source view width and height
    arc_deg       angle between the two source cameras
    step_deg      ring angle between one frame's cameras and the next's
    jpeg_quality  of the written source images

Frame k of seed s is a figure drawn from numpy's default_rng(s) seen by the
source cameras at ring angle base + k * step_deg, base drawn from the same
generator: every seed gives the same number of frames, at the same sizes,
spread around the ring alike.

    <root>/img/<scan>/<vid>.jpg
    <root>/mask/<scan>/<vid>.png
    <root>/parm/<scan>/<vid>_intrinsic.npy / _extrinsic.npy
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

RING_RADIUS = 2.0
PITCH_DEG = -8.0
LOOK_AT = np.array([0.0, 0.85, 0.0])
LIGHT_DIRS = np.array([[0.5, 0.7, 0.5], [-0.6, 0.4, 0.2], [0.1, 0.3, -0.9]])
LIGHT_COLS = np.array([[1.0, 0.95, 0.9], [0.45, 0.5, 0.6], [0.5, 0.45, 0.4]])


def ring_camera(angle_rad: float, res: int):
    """Intrinsics + world->cam extrinsics for one ring position (OpenCV
    convention: x right, y down, z forward)."""
    pitch = np.deg2rad(-PITCH_DEG)
    pos = LOOK_AT + RING_RADIUS * np.array([
        np.cos(pitch) * np.sin(angle_rad), np.sin(pitch),
        np.cos(pitch) * np.cos(angle_rad)])
    fwd = LOOK_AT - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
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
    add([jx, 1.55, jz], 0.11, skin)
    for i, y in enumerate(np.linspace(1.0, 1.38, 5)):
        add([jx, y, jz], 0.16 - 0.01 * abs(i - 2), shirt)
    for side in (-1, 1):
        swing = rng.uniform(-0.25, 0.25)
        for k, y in enumerate(np.linspace(1.32, 0.9, 5)):
            add([jx + side * (0.22 + 0.02 * k), y, jz + swing * k / 5],
                0.055, shirt if k < 2 else skin)
    for side in (-1, 1):
        for y in np.linspace(0.78, 0.1, 6):
            add([jx + side * 0.09, y, jz], 0.08, pants)
    for side in (-1, 1):
        add([jx + side * 0.09, 0.05, jz + 0.06], 0.07, pants * 0.6)
    return (np.asarray(centers, np.float64), np.asarray(radii, np.float64),
            np.asarray(colors, np.float64))


def render_spheres(centers, radii, colors, intr, extr, res: int, device):
    """Ray-trace through pixel centres: (rgb uint8 (H, W, 3), mask uint8
    (H, W)) as numpy. Lambertian shading with three lights and ambient."""
    f64 = dict(dtype=torch.float64, device=device)
    K = torch.as_tensor(np.asarray(intr, np.float64), **f64)
    E = torch.as_tensor(np.asarray(extr, np.float64), **f64)
    R, t = E[:3, :3], E[:3, 3]
    o = -R.T @ t
    c = torch.as_tensor(centers, **f64)
    r = torch.as_tensor(radii, **f64)
    ax = torch.arange(res, **f64) + 0.5
    v, u = torch.meshgrid(ax, ax, indexing="ij")
    d_cam = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                         torch.ones_like(u)], dim=-1)
    d = d_cam @ R                                         # (H, W, 3)
    a = (d * d).sum(-1)
    oc = o[None] - c                                      # (S, 3)
    b = 2.0 * torch.einsum("hwc,sc->shw", d, oc)
    cq = (oc * oc).sum(-1) - r * r
    disc = b * b - 4 * a[None] * cq[:, None, None]
    t0 = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2 * a[None])
    t0 = torch.where((disc > 0) & (t0 > 1e-4), t0, torch.inf)
    best_t, best_i = t0.min(dim=0)
    mask = torch.isfinite(best_t)
    pts = o + torch.where(mask, best_t, 0.0)[..., None] * d
    n = pts - c[best_i]
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)
    shade = torch.full(n.shape, 0.25, **f64)
    for ld, lc in zip(LIGHT_DIRS, LIGHT_COLS):
        ldn = torch.as_tensor(ld / np.linalg.norm(ld), **f64)
        lam = torch.clamp(n @ ldn, 0, 1)
        shade = shade + lam[..., None] * torch.as_tensor(lc, **f64)
    col = torch.as_tensor(colors, **f64)[best_i]
    rgb = col * torch.clamp(shade, 0, 1.6) / 1.6
    rgb8 = (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)
    rgb8 = torch.where(mask[..., None], rgb8, 0)
    return rgb8.cpu().numpy(), (mask.to(torch.uint8) * 255).cpu().numpy()


def save_view(root: Path, scan: str, vid: int, rgb8, mask8, intr, extr,
              quality: int):
    from PIL import Image

    for sub in ("img", "mask", "parm"):
        (root / sub / scan).mkdir(parents=True, exist_ok=True)
    Image.fromarray(rgb8).save(root / "img" / scan / f"{vid}.jpg",
                               quality=quality)
    Image.fromarray(mask8).convert("RGB").save(
        root / "mask" / scan / f"{vid}.png")
    np.save(root / "parm" / scan / f"{vid}_intrinsic.npy",
            np.asarray(intr, np.float64))
    np.save(root / "parm" / scan / f"{vid}_extrinsic.npy",
            np.asarray(extr, np.float64))


def write_sequence(root, mix: dict, seed: int, device) -> list:
    """Write the mix's frames under `root`; returns their scan names in
    order (views 0 and 1 of each are the stereo sources)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 2 * np.pi)
    arc = np.deg2rad(mix["arc_deg"])
    step = np.deg2rad(mix["step_deg"])
    res = mix["res"]
    names = []
    for k in range(mix["n_frames"]):
        name = f"{k:04d}"
        centers, radii, colors = humanoid_spheres(rng)
        for vid, ang in ((0, base + k * step), (1, base + k * step + arc)):
            intr, extr = ring_camera(ang, res)
            rgb8, mask8 = render_spheres(centers, radii, colors, intr, extr,
                                         res, device)
            save_view(root, name, vid, rgb8, mask8, intr, extr,
                      mix["jpeg_quality"])
        names.append(name)
    return names
