"""Synthetic inputs made from a numpy seed, with no disk IO.

`fake_stereo_batch` is a copy of gps_gaussian_tpu/testing.py
`fake_stereo_batch` :13: the same seed draws the same numbers in the same
order, so both packages get bit-identical inputs. `build_scene` is a copy of
bench.py `build_scene` :24. `silhouette_stereo_batch` is a stereo pair with
a contiguous silhouette mask whose zero-flow geometry is a plane in front of
both cameras, for driving the serving path with random weights;
`silhouette_train_batch` adds what a training step reads (flow targets, a
novel camera between the two sources and its target image).
"""

from __future__ import annotations

import numpy as np
import torch

from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.utils.containers import (NovelCamera, NovelView,
                                                     SourceView, StereoSample)


def _t(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def fake_stereo_batch(batch: int = 1, res: int = 64,
                      novel_res: int | None = None, with_novel: bool = True,
                      seed: int = 0, device="cpu") -> StereoSample:
    """A geometrically plausible random batch with full camera tensors."""
    rng = np.random.default_rng(seed)
    novel_res = novel_res or res

    def view(offset: float) -> SourceView:
        K = np.array([[0.8 * res, 0, res / 2 + offset],
                      [0, 0.8 * res, res / 2],
                      [0, 0, 1]], np.float32)
        E = np.eye(3, 4, dtype=np.float32)
        E[0, 3] = offset * 0.01
        E[2, 3] = 2.0
        img = rng.uniform(-1, 1, (batch, res, res, 3)).astype(np.float32)
        mask = (rng.uniform(size=(batch, res, res, 1)) > 0.3).astype(
            np.float32)
        return SourceView(
            img=_t(img * mask, device), mask=_t(mask, device),
            intr=_t(np.tile(K, (batch, 1, 1)), device),
            ref_intr=_t(np.tile(K, (batch, 1, 1)), device),
            extr=_t(np.tile(E, (batch, 1, 1)), device),
            tf_x=torch.full((batch,), -40.0 if offset == 0 else 40.0,
                            device=device),
            flow=_t(rng.uniform(0, 8, (batch, res, res, 1)).astype(
                np.float32), device),
            valid=_t(mask, device))

    novel = None
    if with_novel:
        K = np.array([[0.8 * novel_res, 0, novel_res / 2],
                      [0, 0.8 * novel_res, novel_res / 2],
                      [0, 0, 1]], np.float32)
        E = np.eye(3, 4, dtype=np.float32)
        E[2, 3] = 2.0
        cam = cameras.camera_from_intr_extr(K, E, novel_res, novel_res)
        camera = cameras.make_novel_camera([cam] * batch, novel_res,
                                           novel_res, device=device)
        novel = NovelView(
            camera=camera,
            img=_t(rng.uniform(0, 1, (batch, novel_res, novel_res, 3))
                   .astype(np.float32), device),
            intr=_t(np.tile(K, (batch, 1, 1)), device),
            extr=_t(np.tile(E, (batch, 1, 1)), device))

    return StereoSample(lmain=view(0.0), rmain=view(3.0), novel=novel)


def silhouette_stereo_batch(res: int, fg_frac: float = 0.2, seed: int = 0,
                            device="cpu", batch: int = 1):
    """A rectified stereo pair (`batch` samples that share cameras and
    silhouette and differ in their images) with a capsule silhouette covering
    about `fg_frac` of each view, and the sample dict that
    `FreeviewRenderer.novel_camera_at` reads (intr_ori / extr_ori).

    The cameras sit 0.2 apart on x, looking down +z; each view's principal
    point is offset from the other's by `d` pixels and tf_x = -+2d, so zero
    predicted flow maps every foreground pixel to inverse depth 0.5 (z = 2).
    """
    rng = np.random.default_rng(seed)
    v = (np.arange(res, dtype=np.float32) + 0.5) / res
    w_amp = (fg_frac - 0.025) * np.pi / 2.0
    half = 0.0125 + w_amp * np.sin(np.pi * v) / 2.0
    mask = (np.abs(v[None, :] - 0.5) < half[:, None]).astype(np.float32)
    d = 0.05 * res
    f = 0.8 * res

    def view(cx, ref_cx, tx, tf_x):
        K = np.array([[f, 0, cx], [0, f, res / 2], [0, 0, 1]], np.float32)
        K_ref = K.copy()
        K_ref[0, 2] = ref_cx
        E = np.eye(3, 4, dtype=np.float32)
        E[0, 3] = tx
        img = rng.uniform(-1, 1, (batch, res, res, 3)).astype(np.float32)
        m = np.tile(mask[None, :, :, None], (batch, 1, 1, 1))
        sv = SourceView(img=_t(img * m, device), mask=_t(m, device),
                        intr=_t(np.tile(K, (batch, 1, 1)), device),
                        ref_intr=_t(np.tile(K_ref, (batch, 1, 1)), device),
                        extr=_t(np.tile(E, (batch, 1, 1)), device),
                        tf_x=torch.full((batch,), tf_x, device=device))
        return sv, K, E

    left, K0, E0 = view(res / 2, res / 2 + d, 0.1, -2.0 * d)
    right, K1, E1 = view(res / 2 + d, res / 2, -0.1, 2.0 * d)
    sample = {"intr_ori": (K0, K1), "extr_ori": (E0, E1)}
    return StereoSample(lmain=left, rmain=right), sample


def silhouette_train_batch(batch: int, res: int, novel_res: int,
                           fg_frac: float = 0.2, seed: int = 0,
                           device="cpu") -> StereoSample:
    """`silhouette_stereo_batch` with what a training step reads: flow
    targets (small seeded disparities, valid on the silhouette), and a novel
    view halfway between the two source cameras at `novel_res` with a
    seeded random target image."""
    sample, cams = silhouette_stereo_batch(res, fg_frac, seed, device, batch)
    rng = np.random.default_rng(seed + 1)
    for v in (sample.lmain, sample.rmain):
        v.flow = _t(rng.uniform(-2, 2, (batch, res, res, 1)).astype(
            np.float32), device) * v.mask
        v.valid = v.mask
    (K0, K1), (E0, E1) = cams["intr_ori"], cams["extr_ori"]
    cam, intr, extr = cameras.interpolated_novel_camera(
        K0, E0, K1, E1, 0.5, novel_res, novel_res,
        hr_scale=novel_res / res)
    img = rng.random((batch, novel_res, novel_res, 3), dtype=np.float32)
    sample.novel = NovelView(
        camera=cameras.make_novel_camera([cam] * batch, novel_res, novel_res,
                                         device=device),
        img=_t(img, device),
        intr=_t(np.tile(intr.astype(np.float32), (batch, 1, 1)), device),
        extr=_t(np.tile(extr.astype(np.float32), (batch, 1, 1)), device))
    return sample


def build_scene(res: int = 1024, fg_frac: float = 0.15, seed: int = 0):
    """Human-silhouette-like Gaussian cloud, N = 2 * res^2 candidates, with
    a contiguous capsule silhouette (numpy copy of bench.py build_scene)."""
    rng = np.random.default_rng(seed)
    n = 2 * res * res

    v = (np.arange(res, dtype=np.float32) + 0.5) / res
    w_amp = (fg_frac / 2.0 - 0.025 / 2) * np.pi / 2.0
    w = 0.0125 + w_amp * np.sin(np.pi * v)
    u = (np.arange(res, dtype=np.float32) + 0.5) / res
    mask1 = (np.abs(u[None, :] - 0.5) < w[:, None])
    valid = np.concatenate([mask1.reshape(-1), mask1.reshape(-1)]
                           ).astype(np.float32)

    yy, xx = np.nonzero(mask1)
    uu = (xx + 0.5) / res - 0.5
    vv = 1.0 - (yy + 0.5) / res
    rad = np.maximum(w[yy], 1e-3)
    theta = np.arcsin(np.clip(uu / rad, -1, 1))
    depth_off = 0.35 * rad * np.cos(theta)
    xyz1 = np.stack([
        uu * 1.2, vv * 1.7,
        depth_off + rng.normal(0, 0.01, uu.shape)], axis=-1
    ).astype(np.float32)
    xyz_all = np.zeros((n, 3), np.float32)
    fg_idx = np.concatenate([np.nonzero(mask1.reshape(-1))[0],
                             res * res + np.nonzero(mask1.reshape(-1))[0]])
    xyz_all[fg_idx[:xyz1.shape[0]]] = xyz1
    xyz_all[fg_idx[xyz1.shape[0]:]] = xyz1 + np.array(
        [0.01, 0.0, 0.005], np.float32)

    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    scale = rng.uniform(0.002, 0.01, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return xyz_all, q, scale, opacity, color, valid


def scene_camera(res: int) -> dict:
    """bench.py's camera for `build_scene`: 2 m in front, centred on the
    silhouette (numpy dict of `camera_from_intr_extr`)."""
    K = np.array([[0.8 * res, 0, res / 2],
                  [0, 0.8 * res, res / 2], [0, 0, 1]], np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    E[1, 3] = -0.85
    E[2, 3] = 2.0
    return cameras.camera_from_intr_extr(K, E, res, res)
