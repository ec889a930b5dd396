"""Synthetic inputs made from a numpy seed, with no disk IO.

`fake_stereo_batch` is a copy of gps_gaussian_tpu/testing.py
`fake_stereo_batch` :13: the same seed draws the same numbers in the same
order, so both packages get bit-identical inputs. `build_scene` is a copy of
bench.py `build_scene` :24. `silhouette_stereo_batch` is a stereo pair with
a contiguous silhouette mask whose zero-flow geometry is a plane in front of
both cameras, for driving the serving path with random weights;
`silhouette_train_batch` adds what a training step reads (flow targets, a
novel camera between the two sources and its target image).

Two datasets with the interface of `data/thuman.py StereoHumanDataset`
(`scans`, `__len__`, `get_sample`, `get_test_sample`, `novel_view`) need no
files and no image codec: `SynthMemoryDataset` renders the scenes of
`data/synth.py generate_scan` in memory and runs the real rectification,
flow and sampling code on them; `SilhouetteDataset` serves silhouette
stereo pairs at any width, for full-width training runs.

`humanoid_mesh` and `write_scan` make a textured scan for
`data/render_scans.py` from a seed (no scan is downloaded).

`spawn_ranks` runs one of the rank workers below (`rank_render`,
`rank_train_steps`, `rank_eval`, `rank_trainer`, or several in turn with
`rank_sequence`) in spawned processes joined by a gloo group, for the tests
and the GPU smoke run. The children import this module and the port only.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback
import uuid
from concurrent.futures import Executor
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gps_gaussian_tpu_torch.data import synth
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset,
                                                unproject_inv_depth)
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


def _scan_scene(seed: int):
    """The spheres and the view angles of `synth.generate_scan(seed)`,
    drawn from its generator in the same order."""
    rng = np.random.default_rng(seed)
    centers, radii, colors = synth.humanoid_spheres(rng)
    base = rng.uniform(0, 2 * np.pi)
    arc = np.deg2rad(synth.ARC_DEG)
    angles = {
        0: base,
        1: base + arc,
        2: base + rng.uniform(0.25, 0.75) * arc,
        3: base + 0.5 * arc,
        4: base + rng.uniform(0.1, 0.9) * arc,
    }
    return centers, radii, colors, angles


def render_synth_view(seed: int, vid: int, res: int, hr: bool):
    """One view of `synth.generate_scan(seed, res)` as its files would hold
    it, without the files: (rgb uint8, mask uint8, inverse depth quantized
    as the uint16 depth file stores it, intrinsics and extrinsics as the
    float64 .npy files hold them). `hr` renders the 2x target of a novel
    view (its rgb is the `<vid>_hr.jpg` image; the rest is of the 2x
    render). The images skip the JPEG round trip."""
    centers, radii, colors, angles = _scan_scene(seed)
    scale = 2 if hr else 1
    intr, extr = synth.ring_camera(angles[vid], res * scale)
    rgb8, mask8, invd = synth.render_spheres(centers, radii, colors, intr,
                                             extr, res * scale)
    depth16 = np.clip(invd * (2.0 ** 15), 0, 65535).astype(np.uint16)
    return (rgb8, mask8, depth16.astype(np.float32) / (2.0 ** 15),
            np.asarray(intr, np.float64), np.asarray(extr, np.float64))


def _render_key(args):
    seed, vid, res, hr = args
    return render_synth_view(seed, vid, res, hr)


def synth_scans(split: str, n: int, seed: int = 1314) -> dict:
    """{scan name: seed} of `synth.generate_dataset(seed=seed)`'s first `n`
    scans of `split` ("train" or "val")."""
    first = 0 if split == "train" else 1000
    return {f"{first + i:04d}": seed + first + i for i in range(n)}


_ICOSAHEDRON_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
    [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
    [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
    [8, 6, 7], [9, 8, 1]])


def icosphere(level: int):
    """The unit icosphere subdivided `level` times: (verts (10 * 4^level + 2,
    3) f64, faces (20 * 4^level, 3) i64)."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    f = _ICOSAHEDRON_FACES
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        m01, m12, m20 = (len(v) + inv.reshape(3, -1))
        v = np.concatenate([v, mid / np.linalg.norm(mid, axis=1,
                                                    keepdims=True)])
        a, b, c = f.T
        f = np.concatenate([np.stack(tri, axis=1) for tri in (
            (a, m01, m20), (b, m12, m01), (c, m20, m12), (m01, m12, m20))])
    return v, f


def humanoid_mesh(seed: int, levels=(5, 4), tex_res: int = 1024):
    """A textured stand-in for a human scan, made from a seed: the spheres
    of data/synth.py `humanoid_spheres` as icospheres, the head and torso
    subdivided levels[0] times and the limbs levels[1] times (245,760
    triangles at (5, 4)). Each sphere maps its longitude and latitude into
    its own band of a tex_res^2 texture in its colour, shaded by seeded
    noise. Returns (verts (V, 3) f32, faces (F, 3) i32, uv (V, 2) f32,
    tex (tex_res, tex_res, 3) f32 in [0, 1])."""
    rng = np.random.default_rng(seed)
    centers, radii, colors = synth.humanoid_spheres(rng)
    n = len(centers)
    spheres = {lv: icosphere(lv) for lv in set(levels)}
    verts, faces, uv = [], [], []
    base = 0
    for k, (c, r) in enumerate(zip(centers, radii)):
        v, f = spheres[levels[0] if k < 6 else levels[1]]
        lon = np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5
        lat = np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi
        verts.append(c + r * v)
        faces.append(f + base)
        uv.append(np.stack([lon, (k + 0.02 + 0.96 * lat) / n], axis=1))
        base += len(v)
    band = (np.arange(tex_res) * n) // tex_res
    noise = np.kron(rng.uniform(0.7, 1.0, (32, 32)),
                    np.ones((tex_res // 32, tex_res // 32)))
    tex = colors[band][:, None, :] * noise[..., None]
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32),
            np.concatenate(uv).astype(np.float32), tex.astype(np.float32))


def write_scan(scans_dir, name: str, verts, faces, uv=None, tex=None):
    """Write a scan as `data/render_scans.py render_dataset` reads it:
    <scans_dir>/<name>/<name>.obj (v, vt, and f with v/vt indices) and,
    with a texture, <scans_dir>/<name>/tex.png (needs Pillow)."""
    d = Path(scans_dir) / name
    d.mkdir(parents=True, exist_ok=True)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts.tolist()]
    if uv is not None:
        lines += [f"vt {u:.6f} {v:.6f}" for u, v in uv.tolist()]
        lines += [f"f {a}/{a} {b}/{b} {c}/{c}"
                  for a, b, c in (faces + 1).tolist()]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in (faces + 1).tolist()]
    (d / f"{name}.obj").write_text("\n".join(lines) + "\n")
    if tex is not None:
        from PIL import Image

        Image.fromarray(np.round(np.clip(tex, 0, 1) * 255).astype(
            np.uint8)).save(d / "tex.png")


class SynthMemoryDataset(StereoHumanDataset):
    """A StereoHumanDataset whose `load_view` alone is replaced by in-memory
    renders of `synth.generate_scan` (same seeds, cameras and view ids);
    rectification, ground-truth flow, erosion and sampling run the real
    code. `scans` maps each scan name to its seed (generate_dataset names
    train scan i "%04d" % i with seed 1314 + i, val scan i "%04d" %
    (1000 + i) with seed 2314 + i). No cache: `use_processed_data` is
    ignored. Views are rendered at first use and kept; `prerender` renders
    many at once in worker processes."""

    def __init__(self, cfg: DatasetConfig, scans: Mapping[str, int],
                 phase: str = "val"):
        self.cfg = cfg
        self.phase = phase
        self.root = None
        self.cache_dir = None
        self.seeds = dict(scans)
        self.scans = sorted(self.seeds)
        self._views: dict = {}

    def _view(self, scan: str, vid: int, hr: bool):
        key = (self.seeds[scan], vid, self.cfg.src_res, hr)
        if key not in self._views:
            self._views[key] = render_synth_view(*key)
        return self._views[key]

    def prerender(self, vids: Sequence[int], hr_vids: Sequence[int],
                  pool: Executor) -> Callable[[], None]:
        """Start rendering views `vids` and the 2x targets of `hr_vids` of
        every scan in `pool`'s worker processes; returns a callable that
        waits for them and keeps them."""
        # a 2x target's mask and depth are its base view's, as on disk
        keys = [(self.seeds[s], v, self.cfg.src_res, hr)
                for s in self.scans
                for v, hr in [(v, False) for v in (*vids, *hr_vids)]
                + [(v, True) for v in hr_vids]]
        keys = [k for k in dict.fromkeys(keys) if k not in self._views]
        futures = [pool.submit(_render_key, k) for k in keys]
        return lambda: self._views.update(
            (k, f.result()) for k, f in zip(keys, futures))

    def load_view(self, scan: str, vid: int, hr: bool = False,
                  need_depth: bool = True):
        # as the files hold it: a 2x target is an image alone, its mask and
        # depth are the base view's and its intrinsics the base ones doubled
        rgb8, mask8, inv_depth, intr, extr = self._view(scan, vid, False)
        intr = intr.copy()
        if hr:
            rgb8 = self._view(scan, vid, True)[0]
            intr[:2] *= 2
        pts = (unproject_inv_depth(inv_depth, intr, extr) if need_depth
               else None)
        return rgb8, mask8, intr, extr.copy(), pts


class SilhouetteDataset:
    """Silhouette stereo pairs (`silhouette_stereo_batch`'s rig) served
    sample by sample with the StereoHumanDataset interface, at any width:
    `res`^2 sources with seeded images and flow targets, novel views
    2, 3, 4 at ratios 0.25, 0.5, 0.75 between the sources with seeded
    `novel_res`^2 target images. Sample `i` draws from
    default_rng([seed, i]), so it is the same in every process."""

    def __init__(self, res: int, novel_res: int, n_scans: int,
                 fg_frac: float = 0.2, seed: int = 0):
        self.res, self.novel_res = res, novel_res
        self.fg_frac, self.seed = fg_frac, seed
        self.scans = [f"sil{i:04d}" for i in range(n_scans)]

    def __len__(self):
        return len(self.scans)

    def _rig(self):
        res = self.res
        v = (np.arange(res, dtype=np.float32) + 0.5) / res
        w_amp = (self.fg_frac - 0.025) * np.pi / 2.0
        half = 0.0125 + w_amp * np.sin(np.pi * v) / 2.0
        mask = (np.abs(v[None, :] - 0.5) < half[:, None]).astype(np.float32)
        d, f = 0.05 * res, 0.8 * res
        views = []
        for cx, ref_cx, tx, tf_x in ((res / 2, res / 2 + d, 0.1, -2.0 * d),
                                     (res / 2 + d, res / 2, -0.1, 2.0 * d)):
            K = np.array([[f, 0, cx], [0, f, res / 2], [0, 0, 1]],
                         np.float32)
            K_ref = K.copy()
            K_ref[0, 2] = ref_cx
            E = np.eye(3, 4, dtype=np.float32)
            E[0, 3] = tx
            views.append((K, K_ref, E, np.float32(tf_x)))
        return mask[..., None], views

    def _sources(self, index: int, with_flow: bool) -> dict:
        rng = np.random.default_rng([self.seed, index % len(self)])
        mask, views = self._rig()
        sample = {"name": self.scans[index % len(self)]}
        for name, (K, K_ref, E, tf_x) in zip(("lmain", "rmain"), views):
            img = rng.uniform(-1, 1, mask.shape[:2] + (3,)).astype(
                np.float32)
            sample[name] = {"img": img * mask, "mask": mask, "intr": K,
                            "ref_intr": K_ref, "extr": E, "tf_x": tf_x}
            if with_flow:
                sample[name]["flow"] = rng.uniform(
                    -2, 2, mask.shape).astype(np.float32) * mask
                sample[name]["valid"] = mask
        return sample

    def novel_view(self, scan: str, vid: int) -> dict:
        _, ((K0, _, E0, _), (K1, _, E1, _)) = self._rig()
        n = self.novel_res
        cam, intr, extr = cameras.interpolated_novel_camera(
            K0, E0, K1, E1, (vid - 1) / 4.0, n, n, hr_scale=n / self.res)
        rng = np.random.default_rng([self.seed, self.scans.index(scan),
                                     vid])
        return {"img": rng.random((n, n, 3), dtype=np.float32),
                "intr": intr.astype(np.float32),
                "extr": extr.astype(np.float32),
                "height": n, "width": n, **cam}

    def get_sample(self, index: int, novel_ids: Optional[Sequence[int]],
                   rng: Optional[np.random.Generator] = None) -> dict:
        sample = self._sources(index, with_flow=True)
        if novel_ids is not None:
            vid = int((rng or np.random.default_rng()).choice(
                list(novel_ids)))
            sample["novel"] = self.novel_view(sample["name"], vid)
        return sample

    def get_test_sample(self, index: int) -> dict:
        sample = self._sources(index, with_flow=False)
        _, ((K0, _, E0, _), (K1, _, E1, _)) = self._rig()
        sample["intr_ori"] = (K0, K1)
        sample["extr_ori"] = (E0, E1)
        return sample


class DelayedDataset:
    """`dataset` with a pause before each sample: `delays[i % len]` seconds
    for index i, so that a loader's workers finish batches out of the order
    in which they took them."""

    def __init__(self, dataset, delays: Sequence[float]):
        self.dataset = dataset
        self.delays = list(delays)
        self.scans = dataset.scans

    def __len__(self):
        return len(self.dataset)

    def get_sample(self, index: int, novel_ids, rng=None) -> dict:
        time.sleep(self.delays[index % len(self.delays)])
        return self.dataset.get_sample(index, novel_ids, rng)


# ------------------------------------------------------------ rank workers


def take_rows(obj, rows: slice):
    """A dataclass of batched tensors (StereoSample, FlatGaussians, ...)
    with every tensor cut to `rows` of its leading axis; other fields are
    kept."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v[rows]
        elif dataclasses.is_dataclass(v):
            changes[f.name] = take_rows(v, rows)
    return dataclasses.replace(obj, **changes)


def _launches() -> dict:
    from gps_gaussian_tpu_torch.kernels import build

    return dict(build.LAUNCHES)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rank_render(rank: int, world: int, group, p: dict) -> dict:
    """`rasterize_tile_sharded` of p["gauss"] into p["camera"] over `group`
    (bg p["bg"], config p["cfg"], on p["device"]). Returns the image,
    transmittance and counters on the CPU, and the kernel launches."""
    from gps_gaussian_tpu_torch.kernels import build
    from gps_gaussian_tpu_torch.kernels.rasterizer.sharded import \
        rasterize_tile_sharded

    build.reset_launch_counts()
    img, aux = rasterize_tile_sharded(p["gauss"], p["camera"], p["bg"],
                                      p["cfg"], group, device=p["device"])
    _sync(p["device"])
    return {"img": img.cpu(), "trans": aux.transmittance.cpu(),
            "counters": [int(aux.num_dropped[0]), int(aux.num_fg_dropped[0]),
                         int(aux.num_pair_dropped[0])],
            "launches": _launches()}


def _batch(spec, device):
    """The global batch that spec = (function name in this module, kwargs)
    builds, on `device`."""
    name, kwargs = spec
    return globals()[name](**kwargs).to(device)


def _model_and_state(p: dict):
    """(model, TrainState) of p["cfg"] on p["device"], the model's weights
    loaded from the file p["init"] (a state_dict)."""
    from gps_gaussian_tpu_torch.train import state as state_lib
    from gps_gaussian_tpu_torch.train.trainer import make_model

    cfg = p["cfg"]
    model = make_model(cfg, with_gs=cfg.stage == "stage2")
    model.load_state_dict(torch.load(p["init"], map_location="cpu",
                                     weights_only=True))
    return model, state_lib.create_state(cfg, model, p["device"])


def rank_train_steps(rank: int, world: int, group, p: dict) -> dict:
    """p["steps"] data-parallel training steps (`make_sharded_train_step`)
    from the weights in the file p["init"], each rank on its rows of the
    global batch p["batch"] (see `_batch`). Rank 0 writes the parameters
    after the steps to p["out"]. Returns each step's metrics and host-clock
    ms, the peak memory on a CUDA device and the kernel launches."""
    from gps_gaussian_tpu_torch.kernels import build
    from gps_gaussian_tpu_torch.train import sharding
    from gps_gaussian_tpu_torch.train.trainer import (make_raster_config,
                                                      make_sharded_train_step)

    cfg, dev = p["cfg"], torch.device(p["device"])
    model, state = _model_and_state(p)
    step = make_sharded_train_step(model, cfg, cfg.stage,
                                   make_raster_config(cfg), state, group, dev)
    batch = take_rows(_batch(p["batch"], dev),
                      sharding.rank_rows(cfg.batch_size, group))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    metrics, step_ms = [], []
    for _ in range(p["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        m = step(batch)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, p["out"])
    return {"metrics": metrics, "step_ms": step_ms,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
            "launches": _launches()}


def rank_eval(rank: int, world: int, group, p: dict) -> dict:
    """`make_sharded_eval_step` on this rank's rows of the batch p["batch"]
    and of the weights p["weight"]: the (numerator, denominator) sums."""
    from gps_gaussian_tpu_torch.train import sharding
    from gps_gaussian_tpu_torch.train.trainer import (make_raster_config,
                                                      make_sharded_eval_step)

    cfg, dev = p["cfg"], torch.device(p["device"])
    model, _ = _model_and_state(p)
    eval_step = make_sharded_eval_step(model, cfg, cfg.stage,
                                       make_raster_config(cfg), group, dev)
    rows = sharding.rank_rows(cfg.batch_size, group)
    metrics, _ = eval_step(take_rows(_batch(p["batch"], dev), rows),
                           p["weight"][rows])
    return {k: (float(n), float(d)) for k, (n, d) in metrics.items()}


def rank_trainer(rank: int, world: int, group, p: dict) -> dict:
    """A `Trainer` over `group` (config p["cfg"], datasets p["train_ds"]
    and p["val_ds"], run directory p["exp_dir"]) trained to step
    p["steps"], then its val sweep; rank 0 writes the parameters to
    p["out"]. Returns the logged history, the sweep's metrics, the run's
    checkpoint files, the peak memory of the training on a CUDA device and
    its kernel launches."""
    from gps_gaussian_tpu_torch.kernels import build
    from gps_gaussian_tpu_torch.train.trainer import Trainer

    dev = torch.device(p["device"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(p["cfg"], exp_dir=p["exp_dir"], dataset=p["train_ds"],
                      val_dataset=p["val_ds"], device=p["device"],
                      group=group)
    build.reset_launch_counts()
    try:
        trainer.train(num_steps=p["steps"])
        launches = _launches()
        peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    if dev.type == "cuda" else None)
        val = trainer.run_eval(p["steps"])
    finally:
        trainer.close()
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    trainer.model.state_dict().items()}, p["out"])
    return {"history": trainer.history, "val": val,
            "ckpts": sorted(os.listdir(Path(p["exp_dir"]) / "ckpt")),
            "peak_gib": peak_gib, "launches": launches}


def rank_sequence(rank: int, world: int, group, p: dict) -> list:
    """Several workers in turn on one group: p["steps"] is a list of
    (worker name, its payload); returns their results in order."""
    return [globals()[name](rank, world, group, payload)
            for name, payload in p["steps"]]


def _rank_entry(target: str, rank: int, world: int, init_method: str,
                payload: dict, out_q) -> None:
    """A spawned rank: join the gloo group, run `target`, report
    (rank, ok, pickled result or traceback) on `out_q`. The result is
    pickled by value: tensors put on a queue as they are would be shared
    through file descriptors that close when this process exits."""
    try:
        dev = torch.device(payload.get("device", "cpu"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks share the threads their parent may use
            torch.set_num_threads(max(1, int(os.environ.get(
                "OMP_NUM_THREADS") or os.cpu_count() or 1) // world))
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            out = globals()[target](rank, world, dist.group.WORLD, payload)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        out_q.put((rank, False, traceback.format_exc()))


def spawn_ranks(target: str, world: int, payload: dict, workdir,
                timeout: float = 120.0) -> list:
    """Run `target(rank, world, group, payload)` (a rank worker of this
    module) in `world` spawned processes joined by a gloo group that meets
    through a file in `workdir` (no network port). Every rank gets the same
    payload; a CUDA payload["device"] puts every rank on that one card.
    Returns the ranks' results in rank order. Raises when a rank fails or
    `timeout` seconds pass, and kills the ranks still running."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    init = Path(workdir) / f"pg-{uuid.uuid4().hex}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, f"file://{init}", payload,
                               out_q))
             for r in range(world)]
    for proc in procs:
        proc.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{target}: {world - len(results)} of "
                                   f"{world} ranks did not finish in "
                                   f"{timeout:.0f} s")
            try:
                r, ok, out = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, proc in enumerate(procs)
                        if i not in results and proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{target}: rank {dead[0]} exited "
                                       f"with code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"{target}: rank {r} failed:\n{out}")
            results[r] = pickle.loads(out)
    finally:
        for proc in procs:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        if init.exists():
            init.unlink()
    return [results[r] for r in range(world)]
