"""Rectified stereo-human dataset (capability of reference lib/human_loader.py).

Counterpart of gps_gaussian_tpu/data/thuman.py, of which it is a numpy copy
(the port imports nothing from the JAX package): the cache codec
`_encode_cache` :42 / `_decode_cache` :75, `unproject_inv_depth`,
`project_inv_depth`, `DatasetConfig` :126 and `StereoHumanDataset` :138
give the same bits on the same files. Samples are dicts of numpy arrays;
`data/loader.py collate` turns them into tensors. PIL is imported only
where an image file or the cache is read or written.

Reads the THuman-style layout (img/mask/depth/parm per scan — same layout
data/synth.py generates), stereo-rectifies each source pair with the
from-scratch Bouguet solver (geometry/stereo.py), builds ground-truth
disparity from ground-truth depth, and assembles fixed-shape numpy samples
for the typed StereoSample pytree.

Key behaviors mirrored from the reference:
* depth png is uint16 inverse-z * 2^15 (human_loader.py:93-94);
* GT flow: project GT points into the rectified cameras, remap, then
  disparity = -inv_depth * Tf_x, flow = (ref_cx - cx) - disparity, zeroed
  where inv_depth < 0.05 (stereo_pts2flow, human_loader.py:64-85);
* 3x3-eroded validity mask thresholded at 0.66 (human_loader.py:298-308);
* images normalised to [-1, 1] and pre-multiplied by the binarised mask
  (human_loader.py:322-327);
* one-time offline rectification cache (here: one .npz per scan instead of
  the reference's jpg/png/npy/json quartet, human_loader.py:131-163);
* novel-view target with optional 2x hi-res image + full splat camera
  (human_loader.py:213-243).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from gps_gaussian_tpu_torch import native
from gps_gaussian_tpu_torch.geometry import cameras, stereo
from gps_gaussian_tpu_torch.utils.profiling import count, span


def _read_img(path) -> np.ndarray:
    """An image or mask file decoded (span `read.decode`, counter
    `read.files_decoded`)."""
    from PIL import Image
    with span("read.decode"):
        count("read.files_decoded")
        return np.array(Image.open(path))


def _encode_cache(data: dict) -> dict:
    """Compact rectified-cache payload (format v2).

    Images become JPEG bytes (q95) and masks PNG bytes — the same
    lossy-image / lossless-mask trade the reference's jpg/png cache
    quartet makes (human_loader.py:131-163); validity stores as uint8.
    Flow stays f32: it is the training target.  The v1 full-float npz
    was several times the raw dataset size at production scale."""
    import io

    from PIL import Image

    out = {"cache_version": np.int32(2)}
    for k, v in data.items():
        if k.startswith("img"):
            buf = io.BytesIO()
            Image.fromarray(
                np.clip(np.asarray(v), 0, 255).astype(np.uint8)).save(
                buf, format="JPEG", quality=95)
            out[k + "_jpg"] = np.frombuffer(buf.getvalue(), np.uint8)
        elif k.startswith("mask"):
            buf = io.BytesIO()
            Image.fromarray(
                np.clip(np.asarray(v), 0, 255).astype(np.uint8)).save(
                buf, format="PNG")
            out[k + "_png"] = np.frombuffer(buf.getvalue(), np.uint8)
        elif k.startswith("valid"):
            out[k + "_u8"] = np.asarray(v, np.uint8)
        else:
            out[k] = v
    return out


def _decode_cache(raw: dict) -> dict:
    import io

    from PIL import Image

    if "cache_version" not in raw:
        return raw  # v1 full-float cache from older builds still loads
    out = {}
    for k, v in raw.items():
        if k == "cache_version":
            continue
        if k.endswith("_jpg"):
            out[k[:-4]] = np.array(Image.open(io.BytesIO(v.tobytes())))
        elif k.endswith("_png"):
            out[k[:-4]] = np.array(
                Image.open(io.BytesIO(v.tobytes()))).astype(np.float32)
        elif k.endswith("_u8"):
            out[k[:-3]] = v.astype(np.float32)
        else:
            out[k] = v
    return out


def _read_inv_depth(path) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path)).astype(np.float32) / (2.0 ** 15)


def unproject_inv_depth(inv_depth, intr, extr) -> np.ndarray:
    """(H, W) inverse depth -> (H, W, 3) world points (pixel centers at
    half-integers; reference human_loader.py:30-50)."""
    h, w = inv_depth.shape
    K = np.asarray(intr, np.float64)
    E = np.asarray(extr, np.float64)
    y, x = np.meshgrid(np.linspace(0.5, h - 0.5, h),
                       np.linspace(0.5, w - 0.5, w), indexing="ij")
    z = 1.0 / (inv_depth + 1e-8)
    pc = np.stack([(x - K[0, 2]) * z / K[0, 0],
                   (y - K[1, 2]) * z / K[1, 1], z], axis=-1)
    R, t = E[:3, :3], E[:3, 3]
    return (pc - t) @ R    # R^T (p - t), row-vector form


def project_inv_depth(pts, intr, extr) -> np.ndarray:
    """(H, W, 3) world points -> (H, W) inverse depth in the given camera."""
    E = np.asarray(extr, np.float64)
    z = pts @ E[2, :3] + E[2, 3]
    return (1.0 / (z + 1e-8)).astype(np.float32)


@dataclasses.dataclass
class DatasetConfig:
    data_root: str
    src_res: int = 256
    source_ids: Sequence[int] = (0, 1)
    train_novel_ids: Sequence[int] = (2, 3, 4)
    val_novel_ids: Sequence[int] = (3,)
    use_hr_img: bool = False
    use_processed_data: bool = True
    znear: float = 0.01
    zfar: float = 100.0


class StereoHumanDataset:
    def __init__(self, cfg: DatasetConfig, phase: str = "train"):
        self.cfg = cfg
        self.phase = phase
        if phase in ("train", "val"):
            self.root = Path(cfg.data_root) / phase
        else:
            self.root = Path(cfg.data_root)
        self.scans = sorted(os.listdir(self.root / "img"))
        self.cache_dir = (Path(cfg.data_root) / "rectified_local" / phase
                          if cfg.use_processed_data and phase != "test"
                          else None)
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self):
        return len(self.scans)

    # ---------------------------------------------------------------- io
    def load_view(self, scan: str, vid: int, hr: bool = False,
                  need_depth: bool = True):
        img = _read_img(self.root / "img" / scan /
                        (f"{vid}_hr.jpg" if hr else f"{vid}.jpg"))
        mask = _read_img(self.root / "mask" / scan / f"{vid}.png")
        if mask.ndim == 3:
            mask = mask[..., 0]
        with span("read.decode"):
            intr = np.load(self.root / "parm" / scan /
                           f"{vid}_intrinsic.npy")
            extr = np.load(self.root / "parm" / scan /
                           f"{vid}_extrinsic.npy")
        if hr:
            intr = intr.copy()
            intr[:2] *= 2
        pts = None
        depth_path = self.root / "depth" / scan / f"{vid}.png"
        if need_depth and depth_path.exists():
            inv_depth = _read_inv_depth(depth_path)
            pts = unproject_inv_depth(inv_depth, intr, extr)
        return img, mask, intr, extr, pts

    # ------------------------------------------------------ rectification
    def rectified_stereo(self, scan: str) -> dict:
        if self.cache_dir is not None:
            cache = self.cache_dir / f"{scan}.npz"
            if cache.exists():
                try:
                    return _decode_cache(dict(np.load(cache)))
                except Exception:
                    pass  # mid-write by another worker: rebuild below
            data = self._build_rectified(scan)
            # atomic publish so concurrent readers never see partial files
            tmp = cache.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            encoded = _encode_cache(data)
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **encoded)
            os.replace(tmp, cache)
            # return the decoded roundtrip, NOT the raw build: the jpg
            # quantization must be identical on the build epoch and every
            # later cache hit or samples drift between epochs
            return _decode_cache(encoded)
        return self._build_rectified(scan)

    def _build_rectified(self, scan: str) -> dict:
        """The training/val rectification of one scan: the pair's maps
        (span `read.rectify`), four remaps (`read.remap`) and, where the
        scan has depth, the GT flow and validity from its remapped inverse
        depth."""
        s0, s1 = self.cfg.source_ids
        img0, mask0, intr0, extr0, pts0 = self.load_view(scan, s0)
        img1, mask1, intr1, extr1, pts1 = self.load_view(scan, s1)
        size = (img0.shape[1], img0.shape[0])

        with span("read.rectify"):
            cam, map0, map1 = stereo.rectify_stereo_pair(
                intr0, extr0, intr1, extr1, size)

        # native C++ path (threaded); numpy fallback inside if no toolchain
        with span("read.remap"):
            new_img0 = native.remap_bilinear(img0, *map0)
            new_img1 = native.remap_bilinear(img1, *map1)
            new_mask0 = native.remap_bilinear(mask0.astype(np.float32),
                                              *map0)
            new_mask1 = native.remap_bilinear(mask1.astype(np.float32),
                                              *map1)

        out = {
            "img0": new_img0, "img1": new_img1,
            "mask0": new_mask0, "mask1": new_mask1,
            "intr0": cam["intr0"], "intr1": cam["intr1"],
            "extr0": cam["extr0"], "extr1": cam["extr1"],
            "tf_x": np.float32(cam["tf_x"]),
        }
        if pts0 is None:
            return out

        # GT flow from GT geometry (stereo_pts2flow equivalent)
        tf_x = float(cam["tf_x"])
        offset0 = cam["intr1"][0, 2] - cam["intr0"][0, 2]
        offset1 = -offset0
        for k, (pts, mp, intr_n, extr_n, off, tf) in enumerate((
                (pts0, map0, cam["intr0"], cam["extr0"], offset0, tf_x),
                (pts1, map1, cam["intr1"], cam["extr1"], offset1, -tf_x))):
            inv_d = project_inv_depth(pts, intr_n, extr_n)
            inv_d = native.remap_bilinear(inv_d, *mp)
            disparity = -inv_d * tf
            flow = off - disparity
            flow = np.where(inv_d < 0.05, 0.0, flow).astype(np.float32)

            valid = (out[f"mask{k}"] / 255.0).astype(np.float32)
            valid = native.erode3x3(valid)
            valid = (valid >= 0.66).astype(np.float32)
            flow = flow * valid
            out[f"flow{k}"] = flow
            out[f"valid{k}"] = valid
        return out

    # ----------------------------------------------------------- samples
    def get_sample(self, index: int, novel_ids: Optional[Sequence[int]],
                   rng: Optional[np.random.Generator] = None) -> dict:
        """One unbatched training/val sample as a dict of numpy arrays."""
        scan = self.scans[index % len(self.scans)]
        sd = self.rectified_stereo(scan)
        sample = {"name": scan}
        for k, view in enumerate(("lmain", "rmain")):
            img = sd[f"img{k}"].astype(np.float32) / 255.0
            mask = (sd[f"mask{k}"].astype(np.float32) / 255.0)
            mask_bin = (mask >= 0.5).astype(np.float32)
            img = (2.0 * img - 1.0) * mask[..., None]
            sample[view] = {
                "img": img.astype(np.float32),
                "mask": mask_bin[..., None],
                "intr": np.asarray(sd[f"intr{k}"], np.float32),
                "ref_intr": np.asarray(sd[f"intr{1 - k}"], np.float32),
                "extr": np.asarray(sd[f"extr{k}"], np.float32),
                "tf_x": np.float32(sd["tf_x"] if k == 0 else -sd["tf_x"]),
            }
            if f"flow{k}" in sd:
                sample[view]["flow"] = sd[f"flow{k}"][..., None]
                sample[view]["valid"] = sd[f"valid{k}"][..., None]

        if novel_ids is not None:
            vid = int((rng or np.random.default_rng()).choice(
                list(novel_ids)))
            sample["novel"] = self.novel_view(scan, vid)
        return sample

    def novel_view(self, scan: str, vid: int) -> dict:
        img, _, intr, extr, _ = self.load_view(
            scan, vid, hr=self.cfg.use_hr_img, need_depth=False)
        h, w = img.shape[:2]
        cam = cameras.camera_from_intr_extr(intr, extr, h, w,
                                            self.cfg.znear, self.cfg.zfar)
        return {
            "img": img.astype(np.float32) / 255.0,
            "intr": np.asarray(intr, np.float32),
            "extr": np.asarray(extr, np.float32),
            "height": h, "width": w,
            **cam,
        }

    def get_test_sample(self, index: int) -> dict:
        """Online-rectified inference sample with the ORIGINAL source
        cameras kept for novel-pose interpolation (reference
        human_loader.py:390-419), read in one pass. Span `read`, and under
        it: `read.decode` (each of the two sources' image and mask decoded
        once, and its camera files), `read.rectify` (the camera solve,
        `stereo.rectify_stereo_cameras`: no maps), `read.remap` (both
        views through `native.rectify_view`, rectified, sampled and
        normalised in one pass) and `read.normalize` (the sample's
        assembly). Counters: `read.files_needed` (the source images and
        masks that reach the sample), `read.views` (the views rectified)
        and `read.views_fused` (those the native kernel made, not its
        NumPy fallback)."""
        with span("read"):
            return self._test_sample(index)

    def _test_sample(self, index: int) -> dict:
        scan = self.scans[index % len(self.scans)]
        s0, s1 = self.cfg.source_ids
        img0, mask0, intr0, extr0, _ = self.load_view(scan, s0,
                                                      need_depth=False)
        img1, mask1, intr1, extr1, _ = self.load_view(scan, s1,
                                                      need_depth=False)
        count("read.files_needed", 4)   # two sources, image and mask each
        size = (img0.shape[1], img0.shape[0])
        with span("read.rectify"):
            cam, views = stereo.rectify_stereo_cameras(intr0, extr0, intr1,
                                                       extr1, size)
        with span("read.remap"):
            rect = [native.rectify_view(img, mask, iR, K, size)
                    for (img, mask), (iR, K) in zip(
                        ((img0, mask0), (img1, mask1)), views)]
        count("read.views", len(rect))
        count("read.views_fused", sum(fused for _, _, fused in rect))
        sample = {"name": scan}
        with span("read.normalize"):
            tf_x = np.float32(cam["tf_x"])
            for k, (view, (img, mask, _)) in enumerate(
                    zip(("lmain", "rmain"), rect)):
                sample[view] = {
                    "img": img, "mask": mask[..., None],
                    "intr": np.asarray(cam[f"intr{k}"], np.float32),
                    "ref_intr": np.asarray(cam[f"intr{1 - k}"], np.float32),
                    "extr": np.asarray(cam[f"extr{k}"], np.float32),
                    "tf_x": tf_x if k == 0 else -tf_x,
                }
            sample["intr_ori"] = (np.asarray(intr0, np.float32),
                                  np.asarray(intr1, np.float32))
            sample["extr_ori"] = (np.asarray(extr0, np.float32),
                                  np.asarray(extr1, np.float32))
        return sample
