"""Free-view novel-view serving: the stereo network runs once per frame,
then any number of novel views are splatted from its Gaussians.

Counterpart of gps_gaussian_tpu/infer/freeview.py `compact_valid` :30,
`FreeviewRenderer` (`gaussians`, `render`, `flush_drop_report`,
`novel_camera_at`, the dataset-driven sweeps `infer_static` :224 and
`infer_sequence` :253) and `load_renderer` :277. Given a torch.distributed
group of several ranks, every rank runs the stereo forward, takes rank 0's
compacted Gaussians, and renders its band of tile rows
(kernels/rasterizer/sharded.py); every rank returns the whole image.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

import torch

from gps_gaussian_tpu_torch.data.loader import collate
from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.kernels.rasterizer import (compact_super_rows,
                                                       rasterize)
from gps_gaussian_tpu_torch.kernels.rasterizer.sharded import \
    rasterize_tile_sharded
from gps_gaussian_tpu_torch.train import sharding
from gps_gaussian_tpu_torch.train import state as state_lib
from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.train.trainer import make_model, make_raster_config
from gps_gaussian_tpu_torch.utils.containers import (FlatGaussians,
                                                     NovelCamera,
                                                     StereoSample)
from gps_gaussian_tpu_torch.utils.device import resolve_device

log = logging.getLogger("gps_tpu_torch.infer")


def compact_valid(gauss: FlatGaussians, cap: int):
    """Pack batch-1 valid (> 0) Gaussians into `cap` rows, once per frame.

    Groups of 8 rows that hold a valid row are kept whole, in order, and
    the valid rows of the groups past the cap are counted
    (`compact_super_rows`, the JAX version's layout). A cap of at least N
    pads in place; otherwise `cap` and N must be multiples of 8.
    Returns (FlatGaussians with `cap` rows, num_dropped)."""
    n = gauss.valid.shape[1]
    valid_f = (gauss.valid[0] > 0.0).float()
    fields = (gauss.xyz[0], gauss.rot[0], gauss.scale[0],
              gauss.opacity[0].reshape(n, 1), gauss.rgb[0])
    if cap >= n:
        def pad(x):
            return torch.nn.functional.pad(x, (0, 0, 0, cap - n))

        xyz, rot, scale, opacity, rgb = map(pad, fields)
        valid = torch.nn.functional.pad(valid_f, (0, cap - n))
        n_dropped = torch.zeros((), dtype=torch.int64, device=valid.device)
    else:
        if cap % 8 or n % 8:
            raise ValueError(f"compact_valid: cap={cap} and N={n} must be "
                             f"multiples of 8 (rows are kept in groups of 8)")
        (xyz, rot, scale, opacity, rgb, valid), n_dropped = \
            compact_super_rows(fields, valid_f, cap)
    return FlatGaussians(xyz=xyz[None], rgb=rgb[None], rot=rot[None],
                         scale=scale[None], opacity=opacity[None],
                         valid=valid[None]), n_dropped


class FreeviewRenderer:
    """Stereo forward once -> pixel-aligned Gaussians -> render any view.

    `state_dict` holds the model's weights under the reference's names
    (utils/weights.py converts flax parameters). `dataset` (a
    StereoHumanDataset, or anything with its `get_test_sample` and
    `__len__`) feeds the sweeps. Runs on `device`: CUDA unless the caller
    asks for the CPU. With a `group` of several ranks, every rank of the
    group builds a renderer and makes the same calls: the Gaussians are
    rank 0's, each rank renders a band of every view, and each gets the
    whole image (its counters summed over the group)."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 dataset=None, device="cuda",
                 group: sharding.Group = None):
        self.device = resolve_device(device)
        self.group = group if sharding.world_size(group) > 1 else None
        self.cfg = cfg
        self.dataset = dataset
        self.model = make_model(cfg, with_gs=True)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        rcfg = make_raster_config(cfg)
        # compaction moves to the once-per-frame forward (compact_valid);
        # per-view rendering then skips its own
        self._fg_cap = rcfg.fg_cap
        self.rcfg = dataclasses.replace(rcfg, fg_cap=None)
        self.bg = torch.tensor(cfg.dataset.bg_color, dtype=torch.float32,
                               device=self.device)
        # reading a counter is a device->host sync, so the first frame and
        # then every Nth (0 = never) is checked; between checks the counts
        # accumulate on the device as running sums (bounded state), and
        # flush_drop_report reads the totals with one sync
        self.check_drops_every = 16
        self._frames_rendered = 0
        self._frames_forwarded = 0
        self._fg_dropped = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
        self._pair_dropped = torch.zeros((), dtype=torch.int64,
                                         device=self.device)

    def _due(self, frames: int) -> bool:
        every = self.check_drops_every
        return bool(every) and frames % every == 0

    @torch.inference_mode()
    def gaussians(self, batch: StereoSample) -> FlatGaussians:
        """The frame's Gaussians of both views, compacted to fg_cap rows."""
        batch = batch.to(self.device)
        out = self.model(batch, iters=self.cfg.raft.val_iters,
                         test_mode=True)
        gauss = out.lmain_gs.flatten().concat(out.rmain_gs.flatten())
        if self._fg_cap is not None:
            gauss, n_dropped = compact_valid(gauss, self._fg_cap)
            sharding.broadcast_from_rank0([n_dropped], self.group)
            self._fg_dropped += n_dropped
            if self._due(self._frames_forwarded) and int(n_dropped):
                log.warning("foreground compaction dropped %d valid "
                            "gaussians this frame (raise raster.fg_cap)",
                            int(n_dropped))
        if self.group is not None:
            # every band must come from one Gaussian set: rank 0's
            gauss = dataclasses.replace(gauss, **{
                f.name: getattr(gauss, f.name).contiguous()
                for f in dataclasses.fields(gauss)})
            sharding.broadcast_from_rank0(
                [getattr(gauss, f.name) for f in dataclasses.fields(gauss)],
                self.group)
        self._frames_forwarded += 1
        return gauss

    @torch.inference_mode()
    def render(self, gauss: FlatGaussians, camera: NovelCamera):
        """Returns (images (1, H, W, 3), RasterizeAux with drop counters)."""
        if self.group is not None:
            img, aux = rasterize_tile_sharded(gauss, camera, self.bg,
                                              self.rcfg, self.group,
                                              device=self.device)
        else:
            img, aux = rasterize(gauss, camera, self.bg, self.rcfg,
                                 device=self.device)
        drops = (aux.num_dropped.sum() + aux.num_fg_dropped.sum()
                 + aux.num_pair_dropped.sum())
        self._pair_dropped += drops
        if self._due(self._frames_rendered) and int(drops):
            log.warning("rasterizer capacity caps dropped %d pairs this "
                        "frame (raise fg_cap/max_per_tile/pair_budget)",
                        int(drops))
        self._frames_rendered += 1
        return img, aux

    def flush_drop_report(self):
        """One host sync: the drops accumulated since the last flush.
        Returns (fg_drops, pair_drops) and logs if either is nonzero."""
        fg, pair = int(self._fg_dropped), int(self._pair_dropped)
        self._fg_dropped.zero_()
        self._pair_dropped.zero_()
        if fg or pair:
            log.warning("sweep total: %d valid gaussians dropped by fg_cap, "
                        "%d pairs dropped by capacity caps (raise raster."
                        "fg_cap/max_per_tile/pair_budget)", fg, pair)
        return fg, pair

    def novel_camera_at(self, sample: dict, ratio: float, height: int,
                        width: int) -> NovelCamera:
        """Camera interpolated between the ORIGINAL (unrectified) source
        poses `sample['intr_ori']`, `sample['extr_ori']` (numpy pairs)."""
        intr0, intr1 = sample["intr_ori"]
        extr0, extr1 = sample["extr_ori"]
        hr_scale = 2.0 if self.cfg.dataset.use_hr_img else 1.0
        cam, _, _ = cameras.interpolated_novel_camera(
            intr0, extr0, intr1, extr1, ratio, height, width,
            hr_scale=hr_scale, znear=self.cfg.dataset.znear,
            zfar=self.cfg.dataset.zfar)
        return cameras.make_novel_camera([cam], height, width,
                                         device=self.device)

    def _out_res(self) -> int:
        res = self.cfg.dataset.src_res
        return res * 2 if self.cfg.dataset.use_hr_img else res

    def infer_static(self, index: int, n_views: int = 9) -> list:
        """One frame seen from ratios (i + 0.5) / n_views between its two
        source cameras: the stereo forward runs once, each view renders
        only. Returns n_views (H, W, 3) numpy images in [0, 1]."""
        assert self.dataset is not None
        sample = self.dataset.get_test_sample(index)
        gauss = self.gaussians(collate([sample]))
        out_res = self._out_res()
        images = []
        for i in range(n_views):
            cam = self.novel_camera_at(sample, (i + 0.5) / n_views, out_res,
                                       out_res)
            img, _ = self.render(gauss, cam)
            images.append(img[0].clamp(0, 1).cpu().numpy())
        self.flush_drop_report()
        return images

    def infer_sequence(self, ratio: float = 0.5):
        """Every frame of the dataset from one fixed novel ratio: yields
        (scan name, (H, W, 3) numpy image in [0, 1])."""
        assert self.dataset is not None
        out_res = self._out_res()
        for idx in range(len(self.dataset)):
            sample = self.dataset.get_test_sample(idx)
            gauss = self.gaussians(collate([sample]))
            cam = self.novel_camera_at(sample, ratio, out_res, out_res)
            img, _ = self.render(gauss, cam)
            yield sample["name"], img[0].clamp(0, 1).cpu().numpy()
        self.flush_drop_report()


def load_renderer(cfg: Config, ckpt_dir: str, dataset=None,
                  device="cuda",
                  group: sharding.Group = None) -> FreeviewRenderer:
    """A renderer on the trained weights of `ckpt_dir` (a run directory of
    `ckpt_<step>.pt` files, the latest taken, or one file), rendering over
    `group` when it has several ranks. Raises when no tensor of the model
    is found there."""
    device = resolve_device(device)
    model = make_model(cfg, with_gs=True)
    n = state_lib.restore_params_partial(ckpt_dir, model)
    if n == 0:
        raise FileNotFoundError(f"no restorable params in {ckpt_dir}")
    return FreeviewRenderer(cfg, model.state_dict(), dataset, device=device,
                            group=group)
