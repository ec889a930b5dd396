"""Free-view novel-view serving: the stereo network runs once per frame,
then any number of novel views are splatted from its Gaussians.

Counterpart of gps_gaussian_tpu/infer/freeview.py `compact_valid` :30 and
`FreeviewRenderer` (`gaussians`, `render`, `flush_drop_report`,
`novel_camera_at`). The dataset-driven sweeps (`infer_static`,
`infer_sequence`, `load_renderer`) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

import torch

from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.kernels.rasterizer import (
    compact_gaussian_inputs, rasterize)
from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.train.trainer import make_model, make_raster_config
from gps_gaussian_tpu_torch.utils.containers import (FlatGaussians,
                                                     NovelCamera,
                                                     StereoSample)
from gps_gaussian_tpu_torch.utils.device import resolve_device

log = logging.getLogger("gps_tpu_torch.infer")


def compact_valid(gauss: FlatGaussians, cap: int):
    """Pack batch-1 valid Gaussians into the first `cap` rows.

    Row-exact, through live_first_order: the first `cap` valid rows are kept
    in order, and the valid rows past the cap are counted. The JAX version
    moves 8-row super-rows (a TPU DMA layout). When the cap does not bind,
    both render the same image: dead rows project to radius 0 and make no
    pairs, and the live rows keep their order. When it binds, JAX keeps
    only the valid rows of the first cap/8 live super-rows, so the kept
    rows and the drop count differ from this version.
    Returns (FlatGaussians with `cap` rows, num_dropped)."""
    (xyz, rot, scale, opacity, rgb, valid), n_dropped = \
        compact_gaussian_inputs(gauss, 0, cap)
    return FlatGaussians(xyz=xyz[None], rgb=rgb[None], rot=rot[None],
                         scale=scale[None], opacity=opacity[None],
                         valid=valid[None]), n_dropped


class FreeviewRenderer:
    """Stereo forward once -> pixel-aligned Gaussians -> render any view.

    `state_dict` holds the model's weights under the reference's names
    (utils/weights.py converts flax parameters). Runs on `device`: CUDA
    unless the caller asks for the CPU."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
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
            self._fg_dropped += n_dropped
            if self._due(self._frames_forwarded) and int(n_dropped):
                log.warning("foreground compaction dropped %d valid "
                            "gaussians this frame (raise raster.fg_cap)",
                            int(n_dropped))
        self._frames_forwarded += 1
        return gauss

    @torch.inference_mode()
    def render(self, gauss: FlatGaussians, camera: NovelCamera):
        """Returns (images (1, H, W, 3), RasterizeAux with drop counters)."""
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
