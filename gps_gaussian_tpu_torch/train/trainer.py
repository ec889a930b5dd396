"""Model and rasterizer construction from a Config, and the novel-view render.

The pieces of gps_gaussian_tpu/train/trainer.py that serving needs:
`make_model` :34, `make_raster_config` :48 and `render_novel` :57. The
training step itself is not ported yet.
"""

from __future__ import annotations

import torch

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize)
from gps_gaussian_tpu_torch.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.utils.containers import NovelView


def make_model(cfg: Config, with_gs: bool) -> GPSGaussianModel:
    """The model of `cfg`; under raft.mixed_precision its convolutions
    compute in bf16 while parameters, norms, gates and heads stay f32."""
    return GPSGaussianModel(
        encoder_dims=tuple(cfg.raft.encoder_dims),
        hidden_dim=cfg.raft.hidden_dims[2],
        context_dim=cfg.raft.hidden_dims[2],
        corr_levels=cfg.raft.corr_levels,
        corr_radius=cfg.raft.corr_radius,
        gsnet_encoder_dims=tuple(cfg.gsnet.encoder_dims),
        gsnet_decoder_dims=tuple(cfg.gsnet.decoder_dims),
        gsnet_head_dim=cfg.gsnet.parm_head_dim,
        with_gs=with_gs,
        compute_dtype=torch.bfloat16 if cfg.raft.mixed_precision else None)


def make_raster_config(cfg: Config) -> RasterizeConfig:
    return RasterizeConfig(
        max_tiles_per_gaussian=cfg.raster.max_tiles_per_gaussian,
        max_per_tile=cfg.raster.max_per_tile,
        fg_cap=cfg.raster.fg_cap,
        pair_budget=cfg.raster.pair_budget)


def render_novel(out, novel: NovelView, bg_color, rcfg: RasterizeConfig,
                 device="cuda"):
    """Splat both views' pixel-aligned Gaussians into the novel camera.
    Returns (images, RasterizeAux)."""
    gauss = out.lmain_gs.flatten().concat(out.rmain_gs.flatten())
    return rasterize(gauss, novel.camera, bg_color, rcfg, device=device)
