"""Full GPS-Gaussian model: stereo encoder + RAFT disparity + GS regressor.

Counterpart of gps_gaussian_tpu/models/gps_gaussian.py `GPSGaussianModel`,
with the reference's top-level module names (img_encoder, raft_stereo,
gs_parm_regresser). The stereo pair is stacked on the batch axis (left
batch[:B], right batch[B:]); disparity becomes inverse depth and world
points; background pixels stay as masked Gaussians (valid = 0). Inputs and
outputs are NHWC; the convolutions run NCHW inside. Spans (utils/profiling.py):
`net.encoder`, `net.stereo`, `net.gs` around the three networks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gps_gaussian_tpu_torch.geometry.pointcloud import (flow_to_inv_depth,
                                                        inv_depth_to_points)
from gps_gaussian_tpu_torch.models.encoders import UnetExtractor
from gps_gaussian_tpu_torch.models.gsnet import GSRegresser
from gps_gaussian_tpu_torch.models.raft import RaftStereoHuman
from gps_gaussian_tpu_torch.utils.containers import (GaussianMaps, SourceView,
                                                     StereoSample)
from gps_gaussian_tpu_torch.utils.profiling import device_span


@dataclasses.dataclass
class GPSGaussianOutput:
    """flow_preds: per-iteration full-res x-disparity, each (2B, H, W, 1),
    left in batch[:B], right in batch[B:]."""

    flow_preds: Tuple[torch.Tensor, ...]
    lmain_gs: Optional[GaussianMaps] = None
    rmain_gs: Optional[GaussianMaps] = None

    @property
    def final_flow(self) -> torch.Tensor:
        return self.flow_preds[-1]


class GPSGaussianModel(nn.Module):
    def __init__(self, encoder_dims: Sequence[int] = (32, 48, 96),
                 hidden_dim: int = 96, context_dim: int = 96,
                 corr_levels: int = 4, corr_radius: int = 4,
                 gsnet_encoder_dims: Sequence[int] = (32, 48, 96),
                 gsnet_decoder_dims: Sequence[int] = (48, 64, 96),
                 gsnet_head_dim: int = 32, with_gs: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.with_gs = with_gs
        self.compute_dtype = compute_dtype
        cd = compute_dtype
        self.img_encoder = UnetExtractor(3, encoder_dims, cd)
        self.raft_stereo = RaftStereoHuman(encoder_dims, hidden_dim,
                                           context_dim, corr_levels,
                                           corr_radius, 8, cd)
        if with_gs:
            self.gs_parm_regresser = GSRegresser(
                encoder_dims, gsnet_encoder_dims, gsnet_decoder_dims,
                gsnet_head_dim, cd)

    def forward(self, sample: StereoSample, iters: int = 3,
                test_mode: bool = False) -> GPSGaussianOutput:
        bs = sample.lmain.img.shape[0]
        image = torch.cat([sample.lmain.img, sample.rmain.img],
                          dim=0).permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)

        with device_span("net.encoder", image.device):
            img_feat = self.img_encoder(image)
        with device_span("net.stereo", image.device):
            preds = self.raft_stereo(img_feat[2], iters=iters,
                                     test_mode=test_mode)
        if not self.with_gs:
            return GPSGaussianOutput(flow_preds=tuple(preds))

        flow_final = preds[-1]
        views = (sample.lmain, sample.rmain)
        depths, xyzs, valids = [], [], []
        for i, view in enumerate(views):
            flow_v = flow_final[i * bs:(i + 1) * bs]
            inv_depth = flow_to_inv_depth(flow_v, view.intr, view.ref_intr,
                                          view.tf_x, view.mask)
            xyzs.append(inv_depth_to_points(inv_depth[..., 0], view.extr,
                                            view.intr))
            depths.append(inv_depth)
            valids.append((inv_depth != 0.0).float())

        lr_depth = torch.cat(depths, dim=0).permute(0, 3, 1, 2)
        with device_span("net.gs", image.device):
            rot, scale, opacity = self.gs_parm_regresser(
                image, lr_depth.to(image.dtype), img_feat)
        rot, scale, opacity = (x.permute(0, 2, 3, 1)
                               for x in (rot, scale, opacity))

        def gs_maps(i: int, view: SourceView) -> GaussianMaps:
            sl = slice(i * bs, (i + 1) * bs)
            return GaussianMaps(
                xyz=xyzs[i], rgb=view.img.float() * 0.5 + 0.5,
                rot=rot[sl], scale=scale[sl], opacity=opacity[sl],
                valid=valids[i], depth=depths[i])

        return GPSGaussianOutput(flow_preds=tuple(preds),
                                 lmain_gs=gs_maps(0, sample.lmain),
                                 rmain_gs=gs_maps(1, sample.rmain))
