"""RAFT-Stereo as a stage-1 model: disparity from a rectified pair, both
directions in one batch, with no Gaussian head.

The architecture is RAFT-Stereo at its published widths (Lipson, Teed and
Deng, 3DV 2021, github.com/princeton-vl/RAFT-Stereo): its own feature and
context encoders on the images, a correlation pyramid at 1/4 resolution,
three coupled ConvGRU levels. GPS-Gaussian's stage 1 trains a smaller
variant of it, on U-Net features at 1/8 (`GPSGaussianModel`). Inputs are
NHWC in [-1, 1]; the output is the `GPSGaussianOutput` that the stage-1
step and loss consume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from gps_gaussian_tpu_torch.models.gps_gaussian import GPSGaussianOutput
from gps_gaussian_tpu_torch.models.raft import MultiLevelRaftStereo
from gps_gaussian_tpu_torch.utils.containers import StereoSample


class RaftStereoModel(nn.Module):
    def __init__(self, encoder_dims: Sequence[int] = (64, 96, 128),
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 fnet_dim: int = 256, corr_levels: int = 4,
                 corr_radius: int = 4,
                 n_downsample: int = 2, remat_encoders: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.raft_stereo = MultiLevelRaftStereo(
            encoder_dims, hidden_dims, fnet_dim, corr_levels, corr_radius,
            n_downsample, remat_encoders, compute_dtype)

    def forward(self, sample: StereoSample, iters: int = 22,
                test_mode: bool = False) -> GPSGaussianOutput:
        image = torch.cat([sample.lmain.img, sample.rmain.img],
                          dim=0).permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)
        preds = self.raft_stereo(image, iters=iters, test_mode=test_mode)
        return GPSGaussianOutput(flow_preds=tuple(preds))
