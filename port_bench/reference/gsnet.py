# Frozen copy of gps_gaussian_tpu_torch/models/gsnet.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Gaussian-parameter regressor: depth U-Net + skip-fused decoder + heads.

Counterpart of gps_gaussian_tpu/models/gsnet.py `GSRegresser`, NCHW, with
the reference's module names (lib/gs_parm_network.py). The port keeps the
reference's three heads (rot_head, scale_head, opacity_head); the JAX
package fuses their first convs into one `head_conv1`, which the weight
converter splits (utils/weights.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.encoders import UnetExtractor
from port_bench.reference.layers import Conv, ResidualBlock


def _up2(x):
    """2x bilinear upsampling, align_corners=False (half-pixel centres)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def _head(dim: int, out: int, cd) -> nn.Sequential:
    return nn.Sequential(Conv(dim, dim, 3, 1, 1, cd), nn.ReLU(),
                         Conv(dim, out, 1, 1, 0, cd))


class GSRegresser(nn.Module):
    def __init__(self, rgb_dims: Sequence[int] = (32, 48, 96),
                 depth_dims: Sequence[int] = (32, 48, 96),
                 decoder_dims: Sequence[int] = (48, 64, 96),
                 head_dim: int = 32,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        dd = decoder_dims
        self.depth_encoder = UnetExtractor(1, depth_dims, cd)
        self.decoder3 = nn.Sequential(
            ResidualBlock(rgb_dims[2] + depth_dims[2], dd[2], 1, cd),
            ResidualBlock(dd[2], dd[2], 1, cd))
        self.decoder2 = nn.Sequential(
            ResidualBlock(dd[2] + rgb_dims[1] + depth_dims[1], dd[1], 1, cd),
            ResidualBlock(dd[1], dd[1], 1, cd))
        self.decoder1 = nn.Sequential(
            ResidualBlock(dd[1] + rgb_dims[0] + depth_dims[0], dd[0], 1, cd),
            ResidualBlock(dd[0], dd[0], 1, cd))
        self.out_conv = Conv(dd[0] + 4, head_dim, 3, 1, 1, cd)
        self.rot_head = _head(head_dim, 4, cd)
        self.scale_head = _head(head_dim, 3, cd)
        self.opacity_head = _head(head_dim, 1, cd)

    def forward(self, img, depth, img_feat):
        """img (2B, 3, H, W) in [-1, 1]; depth (2B, 1, H, W) inverse depth;
        img_feat: the image encoder's (1/2, 1/4, 1/8) features.
        Returns rot (2B, 4, H, W), scale (2B, 3, H, W), opacity
        (2B, 1, H, W), all f32."""
        img_feat1, img_feat2, img_feat3 = img_feat
        d1, d2, d3 = self.depth_encoder(depth)

        up3 = _up2(self.decoder3(torch.cat([img_feat3, d3], dim=1)))
        up2 = _up2(self.decoder2(torch.cat([up3, img_feat2, d2], dim=1)))
        up1 = _up2(self.decoder1(torch.cat([up2, img_feat1, d1], dim=1)))

        out = torch.cat([up1, img.to(up1.dtype), depth.to(up1.dtype)], dim=1)
        out = F.relu(self.out_conv(out))

        rot = self.rot_head(out).float()
        rot = rot / torch.linalg.vector_norm(
            rot, dim=1, keepdim=True).clamp_min(1e-12)
        # Softplus(beta=100), clamped at 0.01
        scale = torch.clamp_max(
            F.softplus(self.scale_head(out).float(), beta=100.0), 0.01)
        opacity = torch.sigmoid(self.opacity_head(out).float())
        return rot, scale, opacity
