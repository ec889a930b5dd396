# Frozen copy of gps_gaussian_tpu_torch/models/encoders.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Image U-Net encoder and context encoder (NCHW).

Counterpart of gps_gaussian_tpu/models/encoders.py `UnetExtractor` :20 and
`MultiBasicEncoder` :43, with the reference's module names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from port_bench.reference.layers import (Conv, GroupNorm32,
                                                  ResidualBlock)


class UnetExtractor(nn.Module):
    """5x5 s2 stem + three residual stages -> features at 1/2, 1/4, 1/8."""

    def __init__(self, in_channel: int = 3,
                 encoder_dims: Sequence[int] = (32, 48, 96),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d0, d1, d2 = encoder_dims
        cd = compute_dtype
        self.in_ds = nn.Sequential(Conv(in_channel, 32, 5, 2, 2, cd),
                                   GroupNorm32(8, 32), nn.ReLU())
        self.res1 = nn.Sequential(ResidualBlock(32, d0, 1, cd),
                                  ResidualBlock(d0, d0, 1, cd))
        self.res2 = nn.Sequential(ResidualBlock(d0, d1, 2, cd),
                                  ResidualBlock(d1, d1, 1, cd))
        self.res3 = nn.Sequential(ResidualBlock(d1, d2, 2, cd),
                                  ResidualBlock(d2, d2, 1, cd))

    def forward(self, x):
        x = self.in_ds(x)
        x1 = self.res1(x)
        x2 = self.res2(x1)
        x3 = self.res3(x2)
        return x1, x2, x3


class MultiBasicEncoder(nn.Module):
    """Context + matching-feature heads on the 1/8 features of the stacked
    [left; right] batch. Returns ((hidden, context), fmap_left,
    fmap_right)."""

    def __init__(self, encoder_dims: Sequence[int] = (32, 48, 96),
                 hidden_dim: int = 96, context_dim: int = 96,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d2 = encoder_dims[2]
        cd = compute_dtype
        self.conv2 = nn.Sequential(ResidualBlock(d2, d2, 1, cd),
                                   Conv(d2, d2 * 2, 3, 1, 1, cd))
        self.outputs08 = nn.ModuleList([
            nn.Sequential(ResidualBlock(d2, d2, 1, cd),
                          Conv(d2, hidden_dim, 3, 1, 1, cd)),
            nn.Sequential(ResidualBlock(d2, d2, 1, cd),
                          Conv(d2, context_dim, 3, 1, 1, cd))])

    def forward(self, x):
        bs2 = x.shape[0]
        f = self.conv2(x)
        fmap1, fmap2 = f[:bs2 // 2], f[bs2 // 2:]
        h = self.outputs08[0](x)
        c = self.outputs08[1](x)
        return (h, c), fmap1, fmap2
