"""Image encoders (NCHW).

GPS-Gaussian's: counterparts of gps_gaussian_tpu/models/encoders.py
`UnetExtractor` :20 and `MultiBasicEncoder` :43, with the reference's
module names. RAFT-Stereo's own (Lipson et al. 2021, core/extractor.py
`BasicEncoder`, `MultiBasicEncoder`), which the JAX package does not have:
`BasicEncoder`, the matching features, and `MultiLevelEncoder`, the context
of every GRU level, both from the raw images and with upstream's module
names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from gps_gaussian_tpu_torch.models.layers import (Conv, GroupNorm32,
                                                  ResidualBlock, make_norm)


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


class _RaftStereoTrunk(nn.Module):
    """conv7x7 -> norm -> relu, then layer1..layer3 of two residual blocks
    each (widths d0, d1, d2), at 1 / 2^n_downsample of the image."""

    def __init__(self, dims: Sequence[int], norm: str, n_downsample: int,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__()
        d0, d1, d2 = dims
        cd = compute_dtype
        self.conv1 = Conv(3, d0, 7, 1 + (n_downsample > 2), 3, cd)
        self.norm1 = make_norm(norm, d0)
        self.layer1 = self._layer(d0, d0, 1, norm, cd)
        self.layer2 = self._layer(d0, d1, 1 + (n_downsample > 1), norm, cd)
        self.layer3 = self._layer(d1, d2, 1 + (n_downsample > 0), norm, cd)

    @staticmethod
    def _layer(cin, cout, stride, norm, cd):
        return nn.Sequential(ResidualBlock(cin, cout, stride, cd, norm),
                             ResidualBlock(cout, cout, 1, cd, norm))

    def trunk(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_RaftStereoTrunk):
    """RAFT-Stereo's feature net: the trunk with InstanceNorm, then a 1x1
    convolution to `out_dim` channels (256 published)."""

    def __init__(self, dims: Sequence[int] = (64, 96, 128),
                 out_dim: int = 256, n_downsample: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(dims, "instance", n_downsample, compute_dtype)
        self.conv2 = Conv(dims[2], out_dim, 1, 1, 0, compute_dtype)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiLevelEncoder(_RaftStereoTrunk):
    """RAFT-Stereo's context net, with frozen BatchNorm: the trunk, then
    layer4 and layer5 (stride 2 each), and two heads at each of the three
    levels, the hidden state's and the context's: at the two finer levels a
    residual block and a 3x3 convolution, at the coarsest a 3x3
    convolution alone. Returns
    [(hidden, context)] finest first, level l with `level_dims[l]`
    channels."""

    def __init__(self, dims: Sequence[int] = (64, 96, 128),
                 level_dims: Sequence[int] = (128, 128, 128),
                 n_downsample: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        norm = "batch"
        super().__init__(dims, norm, n_downsample, compute_dtype)
        d2, cd = dims[2], compute_dtype
        self.layer4 = self._layer(d2, d2, 2, norm, cd)
        self.layer5 = self._layer(d2, d2, 2, norm, cd)

        def heads(dim, coarsest=False):
            def head():
                conv = Conv(d2, dim, 3, 1, 1, cd)
                if coarsest:
                    return conv
                return nn.Sequential(ResidualBlock(d2, d2, 1, cd, norm), conv)
            return nn.ModuleList([head(), head()])

        self.outputs08 = heads(level_dims[0])
        self.outputs16 = heads(level_dims[1])
        self.outputs32 = heads(level_dims[2], coarsest=True)

    def forward(self, x):
        x = self.trunk(x)
        y = self.layer4(x)
        z = self.layer5(y)
        return [(heads[0](v), heads[1](v)) for v, heads in
                ((x, self.outputs08), (y, self.outputs16),
                 (z, self.outputs32))]
