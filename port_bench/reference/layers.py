# Frozen copy of gps_gaussian_tpu_torch/models/layers.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Shared conv building blocks (NCHW inside the models).

Counterpart of gps_gaussian_tpu/models/layers.py, named as the reference's
torch modules are named (core/extractor.py), so that reference state_dicts
and converted flax parameters load with `load_state_dict`.

Mixed precision follows the JAX casts, not torch.autocast: parameters stay
f32; a `Conv` with `compute_dtype` casts its input, weight and bias to that
dtype and returns it (flax `nn.Conv(dtype=...)`); `GroupNorm32` always
normalises in f32 and casts back to its input's dtype.

`set_variant` turns a model into a sound variant of itself: the same
mathematics at the same precision with its f32 sums in another order, as a
faithful rewrite of a norm or a convolution would sum them (VARIANTS).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` (None = input dtype)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype

    # the control's lower precision (quant.py): applied to the input and
    # the weight in the compute dtype; None computes as configured
    quant = None
    # the sound variant "conv_layout": input and weight channels-last, so
    # that cuDNN runs its NHWC engines, which sum in their own order
    channels_last = False

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        if self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
            w = w.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, self.bias.to(dt), self.stride, self.padding)


class FlipNorm:
    """A norm with statistics whose sound variant "norm_order" normalises
    its input flipped along the width and flips the output back: the same
    per-element formula, the statistics summed in another order."""

    flip = False

    def forward(self, x):
        if self.flip:
            return self.plain(x.flip(-1)).flip(-1)
        return self.plain(x)


class GroupNorm32(FlipNorm, nn.GroupNorm):
    """GroupNorm computed in f32, output cast back to the input dtype."""

    def plain(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


VARIANTS = ("norm_order", "conv_layout")


def set_variant(model: nn.Module, kind: Optional[str]) -> None:
    """Make `model` the sound variant `kind` (VARIANTS): "norm_order" runs
    every norm with statistics (FlipNorm) on its input flipped along the
    width, "conv_layout" every convolution on channels-last tensors. None
    restores the plain reference."""
    if kind is not None and kind not in VARIANTS:
        raise ValueError(f"unknown variant {kind!r} (expected one of "
                         f"{VARIANTS})")
    for m in model.modules():
        if isinstance(m, Conv):
            m.channels_last = kind == "conv_layout"
        elif isinstance(m, FlipNorm):
            m.flip = kind == "norm_order"


class ResidualBlock(nn.Module):
    """conv3x3(stride)+GN+relu -> conv3x3+GN+relu, 1x1 skip when needed
    (reference core/extractor.py:6-60, norm_fn='group')."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        g = planes // 8
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, compute_dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, compute_dtype)
        self.norm1 = GroupNorm32(g, planes)
        self.norm2 = GroupNorm32(g, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = GroupNorm32(g, planes)
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, 0, compute_dtype),
                self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """torch-default init drawn from `generator`: conv weight and bias
    U(+-1/sqrt(fan_in)) (kaiming_uniform with a=sqrt(5)); GroupNorm weight 1,
    bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
