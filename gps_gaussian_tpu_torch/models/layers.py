"""Shared conv building blocks (NCHW inside the models).

Counterpart of gps_gaussian_tpu/models/layers.py, named as the reference's
torch modules are named (core/extractor.py), so that reference state_dicts
and converted flax parameters load with `load_state_dict`.

Mixed precision follows the JAX casts, not torch.autocast: parameters stay
f32; a `Conv` with `compute_dtype` casts its input, weight and bias to that
dtype and returns it (flax `nn.Conv(dtype=...)`); every norm (`GroupNorm32`,
and RAFT-Stereo's `InstanceNorm32` and `FrozenBatchNorm32`) normalises in
f32 and casts back to its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gps_gaussian_tpu_torch.utils.profiling import device_span


class Conv(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` (None = input dtype)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in f32, output cast back to the input dtype
    (span `net.groupnorm`, the casts included)."""

    def forward(self, x):
        with device_span("net.groupnorm", x.device):
            y = F.group_norm(x.float(), self.num_groups, self.weight,
                             self.bias, self.eps)
            return y.to(x.dtype)


class InstanceNorm32(nn.InstanceNorm2d):
    """InstanceNorm without affine parameters (RAFT-Stereo's feature net),
    computed in f32 and cast back (span `net.instancenorm`, the casts
    included)."""

    def forward(self, x):
        with device_span("net.instancenorm", x.device):
            return F.instance_norm(x.float(), eps=self.eps).to(x.dtype)


class FrozenBatchNorm32(nn.BatchNorm2d):
    """BatchNorm that always normalises by its running statistics, which
    never change, in training mode too (RAFT-Stereo's `freeze_bn`); its
    weight and bias train. Computed in f32 and cast back."""

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


def make_norm(kind: str, planes: int) -> nn.Module:
    """The norm `kind` of a `planes`-channel map: "group" (planes / 8
    groups), "instance" or "batch" (frozen)."""
    if kind == "group":
        return GroupNorm32(planes // 8, planes)
    if kind == "instance":
        return InstanceNorm32(planes)
    if kind == "batch":
        return FrozenBatchNorm32(planes)
    raise ValueError(f"unknown norm {kind!r} (expected 'group', "
                     "'instance' or 'batch')")


class ResidualBlock(nn.Module):
    """conv3x3(stride)+norm+relu -> conv3x3+norm+relu, 1x1 skip when
    needed (reference core/extractor.py:6-60; `norm` as `make_norm`)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 norm: str = "group"):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, compute_dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, compute_dtype)
        self.norm1 = make_norm(norm, planes)
        self.norm2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = make_norm(norm, planes)
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
