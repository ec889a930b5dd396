"""GRU update block: motion encoder, ConvGRU, flow + upsample-mask heads.

Counterpart of gps_gaussian_tpu/models/update.py (`FlowHead`, `ConvGRU`,
`BasicMotionEncoder`, `BasicUpdateBlock`) for one GRU level, NCHW, with the
reference's module names. Gate math is f32, as in the JAX code.
`BasicMultiUpdateBlock` is RAFT-Stereo's update of three coupled GRU
levels (core/update.py), which the JAX package does not have.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gps_gaussian_tpu_torch.models.layers import Conv


class FlowHead(nn.Module):
    """conv3x3 -> relu -> conv3x3."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 out_dim: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3, 1, 1, compute_dtype)
        self.conv2 = Conv(hidden_dim, out_dim, 3, 1, 1, compute_dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """h' = (1-z) h + z tanh(Wq [r*h, x] + cq); z/r = sigmoid(W [h, x] + c).
    The context biases are added in the compute dtype, then the gates run
    in f32 and h' is cast back to h's dtype."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.convz = Conv(hidden_dim + input_dim, hidden_dim, 3, 1, 1, cd)
        self.convr = Conv(hidden_dim + input_dim, hidden_dim, 3, 1, 1, cd)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 3, 1, 1, cd)

    def forward(self, h, cz, cr, cq, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid((self.convz(hx) + cz).float())
        r = torch.sigmoid((self.convr(hx) + cr).float())
        rh_x = torch.cat([r.to(h.dtype) * h, x], dim=1)
        q = torch.tanh((self.convq(rh_x) + cq).float())
        return ((1.0 - z) * h.float() + z * q).to(h.dtype)


class BasicMotionEncoder(nn.Module):
    """Correlation taps + current flow -> 128 channels: fused(126), flow(2)."""

    def __init__(self, corr_channels: int = 36,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.convc1 = Conv(corr_channels, 64, 1, 1, 0, cd)
        self.convc2 = Conv(64, 64, 3, 1, 1, cd)
        self.convf1 = Conv(2, 64, 7, 1, 3, cd)
        self.convf2 = Conv(64, 64, 3, 1, 1, cd)
        self.conv = Conv(128, 126, 3, 1, 1, cd)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class BasicUpdateBlock(nn.Module):
    """One GRU level at 1/8 res + flow and upsample-mask heads. Returns
    (net, 0.25 * mask logits in f32, delta_flow in f32)."""

    def __init__(self, hidden_dim: int = 96, corr_channels: int = 36,
                 downsample_factor: int = 8,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.encoder = BasicMotionEncoder(corr_channels, cd)
        self.gru08 = ConvGRU(hidden_dim, 128, cd)
        self.flow_head = FlowHead(hidden_dim, 256, 2, cd)
        self.mask = nn.Sequential(
            Conv(hidden_dim, 256, 3, 1, 1, cd), nn.ReLU(),
            Conv(256, downsample_factor ** 2 * 9, 1, 1, 0, cd))

    def forward(self, net, context_zqr, flow, corr):
        cz, cr, cq = context_zqr
        motion = self.encoder(flow, corr)
        net = self.gru08(net, cz, cr, cq, motion)
        delta_flow = self.flow_head(net)
        mask = self.mask(net)
        return net, 0.25 * mask.float(), delta_flow.float()


def pool2x(x):
    """3x3 average pool, stride 2, zero padding counted (upstream
    `pool2x`): a finer level's state at the next coarser level's size."""
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    """`x` resized bilinearly to `dest`'s height and width, corners
    aligned (upstream `interp`)."""
    return F.interpolate(x, dest.shape[2:], mode="bilinear",
                         align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    """RAFT-Stereo's update: three GRU levels at 1/2^n, 1/2^(n+1),
    1/2^(n+2) (`gru08`, `gru16`, `gru32`, named as upstream whatever the
    factor), updated coarsest first, each fed the pooled finer state and
    the interpolated coarser one; the finest also the motion features.
    Then the flow and upsample-mask heads on the finest state.

    `dims[l]` is level l's hidden width, finest first. Returns (the new
    states, 0.25 * mask logits in f32, delta_flow in f32)."""

    def __init__(self, dims=(128, 128, 128), corr_channels: int = 36,
                 downsample_factor: int = 4,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        d0, d1, d2 = dims
        self.encoder = BasicMotionEncoder(corr_channels, cd)
        self.gru08 = ConvGRU(d0, 128 + d1, cd)
        self.gru16 = ConvGRU(d1, d0 + d2, cd)
        self.gru32 = ConvGRU(d2, d1, cd)
        self.flow_head = FlowHead(d0, 256, 2, cd)
        self.mask = nn.Sequential(
            Conv(d0, 256, 3, 1, 1, cd), nn.ReLU(),
            Conv(256, downsample_factor ** 2 * 9, 1, 1, 0, cd))

    def forward(self, net, context_zqr, flow, corr):
        """net: the three levels' states, finest first; context_zqr: each
        level's (cz, cr, cq)."""
        net0, net1, net2 = net
        net2 = self.gru32(net2, *context_zqr[2], pool2x(net1))
        net1 = self.gru16(net1, *context_zqr[1], torch.cat(
            [pool2x(net0), interp(net2, net1)], dim=1))
        net0 = self.gru08(net0, *context_zqr[0], torch.cat(
            [self.encoder(flow, corr), interp(net1, net0)], dim=1))
        delta_flow = self.flow_head(net0)
        mask = self.mask(net0)
        return [net0, net1, net2], 0.25 * mask.float(), delta_flow.float()
