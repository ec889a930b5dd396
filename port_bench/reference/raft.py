# Frozen copy of gps_gaussian_tpu_torch/models/raft.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""RAFT-Stereo disparity head, bidirectional in batch, iterative GRU refine.

Counterpart of gps_gaussian_tpu/models/raft.py `RaftStereoHuman`, with the
reference's module names: queries fmap12 = [f_l; f_r] match targets
fmap21 = [f_r; f_l], so L->R and R->L disparities come out of one batched
pass; delta_flow.y is zeroed (rectified pairs move along x only); in test
mode only the final iteration is upsampled. Convolutions run NCHW; the
correlation and upsampling ops take NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from port_bench.reference.encoders import MultiBasicEncoder
from port_bench.reference.layers import Conv
from port_bench.reference.update import BasicUpdateBlock
from port_bench.reference.corr import (build_corr_pyramid,
                                             lookup_corr_pyramid)
from port_bench.reference.sampling import coords_grid, convex_upsample


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class RaftStereoHuman(nn.Module):
    def __init__(self, encoder_dims: Sequence[int] = (32, 48, 96),
                 hidden_dim: int = 96, context_dim: int = 96,
                 corr_levels: int = 4, corr_radius: int = 4,
                 downsample_factor: int = 8,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.downsample_factor = downsample_factor
        self.compute_dtype = compute_dtype
        # the control's lower precision for the correlation matmul
        self.corr_quant = None
        cd = compute_dtype
        self.cnet = MultiBasicEncoder(encoder_dims, hidden_dim, context_dim,
                                      cd)
        self.context_zqr_convs = nn.ModuleList([
            Conv(context_dim, hidden_dim * 3, 3, 1, 1, cd)])
        self.update_module = nn.ModuleDict({"update_block": BasicUpdateBlock(
            hidden_dim, corr_levels * (2 * corr_radius + 1),
            downsample_factor, cd)})

    def forward(self, fmap8, iters: int = 3, test_mode: bool = False):
        """fmap8: (2B, d2, h, w) 1/8-res features of the stacked batch.

        Returns a list of full-res x-disparity maps (2B, H, W, 1), f32: one
        per iteration, or only the final one in test mode."""
        cd = self.compute_dtype
        (hid, ctx), fmap1, fmap2 = self.cnet(fmap8)
        fmap12 = torch.cat([fmap1, fmap2], dim=0)
        fmap21 = torch.cat([fmap2, fmap1], dim=0)

        net = torch.tanh(hid.float()).to(cd or hid.dtype)
        inp = torch.relu(ctx)
        cz, cr, cq = torch.chunk(self.context_zqr_convs[0](inp), 3, dim=1)

        f12, f21 = _nhwc(fmap12), _nhwc(fmap21)
        if self.corr_quant is not None:
            f12, f21 = self.corr_quant(f12.float()), self.corr_quant(
                f21.float())
        pyramid = build_corr_pyramid(f12, f21, num_levels=self.corr_levels)
        b2, _, h, w = fmap8.shape
        coords0 = coords_grid(b2, h, w, device=fmap8.device)
        coords1 = coords0
        update = self.update_module["update_block"]

        predictions = []
        for it in range(iters):
            # each iteration refines a fixed starting point: no gradient
            # flows from one iteration's coordinates into the previous one
            coords1 = coords1.detach()
            corr = lookup_corr_pyramid(pyramid, coords1[..., 0],
                                       radius=self.corr_radius)
            flow = coords1 - coords0
            net, mask, delta_flow = update(
                net, (cz, cr, cq), _nchw(flow).to(cd or corr.dtype),
                _nchw(corr).to(cd or corr.dtype))
            delta_flow = _nhwc(delta_flow)
            delta_flow = torch.stack(
                [delta_flow[..., 0], torch.zeros_like(delta_flow[..., 1])],
                dim=-1)
            coords1 = coords1 + delta_flow
            if test_mode and it < iters - 1:
                continue
            flow_up = convex_upsample(coords1 - coords0, _nhwc(mask),
                                      self.downsample_factor)
            predictions.append(flow_up[..., :1])
        return predictions
