"""RAFT-Stereo disparity head, bidirectional in batch, iterative GRU refine.

Counterpart of gps_gaussian_tpu/models/raft.py `RaftStereoHuman`, with the
reference's module names: queries fmap12 = [f_l; f_r] match targets
fmap21 = [f_r; f_l], so L->R and R->L disparities come out of one batched
pass; delta_flow.y is zeroed (rectified pairs move along x only); in test
mode only the final iteration is upsampled. Convolutions run NCHW; the
correlation and upsampling ops take NHWC, as in the JAX package.

`MultiLevelRaftStereo` is RAFT-Stereo itself (Lipson et al. 2021,
core/raft_stereo.py), which the JAX package does not have: its own
encoders on the images, three GRU levels from 1 / 2^n_downsample down,
the same bidirectional batch. Spans (utils/profiling.py): `net.encoder` (both
encoders and the context convolutions), `net.stereo` around the rest,
`net.corr` (the pyramid) and `net.update` (each iteration: lookup, GRU
levels, heads and upsampling); counters `stereo.iters` and
`stereo.corr_bytes` (the pyramid's bytes).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from gps_gaussian_tpu_torch.models.encoders import (BasicEncoder,
                                                    MultiBasicEncoder,
                                                    MultiLevelEncoder)
from gps_gaussian_tpu_torch.models.layers import Conv
from gps_gaussian_tpu_torch.models.update import (BasicMultiUpdateBlock,
                                                  BasicUpdateBlock)
from gps_gaussian_tpu_torch.ops.corr import (build_corr_pyramid,
                                             lookup_corr_pyramid)
from gps_gaussian_tpu_torch.ops.sampling import coords_grid, convex_upsample
from gps_gaussian_tpu_torch.utils.profiling import count, device_span


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

        pyramid = build_corr_pyramid(_nhwc(fmap12), _nhwc(fmap21),
                                     num_levels=self.corr_levels)
        b2, _, h, w = fmap8.shape
        coords0 = coords_grid(b2, h, w, device=fmap8.device)
        return refine(pyramid, coords0, net, (cz, cr, cq),
                      self.update_module["update_block"], iters, test_mode,
                      self.corr_radius, self.downsample_factor, cd)


def refine(pyramid, coords0, net, context_zqr, update, iters: int,
           test_mode: bool, radius: int, factor: int,
           compute_dtype: Optional[torch.dtype], span: Optional[str] = None):
    """The refinement loop both stereo networks share: from coords0 (B, h,
    w, 2), each iteration looks `radius` taps up in the correlation
    pyramid, runs `update` (net, context_zqr, flow, corr) -> (net, mask
    logits, delta), keeps the delta's x only and convex-upsamples by
    `factor`. `span`, if given, names a device span around each iteration.

    Returns a list of full-res x-disparity maps (B, H, W, 1), f32: one per
    iteration, or only the final one in test mode."""
    cd = compute_dtype
    coords1 = coords0
    predictions = []
    for it in range(iters):
        with (device_span(span, coords0.device) if span
              else contextlib.nullcontext()):
            # each iteration refines a fixed starting point: no gradient
            # flows from one iteration's coordinates into the previous one
            coords1 = coords1.detach()
            corr = lookup_corr_pyramid(pyramid, coords1[..., 0],
                                       radius=radius)
            flow = coords1 - coords0
            net, mask, delta_flow = update(
                net, context_zqr, _nchw(flow).to(cd or corr.dtype),
                _nchw(corr).to(cd or corr.dtype))
            delta_flow = _nhwc(delta_flow)
            delta_flow = torch.stack(
                [delta_flow[..., 0], torch.zeros_like(delta_flow[..., 1])],
                dim=-1)
            coords1 = coords1 + delta_flow
            if test_mode and it < iters - 1:
                continue
            flow_up = convex_upsample(coords1 - coords0, _nhwc(mask), factor)
            predictions.append(flow_up[..., :1])
    return predictions


class MultiLevelRaftStereo(nn.Module):
    """RAFT-Stereo on the stacked [left; right] images: matching features
    (`fnet`, InstanceNorm) and every level's context (`cnet`) from the
    images, f32 correlation at 1 / 2^n_downsample, three coupled GRU
    levels, x-only updates and convex upsampling by 2^n_downsample.
    `hidden_dims[l]` is level l's width, finest first. With
    `remat_encoders` a forward that records gradients keeps only the
    encoders' outputs, and the backward runs `fnet` and `cnet` again (the
    same operations, so the same values)."""

    def __init__(self, encoder_dims: Sequence[int] = (64, 96, 128),
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 fnet_dim: int = 256, corr_levels: int = 4,
                 corr_radius: int = 4, n_downsample: int = 2,
                 remat_encoders: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat_encoders = remat_encoders
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.factor = 2 ** n_downsample
        self.compute_dtype = compute_dtype
        cd = compute_dtype
        self.fnet = BasicEncoder(encoder_dims, fnet_dim, n_downsample, cd)
        self.cnet = MultiLevelEncoder(encoder_dims, hidden_dims,
                                      n_downsample, cd)
        self.context_zqr_convs = nn.ModuleList([
            Conv(d, d * 3, 3, 1, 1, cd) for d in hidden_dims])
        self.update_block = BasicMultiUpdateBlock(
            hidden_dims, corr_levels * (2 * corr_radius + 1), self.factor,
            cd)

    def forward(self, image, iters: int = 22, test_mode: bool = False):
        """image: (2B, 3, H, W), left views then right views.

        Returns a list of full-res x-disparity maps (2B, H, W, 1), f32: one
        per iteration, or only the final one in test mode."""
        cd = self.compute_dtype
        with device_span("net.encoder", image.device):
            fmaps = self._encode(self.fnet, image)
            net, context_zqr = [], []
            for (hid, ctx), conv in zip(self._encode(self.cnet, image),
                                        self.context_zqr_convs):
                net.append(torch.tanh(hid.float()).to(cd or hid.dtype))
                context_zqr.append(torch.chunk(conv(torch.relu(ctx)), 3,
                                               dim=1))
        with device_span("net.stereo", image.device):
            b2, _, h, w = fmaps.shape
            fmap12 = _nhwc(fmaps)
            fmap21 = torch.cat([fmap12[b2 // 2:], fmap12[:b2 // 2]], dim=0)
            with device_span("net.corr", image.device):
                pyramid = build_corr_pyramid(fmap12, fmap21,
                                             num_levels=self.corr_levels)
            count("stereo.corr_bytes",
                  sum(v.numel() * v.element_size() for v in pyramid))
            count("stereo.iters", iters)
            coords0 = coords_grid(b2, h, w, device=image.device)
            return refine(pyramid, coords0, net, context_zqr,
                          self.update_block, iters, test_mode,
                          self.corr_radius, self.factor, cd,
                          span="net.update")

    def _encode(self, encoder: nn.Module, image):
        if self.remat_encoders and torch.is_grad_enabled():
            # nothing in the encoders draws random numbers
            return checkpoint(encoder, image, use_reentrant=False,
                              preserve_rng_state=False)
        return encoder(image)
