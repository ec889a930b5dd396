# Frozen copy of tests/plain_raft_stereo.py, computed at a configuration's
# precision and wrapped for pipeline.train_steps (imports only torch and
# this package), but for the correlation, its lookup and the convex
# upsampling, which are this package's frozen ops (corr.py, sampling.py).
"""Plain reference of RAFT-Stereo (Lipson, Teed and Deng, 3DV 2021;
github.com/princeton-vl/RAFT-Stereo: core/raft_stereo.py, core/extractor.py,
core/update.py, core/corr.py, train_stereo.py) for the comparison that
decides `correct` in the `raftstereo_stage1` cells.

The equations are those of tests/plain_raft_stereo.py, batch-major NCHW,
with upstream's module names under `raft_stereo.`, both directions in one
batch (queries [L; R] against targets [R; L]) and BatchNorm frozen as
upstream's `freeze_bn` leaves it (`build_model`). The correlation, the
lookup and the upsampling are corr.py's and sampling.py's, channel-last,
where tests/plain_raft_stereo.py writes upstream's `CorrBlock1D`
(`grid_sample`) and `upsample_flow` (`unfold`): the same values in f32
(tests/test_torch_port_raft_stereo.py), summed in the program's order. In
bf16 another order of those f32 sums, forward or backward, rounds some
bf16 values the other way, and the feature net's gradients, which arrive
only through the lookups, part by far more than the program's own
run-to-run noise: a comparison would read that as a fault.

With a `compute_dtype` every convolution computes in it (`layers.Conv`:
input, weight and bias cast) and the rest stays f32 where the
configuration says so: norms in f32 cast back, the correlation and its
lookup in f32, the GRU gates in f32 after the context bias is added in the
compute dtype, the heads' outputs and the upsampling in f32.
`set_control` computes every convolution, and with `corr` the
correlation's inputs, through quant.py one precision lower. A recipe's
`raft.remat_encoders` has the backward run the two encoders again in
place of their kept activations (torch.utils.checkpoint; the same values,
in less memory).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference import corr as corr_ops
from port_bench.reference import sampling
from port_bench.reference.containers import StereoSample
from port_bench.reference.layers import Conv


def exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class InstanceNorm32(nn.InstanceNorm2d):
    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class BatchNorm32(nn.BatchNorm2d):
    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


def _norm(kind: str, ch: int) -> nn.Module:
    return InstanceNorm32(ch) if kind == "instance" else BatchNorm32(ch)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride, cd):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1, cd)
        self.conv2 = Conv(cout, cout, 3, 1, 1, cd)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.norm3 = _norm(norm, cout)
            self.downsample = nn.Sequential(Conv(cin, cout, 1, stride, 0, cd),
                                            self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _layer(cin, cout, norm, stride, cd):
    return nn.Sequential(ResidualBlock(cin, cout, norm, stride, cd),
                         ResidualBlock(cout, cout, norm, 1, cd))


class Trunk(nn.Module):
    def __init__(self, dims, norm, cd):
        super().__init__()
        d0, d1, d2 = dims
        self.conv1 = Conv(3, d0, 7, 1, 3, cd)
        self.norm1 = _norm(norm, d0)
        self.layer1 = _layer(d0, d0, norm, 1, cd)
        self.layer2 = _layer(d0, d1, norm, 2, cd)
        self.layer3 = _layer(d1, d2, norm, 2, cd)

    def trunk(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(Trunk):
    def __init__(self, dims, cd):
        super().__init__(dims, "instance", cd)
        self.conv2 = Conv(dims[2], 2 * dims[2], 1, 1, 0, cd)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(Trunk):
    def __init__(self, dims, hidden_dims, cd):
        super().__init__(dims, "batch", cd)
        d2 = dims[2]
        self.layer4 = _layer(d2, d2, "batch", 2, cd)
        self.layer5 = _layer(d2, d2, "batch", 2, cd)

        def head(dim, coarsest=False):
            conv = Conv(d2, dim, 3, 1, 1, cd)
            if coarsest:
                return conv
            return nn.Sequential(ResidualBlock(d2, d2, "batch", 1, cd), conv)

        h0, h1, h2 = hidden_dims
        self.outputs08 = nn.ModuleList([head(h0), head(h0)])
        self.outputs16 = nn.ModuleList([head(h1), head(h1)])
        self.outputs32 = nn.ModuleList([head(h2, True), head(h2, True)])

    def forward(self, x):
        x = self.trunk(x)
        y = self.layer4(x)
        z = self.layer5(y)
        return [[f(v) for f in heads] for v, heads in
                ((x, self.outputs08), (y, self.outputs16),
                 (z, self.outputs32))]


class ConvGRU(nn.Module):
    def __init__(self, hidden, inp, cd):
        super().__init__()
        self.convz = Conv(hidden + inp, hidden, 3, 1, 1, cd)
        self.convr = Conv(hidden + inp, hidden, 3, 1, 1, cd)
        self.convq = Conv(hidden + inp, hidden, 3, 1, 1, cd)

    def forward(self, h, cz, cr, cq, *xs):
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid((self.convz(hx) + cz).float())
        r = torch.sigmoid((self.convr(hx) + cr).float())
        q = torch.tanh((self.convq(torch.cat([r.to(h.dtype) * h, x], dim=1))
                        + cq).float())
        return ((1 - z) * h.float() + z * q).to(h.dtype)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes, cd):
        super().__init__()
        self.convc1 = Conv(corr_planes, 64, 1, 1, 0, cd)
        self.convc2 = Conv(64, 64, 3, 1, 1, cd)
        self.convf1 = Conv(2, 64, 7, 1, 3, cd)
        self.convf2 = Conv(64, 64, 3, 1, 1, cd)
        self.conv = Conv(128, 126, 3, 1, 1, cd)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class FlowHead(nn.Module):
    def __init__(self, inp, cd):
        super().__init__()
        self.conv1 = Conv(inp, 256, 3, 1, 1, cd)
        self.conv2 = Conv(256, 2, 3, 1, 1, cd)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear",
                         align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, hidden_dims, corr_planes, factor, cd):
        super().__init__()
        h0, h1, h2 = hidden_dims
        self.encoder = BasicMotionEncoder(corr_planes, cd)
        self.gru08 = ConvGRU(h0, 128 + h1, cd)
        self.gru16 = ConvGRU(h1, h0 + h2, cd)
        self.gru32 = ConvGRU(h2, h1, cd)
        self.flow_head = FlowHead(h0, cd)
        self.mask = nn.Sequential(Conv(h0, 256, 3, 1, 1, cd), nn.ReLU(),
                                  Conv(256, factor ** 2 * 9, 1, 1, 0, cd))

    def forward(self, net, inp, corr, flow):
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                            interp(net[2], net[1]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *inp[0], motion, interp(net[1], net[0]))
        delta_flow = self.flow_head(net[0]).float()
        mask = 0.25 * self.mask(net[0]).float()
        return net, mask, delta_flow


class RAFTStereo(nn.Module):
    def __init__(self, encoder_dims=(64, 96, 128),
                 hidden_dims=(128, 128, 128), corr_levels=4, corr_radius=4,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat_encoders: bool = False):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.remat_encoders = remat_encoders
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.factor = 4
        # the control's lower precision for the correlation's inputs
        self.corr_quant = None
        self.fnet = BasicEncoder(encoder_dims, cd)
        self.cnet = MultiBasicEncoder(encoder_dims, hidden_dims, cd)
        self.context_zqr_convs = nn.ModuleList([
            Conv(h, 3 * h, 3, 1, 1, cd) for h in hidden_dims])
        self.update_block = BasicMultiUpdateBlock(
            hidden_dims, corr_levels * (2 * corr_radius + 1), self.factor,
            cd)

    def freeze_bn(self):
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()

    def forward(self, image, iters=22, test_mode=False):
        """image: (2B, 3, H, W), left views then right views. Returns the
        x-disparities (2B, H, W, 1), f32, of every iteration (test mode:
        the last)."""
        exact_f32()
        cd = self.compute_dtype or image.dtype
        image = image.to(cd)
        fmap = self._encode(self.fnet, image)
        net, inp = [], []
        for (hid, ctx), conv in zip(self._encode(self.cnet, image),
                                    self.context_zqr_convs):
            net.append(torch.tanh(hid.float()).to(cd))
            inp.append(conv(F.relu(ctx)).chunk(3, dim=1))
        n, _, h, w = fmap.shape
        f12 = fmap.permute(0, 2, 3, 1)
        f21 = torch.cat([f12[n // 2:], f12[:n // 2]], dim=0)
        if self.corr_quant is not None:
            f12, f21 = self.corr_quant(f12.float()), self.corr_quant(
                f21.float())
        pyramid = corr_ops.build_corr_pyramid(f12, f21, self.corr_levels)
        coords0 = sampling.coords_grid(n, h, w, device=image.device)
        coords1 = coords0
        preds = []
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = corr_ops.lookup_corr_pyramid(pyramid, coords1[..., 0],
                                                self.corr_radius)
            flow = coords1 - coords0
            net, mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2).to(cd),
                flow.permute(0, 3, 1, 2).to(cd))
            delta = delta.permute(0, 2, 3, 1)
            delta = torch.stack([delta[..., 0],
                                 torch.zeros_like(delta[..., 1])], dim=-1)
            coords1 = coords1 + delta
            if test_mode and itr < iters - 1:
                continue
            up = sampling.convex_upsample(coords1 - coords0,
                                          mask.permute(0, 2, 3, 1),
                                          self.factor)
            preds.append(up[..., :1])
        return preds

    def _encode(self, encoder, image):
        if self.remat_encoders and torch.is_grad_enabled():
            return checkpoint(encoder, image, use_reentrant=False)
        return encoder(image)


@dataclasses.dataclass
class Output:
    """flow_preds: per-iteration x-disparity (2B, H, W, 1), f32."""

    flow_preds: Tuple[torch.Tensor, ...]


class RaftStereoModel(nn.Module):
    """The reference over a StereoSample (NHWC views), as
    pipeline.train_steps drives a model; parameter names as the port's."""

    def __init__(self, encoder_dims: Sequence[int], hidden_dims: Sequence[int],
                 corr_levels: int, corr_radius: int,
                 compute_dtype: Optional[torch.dtype],
                 remat_encoders: bool = False):
        super().__init__()
        self.raft_stereo = RAFTStereo(encoder_dims, hidden_dims, corr_levels,
                                      corr_radius, compute_dtype,
                                      remat_encoders)

    def set_control(self, quant, corr: bool) -> None:
        """Compute every convolution (and, with `corr`, the correlation's
        inputs) through `quant` (quant.py); None restores the configured
        precision."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = quant
        self.raft_stereo.corr_quant = quant if corr else None

    def forward(self, sample: StereoSample, iters: int = 22,
                test_mode: bool = False) -> Output:
        image = torch.cat([sample.lmain.img, sample.rmain.img], dim=0)
        preds = self.raft_stereo(image.permute(0, 3, 1, 2), iters, test_mode)
        return Output(flow_preds=tuple(preds))


def build_model(recipe: dict, device="cpu") -> RaftStereoModel:
    """The recipe's RAFT-Stereo, in training mode with BatchNorm frozen
    (train_stereo.py: model.train(), then freeze_bn())."""
    raft = recipe["raft"]
    model = RaftStereoModel(
        tuple(raft["encoder_dims"]), tuple(raft["hidden_dims"][::-1]),
        raft.get("corr_levels", 4), raft.get("corr_radius", 4),
        torch.bfloat16 if raft["mixed_precision"] else None,
        raft.get("remat_encoders", False)).to(device)
    model.train()
    model.raft_stereo.freeze_bn()
    return model
