"""Plain float32 reference of RAFT-Stereo, for the port's tests.

RAFT-Stereo (Lipson, Teed and Deng, "RAFT-Stereo: Multilevel Recurrent
Field Transforms for Stereo Matching", 3DV 2021; github.com/princeton-vl/
RAFT-Stereo, core/raft_stereo.py, core/extractor.py, core/update.py,
core/corr.py, train_stereo.py) written out in plain `torch` operations,
batch-major NCHW, with upstream's module names. It imports nothing of
gps_gaussian_tpu_torch and no JAX.

    ResidualBlock(in, out, N, s): y = relu(N(conv3x3_s(x))),
        y = relu(N(conv3x3(y))), x' = N(conv1x1_s(x)) unless s == 1 and
        in == out (x' = x); out = relu(x' + y)
    fnet (N = InstanceNorm, no affine): conv7x7 3->d0, N, relu;
        layer1 RB(d0,d0,1) RB(d0,d0,1); layer2 RB(d0,d1,2) RB(d1,d1,1);
        layer3 RB(d1,d2,2) RB(d2,d2,1); conv1x1 d2->2*d2   (at 1/4)
    cnet (N = BatchNorm, frozen): the same trunk; layer4, layer5 as
        RB(d2,d2,2) RB(d2,d2,1) (1/8, 1/16); at each level two heads,
        hidden and context: RB(d2,d2,1) + conv3x3 at 1/4 and 1/8, conv3x3
        alone at 1/16; net_l = tanh(hidden_l), inp_l = relu(context_l),
        then conv3x3 inp_l -> 3 h_l split into cz, cr, cq
    correlation: f1 . f2 over channels / sqrt(C) along each row, 4 levels
        pooled by 2 along the target width, 9 taps a level at x / 2^i
        (grid_sample, corners aligned, zeros outside)
    each iteration, coarsest level first:
        net2 = GRU32(net2, pool2x(net1)); net1 = GRU16(net1, pool2x(net0),
        interp(net2)); net0 = GRU08(net0, motion(flow, corr), interp(net1));
        delta = FlowHead(net0) with delta_y = 0; mask = 0.25 mask_head(net0)
        coords1 += delta; prediction = x of the convex x4 upsampling
    ConvGRU: z = sigmoid(Wz[h, x] + cz), r = sigmoid(Wr[h, x] + cr),
        q = tanh(Wq[r h, x] + cq), h' = (1 - z) h + z q

Departures, as in the port's configuration: both directions in one batch
(queries [L; R] against targets [R; L]); no max_flow cut in the loss.
`hidden_dims` lists each level's width finest first.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def exact_f32() -> None:
    """f32 matmuls and convolutions as f32 on a GPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _norm(kind: str, ch: int) -> nn.Module:
    return nn.InstanceNorm2d(ch) if kind == "instance" else \
        nn.BatchNorm2d(ch)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.norm3 = _norm(norm, cout)
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _layer(cin, cout, norm, stride):
    return nn.Sequential(ResidualBlock(cin, cout, norm, stride),
                         ResidualBlock(cout, cout, norm, 1))


class Trunk(nn.Module):
    def __init__(self, dims, norm):
        super().__init__()
        d0, d1, d2 = dims
        self.conv1 = nn.Conv2d(3, d0, 7, padding=3)
        self.norm1 = _norm(norm, d0)
        self.layer1 = _layer(d0, d0, norm, 1)
        self.layer2 = _layer(d0, d1, norm, 2)
        self.layer3 = _layer(d1, d2, norm, 2)

    def trunk(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(Trunk):
    def __init__(self, dims):
        super().__init__(dims, "instance")
        self.conv2 = nn.Conv2d(dims[2], 2 * dims[2], 1)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(Trunk):
    def __init__(self, dims, hidden_dims):
        super().__init__(dims, "batch")
        d2 = dims[2]
        self.layer4 = _layer(d2, d2, "batch", 2)
        self.layer5 = _layer(d2, d2, "batch", 2)

        def head(dim, coarsest=False):
            conv = nn.Conv2d(d2, dim, 3, padding=1)
            if coarsest:
                return conv
            return nn.Sequential(ResidualBlock(d2, d2, "batch", 1), conv)

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
    def __init__(self, hidden, inp):
        super().__init__()
        self.convz = nn.Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + inp, hidden, 3, padding=1)

    def forward(self, h, cz, cr, cq, *xs):
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, inp):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear",
                         align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, hidden_dims, corr_planes, factor):
        super().__init__()
        h0, h1, h2 = hidden_dims
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru08 = ConvGRU(h0, 128 + h1)
        self.gru16 = ConvGRU(h1, h0 + h2)
        self.gru32 = ConvGRU(h2, h1)
        self.flow_head = FlowHead(h0)
        self.mask = nn.Sequential(nn.Conv2d(h0, 256, 3, padding=1),
                                  nn.ReLU(),
                                  nn.Conv2d(256, factor ** 2 * 9, 1))

    def forward(self, net, inp, corr, flow):
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                            interp(net[2], net[1]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *inp[0], motion, interp(net[1], net[0]))
        delta_flow = self.flow_head(net[0])
        mask = 0.25 * self.mask(net[0])
        return net, mask, delta_flow


class CorrBlock1D:
    """All-pairs correlation along rows and its pyramid (core/corr.py)."""

    def __init__(self, fmap1, fmap2, num_levels=4, radius=4):
        self.num_levels, self.radius = num_levels, radius
        b, d, h, w1 = fmap1.shape
        w2 = fmap2.shape[3]
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2) / math.sqrt(d)
        corr = corr.reshape(b * h * w1, 1, 1, w2)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, [1, 2], stride=[1, 2])
            self.pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        b, _, h, w = coords.shape
        x = coords[:, 0].reshape(b * h * w, 1, 1, 1)
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        out = []
        for i, corr in enumerate(self.pyramid):
            x0 = dx.view(1, 1, 2 * r + 1, 1) + x / 2 ** i
            w2 = corr.shape[-1]
            # align_corners: -1 and 1 are the first and last bins' centres
            gx = 2 * x0 / (w2 - 1) - 1
            grid = torch.cat([gx, torch.zeros_like(gx)], dim=-1)
            sampled = F.grid_sample(corr, grid, align_corners=True)
            out.append(sampled.view(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class RAFTStereo(nn.Module):
    """encoder_dims (d0, d1, d2), hidden_dims finest first; upsampling x4."""

    def __init__(self, encoder_dims=(64, 96, 128),
                 hidden_dims=(128, 128, 128), corr_levels=4, corr_radius=4):
        super().__init__()
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.factor = 4
        self.fnet = BasicEncoder(encoder_dims)
        self.cnet = MultiBasicEncoder(encoder_dims, hidden_dims)
        self.context_zqr_convs = nn.ModuleList([
            nn.Conv2d(h, 3 * h, 3, padding=1) for h in hidden_dims])
        self.update_block = BasicMultiUpdateBlock(
            hidden_dims, corr_levels * (2 * corr_radius + 1), self.factor)

    def freeze_bn(self):
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()

    def upsample_flow(self, flow, mask):
        n, d, h, w = flow.shape
        f = self.factor
        mask = torch.softmax(mask.view(n, 1, 9, f, f, h, w), dim=2)
        up = F.unfold(f * flow, [3, 3], padding=1).view(n, d, 9, 1, 1, h, w)
        up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(n, d, f * h, f * w)

    def forward(self, image1, image2, iters=22, test_mode=False):
        """image1, image2: (B, 3, H, W) in [-1, 1]. Returns the x
        disparities (2B, 1, H, W), left views' then right views', of every
        iteration (the last alone in test mode)."""
        exact_f32()
        image = torch.cat([image1, image2], dim=0)
        fmap = self.fnet(image)
        b = image1.shape[0]
        fmap21 = torch.cat([fmap[b:], fmap[:b]], dim=0)
        net, inp = [], []
        for (hid, ctx), conv in zip(self.cnet(image), self.context_zqr_convs):
            net.append(torch.tanh(hid))
            inp.append(conv(F.relu(ctx)).chunk(3, dim=1))
        corr_fn = CorrBlock1D(fmap.float(), fmap21.float(),
                              self.corr_levels, self.corr_radius)
        n, _, h, w = fmap.shape
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        coords0 = torch.stack([xs, ys])[None].repeat(n, 1, 1, 1).to(
            image.device)
        coords1 = coords0.clone()
        preds = []
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, mask, delta = self.update_block(net, inp, corr, flow)
            delta = torch.cat([delta[:, :1], torch.zeros_like(delta[:, 1:])],
                              dim=1)
            coords1 = coords1 + delta
            if test_mode and itr < iters - 1:
                continue
            preds.append(self.upsample_flow(coords1 - coords0, mask)[:, :1])
        return preds


def sequence_loss(preds, flow_gt, valid, gamma=0.9):
    """train_stereo.py's loss without the max_flow cut: the gamma-weighted
    mean |error| over valid pixels, gamma adjusted to 0.9^(15 / (n - 1))."""
    n = len(preds)
    valid = valid >= 0.5
    loss = 0.0
    for i, pred in enumerate(preds):
        weight = (gamma ** (15 / (n - 1))) ** (n - i - 1)
        loss = loss + weight * (pred - flow_gt).abs()[valid].mean()
    return loss


def adamw_step(params, grads, lr, wdecay, clip=1.0, betas=(0.9, 0.999),
               eps=1e-8):
    """One AdamW step from zero moments after clipping the gradients' global
    norm to `clip` (train_stereo.py: clip_grad_norm_, AdamW). Returns the
    new parameters."""
    total = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    coef = min(clip / (float(total) + 1e-6), 1.0)
    bc1, bc2 = 1 - betas[0], 1 - betas[1]   # bias corrections at step 1
    out = {}
    for k, p in params.items():
        g = grads[k] * coef
        m, v = (1 - betas[0]) * g, (1 - betas[1]) * g * g
        denom = v.sqrt() / math.sqrt(bc2) + eps
        out[k] = p * (1 - lr * wdecay) - lr / bc1 * m / denom
    return out
