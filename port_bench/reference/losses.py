# Frozen copy of gps_gaussian_tpu_torch/train/losses.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Losses and metrics: sequence flow loss, L1, SSIM, PSNR.

Counterpart of gps_gaussian_tpu/train/losses.py: `sequence_loss` :14,
`l1_loss` :50, `_gaussian_window` :54, `ssim` :61 and `psnr` :91. Inputs are
NHWC, as in the JAX package; everything computes in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor, loss_gamma: float = 0.9
                  ) -> Tuple[torch.Tensor, dict]:
    """Gamma-weighted L1 over the GRU-iteration predictions.

    The gamma is adjusted as 0.9^(15/(n-1)) so the weighting is the same for
    any iteration count; each iteration's L1 is averaged over valid pixels
    only.

    flow_preds: per-iteration (B, H, W, 1) disparities; flow_gt and valid
    (in {0, 1}): (B, H, W, 1). Returns (loss scalar, metrics of scalars).
    """
    n = len(flow_preds)
    v = (valid >= 0.5).float()
    denom = torch.clamp_min(v.sum(), 1.0)
    flow_gt = flow_gt.float()

    adjusted_gamma = loss_gamma ** (15.0 / max(n - 1, 1))
    loss = 0.0
    for i, pred in enumerate(flow_preds):
        w = adjusted_gamma ** (n - i - 1)
        loss = loss + w * ((pred.float() - flow_gt).abs() * v).sum() / denom

    with torch.no_grad():
        epe = torch.sqrt(((flow_preds[-1].float() - flow_gt) ** 2).sum(-1))
        vm = v[..., 0]
        epe_denom = torch.clamp_min(vm.sum(), 1.0)
        metrics = {
            "train_epe": (epe * vm).sum() / epe_denom,
            "train_1px": ((epe < 1).float() * vm).sum() / epe_denom,
            "train_3px": ((epe < 3).float() * vm).sum() / epe_denom,
        }
    return loss, metrics


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred.float() - gt.float()).abs().mean()


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(K, K) normalised Gaussian window, built in float64 then cast."""
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM: per-channel Gaussian window 11x11, sigma 1.5, SAME
    zero padding, depthwise convolution, C1 = 0.01^2, C2 = 0.03^2, mean over
    the whole map. img*: (B, H, W, C) in [0, 1]."""
    c = img1.shape[-1]
    win = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    kernel = win[None, None].expand(c, 1, -1, -1).contiguous()
    x1 = img1.float().permute(0, 3, 1, 2)
    x2 = img2.float().permute(0, 3, 1, 2)

    def filt(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=c)

    mu1, mu2 = filt(x1), filt(x2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(x1 * x1) - mu1_sq
    sigma2_sq = filt(x2 * x2) - mu2_sq
    sigma12 = filt(x1 * x2) - mu1_mu2

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return ssim_map.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR for [0, 1] images, (B,)."""
    b = img1.shape[0]
    mse = ((img1.float() - img2.float()) ** 2).reshape(b, -1).mean(dim=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
