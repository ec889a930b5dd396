# Frozen copy of gps_gaussian_tpu_torch/ops/corr.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""All-pairs 1D correlation volume + pyramid lookup (RAFT-Stereo style).

Counterpart of gps_gaussian_tpu/ops/corr.py: `build_corr_volume` :25,
`build_corr_pyramid` :39, `lookup_corr_pyramid` :74. Feature maps are
channel-last (B, H, W, D); the volume is (B, H, W1, W2) with the search axis
last. The volume is a true-f32 batched matmul (TF32 is off on the GPU, see
utils/device.py). The lookup is a gather + lerp; the JAX package's dense
triangle-weight form exists only to avoid a TPU lane gather and gives the
same values.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from port_bench.reference.sampling import avg_pool_lastdim


def build_corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation along rows: (B, H, W1, W2) / sqrt(D), f32."""
    d = fmap1.shape[-1]
    corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return corr / math.sqrt(d)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> list[torch.Tensor]:
    """Volume + (num_levels - 1) 2x mean-pools of the search axis."""
    corr = build_corr_volume(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool_lastdim(corr)
        pyramid.append(corr)
    return pyramid


def sample_lastdim(vol: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear sampling of (B, H, W, S) along S at x (B, H, W, T).

    Align-corners semantics: integer x hits bin centres; taps outside
    [0, S-1] contribute zero, so an empty level (S = 0, a pooled level of a
    narrow image) samples zeros, as JAX's dense sum over S does."""
    s = vol.shape[-1]
    if s == 0:
        return torch.zeros_like(x, dtype=torch.promote_types(vol.dtype,
                                                             x.dtype))
    x0 = torch.floor(x)
    frac = x - x0
    x0 = x0.long()

    def tap(i):
        inside = (i >= 0) & (i <= s - 1)
        v = torch.gather(vol, -1, i.clamp(0, s - 1))
        return torch.where(inside, v, 0.0)

    return tap(x0) * (1.0 - frac) + tap(x0 + 1) * frac


def lookup_corr_pyramid(pyramid: Sequence[torch.Tensor],
                        coords_x: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """2r+1 taps around coords / 2^i from every level.

    pyramid: list of (B, H, W, S_i); coords_x: (B, H, W) absolute x in view
    2. Returns (B, H, W, levels * (2r+1)) f32, level-major, taps -r..+r."""
    taps = torch.arange(-radius, radius + 1, dtype=coords_x.dtype,
                        device=coords_x.device)
    out = []
    for i, vol in enumerate(pyramid):
        x = coords_x[..., None] / (2 ** i) + taps
        out.append(sample_lastdim(vol, x))
    return torch.cat(out, dim=-1).float()
