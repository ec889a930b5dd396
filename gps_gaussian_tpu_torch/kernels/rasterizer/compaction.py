"""Live-first compaction ordering, and the row gather it feeds.

Counterpart of gps_gaussian_tpu/kernels/rasterizer/compaction.py
`live_first_order` :25: a stable keep-rows-first order truncated to a
static cap, so kept rows preserve their relative order and every kept row
lost to the cap is counted; and of `take_rows_unique`
(pallas_kernel.py:72-99).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def live_first_order(keep: torch.Tensor, cap: int) -> Tuple[
        Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Stable keep-rows-first ordering truncated to `cap` slots.

    Args:
      keep: (N,) bool mask of rows to keep.
      cap: output slot count.
    Returns (idx, live, n_dropped):
      idx: (cap,) int64 unique row indices to gather, or None when cap >= N
        (nothing can drop: mask in place, pad if cap > N).
      live: (cap,) f32 {0, 1} validity of each output slot.
      n_dropped: () int64 kept rows lost to the cap.
    """
    n = keep.shape[0]
    n_live = keep.sum()
    if cap < n:
        order = torch.sort((~keep).to(torch.uint8), stable=True).indices
        n_kept = torch.clamp_max(n_live, cap)
        live = (torch.arange(cap, device=keep.device) < n_kept).float()
        return order[:cap], live, n_live - n_kept
    live = keep.float()
    if cap > n:
        live = torch.nn.functional.pad(live, (0, cap - n))
    return None, live, torch.zeros((), dtype=torch.int64, device=keep.device)


class _TakeRowsUnique(torch.autograd.Function):
    """x[idx] for UNIQUE row indices, with a copy as its backward.

    Counterpart of `take_rows_unique` (pallas_kernel.py:72-99). Autograd's
    own backward of x[idx] is index_put with accumulation, which on CUDA
    adds with float atomics; the indices are unique, so a plain row copy
    into zeros gives the same gradient with the same bits every run."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        out.index_copy_(0, idx, g)
        return out, None


def take_rows_unique(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather x[idx]; `idx` (int64) must hold no index twice."""
    return _TakeRowsUnique.apply(x, idx)
