"""Lower precisions for the control of `correct`: the reference computed one
step below the precision its configuration states, by rounding what enters
each convolution (and matmul) and computing on as configured.

`tf32` rounds f32 to TF32's 10 mantissa bits (round to nearest, ties away,
as the tensor cores' conversion does); `fp8` scales a tensor by its largest
magnitude onto float8_e4m3fn's range, rounds to it and scales back. Both
pass the gradient straight through the rounding, as a lower-precision
training step does."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"tf32 rounds float32, got {x.dtype}")
    bits = x.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (q - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


KINDS = {"tf32": tf32, "fp8": fp8}
