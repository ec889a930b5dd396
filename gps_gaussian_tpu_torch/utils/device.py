"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: asking for
CUDA on a machine without a GPU raises instead of falling back.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch.device to run on; raises if CUDA is asked for and absent.

    On CUDA it also turns TF32 off for matmuls and convolutions: geometry
    and the correlation volume are true f32 in the JAX package
    (ops/corr.py, geometry/pointcloud.py use Precision.HIGHEST)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
