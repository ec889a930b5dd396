# Frozen copy of gps_gaussian_tpu_torch/utils/containers.py at commit 19aea69,
# rewritten to stand alone (imports only torch, numpy and this package).
"""Typed containers of tensors: the inter-layer data contract.

Counterpart of gps_gaussian_tpu/utils/containers.py. Dataclasses of tensors
instead of flax pytrees. Images and maps stay NHWC at every public
function, as in the JAX package, so the two can be compared directly.

* every `depth` map stores inverse depth 1/z;
* images are float32 in [-1, 1], pre-multiplied by the foreground mask;
* intrinsics are 3x3 pinhole K, extrinsics 3x4 world->camera [R|t].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _to(obj, device):
    """Copy of a container with every tensor field moved to `device`."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass
class SourceView:
    """One rectified source view of a stereo pair (batched)."""

    img: torch.Tensor        # (B, H, W, 3) float in [-1, 1], masked
    mask: torch.Tensor       # (B, H, W, 1) float {0, 1}
    intr: torch.Tensor       # (B, 3, 3) rectified intrinsics of this view
    ref_intr: torch.Tensor   # (B, 3, 3) rectified intrinsics of the other
    extr: torch.Tensor       # (B, 3, 4) rectified extrinsics (world -> cam)
    tf_x: torch.Tensor       # (B,) signed rectified baseline term
    flow: Optional[torch.Tensor] = None   # (B, H, W, 1) GT disparity-flow
    valid: Optional[torch.Tensor] = None  # (B, H, W, 1) eroded validity

    @property
    def batch(self) -> int:
        return self.img.shape[0]

    to = _to


@dataclasses.dataclass
class NovelCamera:
    """Target camera for splatting, batched; column-vector matrices:
    `view @ [x; 1]` is the camera-space point, `proj @ [x; 1]` clip space."""

    view: torch.Tensor        # (B, 4, 4) world -> camera
    proj: torch.Tensor        # (B, 4, 4) full projection P_gl @ view
    cam_center: torch.Tensor  # (B, 3)
    tanfovx: torch.Tensor     # (B,)
    tanfovy: torch.Tensor     # (B,)
    height: int = 0
    width: int = 0

    @property
    def batch(self) -> int:
        return self.view.shape[0]

    to = _to


@dataclasses.dataclass
class NovelView:
    """Novel-view target: camera plus (in training) the GT image."""

    camera: NovelCamera
    img: Optional[torch.Tensor] = None   # (B, H, W, 3) float in [0, 1]
    intr: Optional[torch.Tensor] = None  # (B, 3, 3)
    extr: Optional[torch.Tensor] = None  # (B, 3, 4)

    to = _to


@dataclasses.dataclass
class StereoSample:
    """A batched stereo pair, plus the novel view when training."""

    lmain: SourceView
    rmain: SourceView
    novel: Optional[NovelView] = None

    @property
    def batch(self) -> int:
        return self.lmain.batch

    to = _to


@dataclasses.dataclass
class GaussianMaps:
    """Per-pixel Gaussian parameters for ONE source view (batched);
    background pixels carry valid = 0 instead of being dropped."""

    xyz: torch.Tensor      # (B, H, W, 3) world-space means
    rgb: torch.Tensor      # (B, H, W, 3) colors in [0, 1]
    rot: torch.Tensor      # (B, H, W, 4) unit quaternions (w, x, y, z)
    scale: torch.Tensor    # (B, H, W, 3) positive scales, <= 0.01
    opacity: torch.Tensor  # (B, H, W, 1) in (0, 1)
    valid: torch.Tensor    # (B, H, W, 1) float {0, 1}: depth != 0
    depth: torch.Tensor    # (B, H, W, 1) inverse depth (1/z)

    def flatten(self) -> "FlatGaussians":
        b, h, w, _ = self.xyz.shape
        n = h * w
        return FlatGaussians(
            xyz=self.xyz.reshape(b, n, 3), rgb=self.rgb.reshape(b, n, 3),
            rot=self.rot.reshape(b, n, 4), scale=self.scale.reshape(b, n, 3),
            opacity=self.opacity.reshape(b, n, 1),
            valid=self.valid.reshape(b, n))


@dataclasses.dataclass
class FlatGaussians:
    """Flattened Gaussian set (batched, fixed-size, mask-padded)."""

    xyz: torch.Tensor      # (B, N, 3)
    rgb: torch.Tensor      # (B, N, 3)
    rot: torch.Tensor      # (B, N, 4)
    scale: torch.Tensor    # (B, N, 3)
    opacity: torch.Tensor  # (B, N, 1)
    valid: torch.Tensor    # (B, N) float {0, 1}

    @property
    def count(self) -> int:
        return self.xyz.shape[1]

    def concat(self, other: "FlatGaussians") -> "FlatGaussians":
        return FlatGaussians(**{
            f.name: torch.cat([getattr(self, f.name), getattr(other, f.name)],
                              dim=1)
            for f in dataclasses.fields(self)})

    to = _to
