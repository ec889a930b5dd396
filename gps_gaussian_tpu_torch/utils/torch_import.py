"""Import reference (PyTorch) GPS-Gaussian checkpoints into the port.

Counterpart of gps_gaussian_tpu/utils/torch_import.py (`convert_state_dict`
:71, `load_reference_checkpoint` :149). The port's modules carry the
reference's names and layouts (utils/weights.py), so nothing is renamed or
transposed: `convert_state_dict` takes exactly the tensors that the JAX
converter reads, as f32, and raises, naming the key, for one the file
lacks. Keys the JAX converter ignores are left out and counted in the log.

Two traps of the reference's layout, as in the JAX converter:
- `norm3` of a `ResidualBlock` with a downsample is registered twice, as
  itself and as `downsample.1`; `norm3` is read and `downsample.1` is
  filled from it;
- a stage-1 file has no `gs_parm_regresser.*`, so the GS head is read only
  when the file holds it (JAX :121). The three heads' first convs stay
  separate here; JAX fuses them into `head_conv1`.

There is no separate entry point for a `.pth`: its weights reach a model
through `train/state.py restore_params_partial(load_reference_checkpoint(p),
model)` or `FreeviewRenderer(cfg, load_reference_checkpoint(p))`.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping

import numpy as np
import torch

log = logging.getLogger("gps_tpu_torch.torch_import")


def _pair(p: str) -> List[str]:
    return [f"{p}.weight", f"{p}.bias"]


def _res_block(sd, p: str) -> List[str]:
    """Reference ResidualBlock (core/extractor.py:6-60)."""
    keys = (_pair(f"{p}.conv1") + _pair(f"{p}.conv2") + _pair(f"{p}.norm1")
            + _pair(f"{p}.norm2"))
    if f"{p}.downsample.0.weight" in sd:
        keys += _pair(f"{p}.downsample.0") + _pair(f"{p}.norm3")
    return keys


def _unet(sd, p: str) -> List[str]:
    """Reference UnetExtractor (core/extractor.py:63-91)."""
    keys = _pair(f"{p}.in_ds.0") + _pair(f"{p}.in_ds.1")
    for res in ("res1", "res2", "res3"):
        for i in range(2):
            keys += _res_block(sd, f"{p}.{res}.{i}")
    return keys


def _read_keys(sd) -> List[str]:
    """The names the JAX converter reads from `sd`, in its order."""
    keys = _unet(sd, "img_encoder")
    cnet = "raft_stereo.cnet"
    keys += _res_block(sd, f"{cnet}.conv2.0") + _pair(f"{cnet}.conv2.1")
    for i in range(2):
        keys += (_res_block(sd, f"{cnet}.outputs08.{i}.0")
                 + _pair(f"{cnet}.outputs08.{i}.1"))
    keys += _pair("raft_stereo.context_zqr_convs.0")
    ub = "raft_stereo.update_module.update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        keys += _pair(f"{ub}.encoder.{name}")
    for name in ("convz", "convr", "convq"):
        keys += _pair(f"{ub}.gru08.{name}")
    keys += (_pair(f"{ub}.flow_head.conv1") + _pair(f"{ub}.flow_head.conv2")
             + _pair(f"{ub}.mask.0") + _pair(f"{ub}.mask.2"))
    g = "gs_parm_regresser"
    if f"{g}.depth_encoder.in_ds.0.weight" in sd:
        keys += _unet(sd, f"{g}.depth_encoder")
        for dec in ("decoder3", "decoder2", "decoder1"):
            for i in range(2):
                keys += _res_block(sd, f"{g}.{dec}.{i}")
        keys += _pair(f"{g}.out_conv")
        for head in ("rot_head", "scale_head", "opacity_head"):
            keys += _pair(f"{g}.{head}.0") + _pair(f"{g}.{head}.2")
    return keys


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def convert_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference RtStereoHumanModel state_dict (tensors or arrays) -> the
    port's `GPSGaussianModel` state_dict, f32 on the CPU. Raises KeyError
    naming the first key that the JAX converter reads and `sd` lacks."""
    keys = _read_keys(sd)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"reference checkpoint lacks {missing[0]!r} "
                       f"({len(missing)} keys missing)")
    out = {k: _f32(sd[k]) for k in keys}
    for k in keys:
        if ".norm3." in k:  # the same module as downsample.1
            out[k.replace(".norm3.", ".downsample.1.")] = out[k]
    ignored = len(set(sd) - set(keys))
    if ignored:
        log.info("reference checkpoint: %d tensors read, %d ignored",
                 len(keys), ignored)
    return out


def load_reference_checkpoint(path) -> Dict[str, torch.Tensor]:
    """Load a reference .pth (as its train_stage*.py save it: the state_dict
    under 'network'; a bare state_dict is taken as it is) and convert it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(ckpt.get("network", ckpt))
