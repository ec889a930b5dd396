"""Flax parameters -> a reference-named PyTorch state_dict.

The inverse of gps_gaussian_tpu/utils/torch_import.py `convert_state_dict`
:71. The port's modules carry the reference's names, so the result loads
into `GPSGaussianModel` with `load_state_dict`, as a reference `.pth` does.
Layouts: flax conv kernel (kH, kW, I, O) -> torch (O, I, kH, kW); GroupNorm
scale/bias -> weight/bias. The JAX gsnet's fused `head_conv1` (3 * head_dim
output channels in [rot, scale, opacity] order) splits back into the three
heads' first convs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(sd, prefix, p):
    """p: a flax Conv wrapper's params ({'Conv_0': {kernel, bias}})."""
    p = p["Conv_0"]
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _gn(sd, prefix, p):
    p = p["GroupNorm_0"]
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _res_block(sd, prefix, p):
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    _gn(sd, f"{prefix}.norm1", p["GroupNorm32_0"])
    _gn(sd, f"{prefix}.norm2", p["GroupNorm32_1"])
    if "downsample" in p:
        _conv(sd, f"{prefix}.downsample.0", p["downsample"])
        # norm3 is registered twice in the reference (as itself and as
        # downsample.1), so its state_dict carries both names
        _gn(sd, f"{prefix}.norm3", p["GroupNorm32_2"])
        _gn(sd, f"{prefix}.downsample.1", p["GroupNorm32_2"])


def _unet(sd, prefix, p):
    _conv(sd, f"{prefix}.in_ds.0", p["in_conv"])
    _gn(sd, f"{prefix}.in_ds.1", p["GroupNorm32_0"])
    for ours, theirs in (("res1a", "res1.0"), ("res1b", "res1.1"),
                         ("res2a", "res2.0"), ("res2b", "res2.1"),
                         ("res3a", "res3.0"), ("res3b", "res3.1")):
        _res_block(sd, f"{prefix}.{theirs}", p[ours])


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of GPSGaussianModel (the tree `init` returns, with or
    without its top 'params' key; leaves array-like) -> state_dict."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    _unet(sd, "img_encoder", params["img_encoder"])

    raft = params["raft_stereo"]
    cnet = raft["cnet"]
    _res_block(sd, "raft_stereo.cnet.conv2.0", cnet["feat_res"])
    _conv(sd, "raft_stereo.cnet.conv2.1", cnet["feat_out"])
    _res_block(sd, "raft_stereo.cnet.outputs08.0.0", cnet["hidden_res"])
    _conv(sd, "raft_stereo.cnet.outputs08.0.1", cnet["hidden_out"])
    _res_block(sd, "raft_stereo.cnet.outputs08.1.0", cnet["context_res"])
    _conv(sd, "raft_stereo.cnet.outputs08.1.1", cnet["context_out"])
    _conv(sd, "raft_stereo.context_zqr_convs.0", raft["context_zqr"])

    ub = raft["update_block"]
    pre = "raft_stereo.update_module.update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(sd, f"{pre}.encoder.{name}", ub["encoder"][name])
    for name in ("convz", "convr", "convq"):
        _conv(sd, f"{pre}.gru08.{name}", ub["gru08"][name])
    _conv(sd, f"{pre}.flow_head.conv1", ub["flow_head"]["conv1"])
    _conv(sd, f"{pre}.flow_head.conv2", ub["flow_head"]["conv2"])
    _conv(sd, f"{pre}.mask.0", ub["mask_conv1"])
    _conv(sd, f"{pre}.mask.2", ub["mask_conv2"])

    if "gs_regresser" in params:
        gs = params["gs_regresser"]
        g = "gs_parm_regresser"
        _unet(sd, f"{g}.depth_encoder", gs["depth_encoder"])
        for ours, theirs in (("dec3a", "decoder3.0"), ("dec3b", "decoder3.1"),
                             ("dec2a", "decoder2.0"), ("dec2b", "decoder2.1"),
                             ("dec1a", "decoder1.0"),
                             ("dec1b", "decoder1.1")):
            _res_block(sd, f"{g}.{theirs}", gs[ours])
        _conv(sd, f"{g}.out_conv", gs["out_conv"])
        fused = {}
        _conv(fused, "h1", gs["head_conv1"])
        w, b = fused["h1.weight"], fused["h1.bias"]
        hd = w.shape[0] // 3
        for i, (head, conv2) in enumerate(
                (("rot_head", "rot_conv2"), ("scale_head", "scale_conv2"),
                 ("opacity_head", "opacity_conv2"))):
            sd[f"{g}.{head}.0.weight"] = w[i * hd:(i + 1) * hd]
            sd[f"{g}.{head}.0.bias"] = b[i * hd:(i + 1) * hd]
            _conv(sd, f"{g}.{head}.2", gs[conv2])

    return {k: torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in sd.items()}
