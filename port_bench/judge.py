"""The numbers that decide `correct`: what the timed path produced against
what the plain reference works out again from the same inputs.

Serving, per checked frame (a sample drawn from the seed, its last pass in
the window): the rectified stereo inputs the dataset returned, the frame's
Gaussians, every image the entry returned and the drop counters of every
view. Training, over the first three steps of the object the window drives:
each step's loss, the first step's gradient as the optimizer got it, the
parameters' change after three steps, and the first step's drop counters.

Every number reads 0 where the two agree exactly and grows with the gap;
the cell's workload file gives each compared number its limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

GAUSS_FIELDS = ("xyz", "rot", "scale", "opacity", "rgb")
# one 8-bit level of a source image on the network's [-1, 1] scale: a
# remap that rounds one tie the other way differs by this much, no more
RECT_LEVEL = 2.0 / 255.0 + 1e-6
# a leaf whose reference gradient norm lies under this share of the median
# leaf's moves under Adam by round-off alone; it is left out of the change
ZERO_GRAD_SHARE = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def serve_numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """Each frame: {"rect": {"lmain", "rmain"} numpy images, "gauss":
    {field: (N, c) tensor, "valid": (N,)}, "views": [{"image": (H, W, 3)
    numpy, "drops": int}]}, program and reference alike.

    rect_err   share of rectified source values that differ by more than
               one 8-bit level (2/255 on the [-1, 1] scale)
    valid_frac share of Gaussian rows valid on one side only
    gauss_err  largest over fields of the mean |difference| on rows valid
               on both sides, over the reference's mean |value| there
    image_mad  largest over views of the mean |difference| of an image
    image_bad  largest over views of the share of pixels that differ by
               more than 1/255 in some channel
    drop_gap   largest over views of |drops - reference drops| over
               max(reference drops, 1)
    """
    out = dict.fromkeys(("rect_err", "valid_frac", "gauss_err", "image_mad",
                         "image_bad", "drop_gap"), 0.0)
    for p, r in zip(prog, ref, strict=True):
        for v in ("lmain", "rmain"):
            out["rect_err"] = max(out["rect_err"], float(
                (np.abs(p["rect"][v] - r["rect"][v]) > RECT_LEVEL).mean()))
        pv, rv = p["gauss"]["valid"] > 0.5, r["gauss"]["valid"] > 0.5
        out["valid_frac"] = max(out["valid_frac"],
                                float((pv != rv).float().mean()))
        both = pv & rv
        if bool(both.any()):
            for f in GAUSS_FIELDS:
                a = p["gauss"][f][both].float()
                b = r["gauss"][f][both].float()
                err = float((a - b).abs().mean()
                            / b.abs().mean().clamp_min(1e-30))
                out["gauss_err"] = max(out["gauss_err"], err)
        for pv_, rv_ in zip(p["views"], r["views"], strict=True):
            diff = np.abs(pv_["image"] - rv_["image"])
            out["image_mad"] = max(out["image_mad"], float(diff.mean()))
            out["image_bad"] = max(out["image_bad"], float(
                (diff.max(axis=-1) > 1.0 / 255.0).mean()))
            out["drop_gap"] = max(out["drop_gap"],
                                  _rel(pv_["drops"], rv_["drops"]))
    return out


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each side: {"losses": [3 floats], "grad_norms": {leaf: norm of the
    first step's gradient as the optimizer got it}, "change_norms": {leaf:
    norm of the change after the three steps}, "drops": [drops of each
    step] (stage 2)}.

    loss_gap    largest over steps of |loss - reference loss| over
                |reference loss|
    grad_gap    worst leaf: |norm - reference norm| over the larger of the
                reference's norm of that leaf and of the median leaf
    change_gap  the same for the change, over the leaves whose reference
                gradient is at least ZERO_GRAD_SHARE of the median leaf's
    drop_gap    largest over steps of |drops - reference drops| over
                max(reference drops, 1)
    """
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"], strict=True))}
    keys = sorted(ref["grad_norms"])
    out["grad_gap"] = _leaf_gap(prog["grad_norms"], ref["grad_norms"], keys)
    still = set(zero_grad_leaves(ref))
    out["change_gap"] = _leaf_gap(prog["change_norms"], ref["change_norms"],
                                  [k for k in keys if k not in still])
    if "drops" in ref:
        out["drop_gap"] = max(_rel(a, b) for a, b in
                              zip(prog["drops"], ref["drops"], strict=True))
    return out


def zero_grad_leaves(ref: dict) -> List[str]:
    """The leaves `train_numbers` leaves out of the change."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return sorted(k for k, v in g.items() if v < ZERO_GRAD_SHARE * med)


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every number the cell compares."""
    return {k: {"value": float(numbers[k]), "limit": float(v)}
            for k, v in limits.items()}


def passed(checked: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def gauss_dict(g) -> Dict[str, torch.Tensor]:
    """Batch-1 FlatGaussians (either side's container) as (N, c) fields."""
    out = {f: getattr(g, f)[0].detach() for f in GAUSS_FIELDS}
    out["opacity"] = out["opacity"].reshape(-1, 1)
    out["valid"] = g.valid[0].detach().reshape(-1)
    return out
