"""The numbers that decide `correct`: what the timed path produced against
what the plain reference works out again from the same inputs.

Serving, per checked frame (a sample drawn from the seed, its last pass in
the window): the rectified stereo inputs the dataset returned and the
frame's Gaussians, each against the reference's own; every image the entry
returned and the drop counters of every view against the reference's
rendering of the program's own Gaussians, so that the rasterizer and the
copy are held exactly whatever rounding the network carries; and every
image against the reference's own, end to end. Training, over the first
three steps of the object the window drives: each step's loss, the first
step's gradient as the optimizer got it (leaf by leaf and whole), the
parameters' change after three steps, and each step's drop counters.

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
# a Gaussian row is far off in a field where some channel differs by more
# than this share of the reference's mean |value| of that field: the least
# share of a grid (0.01, 0.02, 0.05, ..., 2) that no row passed in sound
# runs and sound variants on the card (the network's smallest outputs, the
# sizes, swing by more than their mean under a reordered sum)
FAR_SHARE = {"xyz": 0.01, "rot": 0.05, "scale": 2.0, "opacity": 0.05,
             "rgb": 0.01}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def serve_numbers(prog: List[dict], ref: List[dict],
                  redrawn: List[List[dict]]) -> Dict[str, float]:
    """Each frame: {"rect": {"lmain", "rmain"} numpy images, "gauss":
    {field: (N, c) tensor, "valid": (N,)}, "views": [{"image": (H, W, 3)
    numpy, "drops": int}]}, program and reference alike; `redrawn` holds,
    for each frame, the reference's views of the program's own Gaussians.

    rect_err   share of rectified source values that differ by more than
               one 8-bit level (2/255 on the [-1, 1] scale)
    valid_frac share of Gaussian rows valid on one side only
    gauss_err  largest over fields of the mean |difference| on rows valid
               on both sides, over the reference's mean |value| there
    gauss_far  largest over fields of the share of rows valid on both
               sides that are far off in it (FAR_SHARE): a fault confined
               to a region, which the mean hides
    image_mad  largest over views of the mean |difference| of an image
               from the reference's rendering of the same Gaussians
    image_bad  largest over views of the share of pixels that differ from
               it by more than 1/255 in some channel
    drop_gap   largest over views of |drops - its drops| over
               max(its drops, 1)
    view_mad, view_bad  image_mad and image_bad against the reference's
               own images, end to end (network and rasterizer together)
    """
    out = dict.fromkeys(("rect_err", "valid_frac", "gauss_err", "gauss_far",
                         "image_mad", "image_bad", "drop_gap", "view_mad",
                         "view_bad"), 0.0)

    def images(a, b, mad, bad):
        diff = np.abs(a - b)
        out[mad] = max(out[mad], float(diff.mean()))
        out[bad] = max(out[bad], float(
            (diff.max(axis=-1) > 1.0 / 255.0).mean()))

    for p, r, d in zip(prog, ref, redrawn, strict=True):
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
                diff, scale = (a - b).abs(), b.abs().mean().clamp_min(1e-30)
                out["gauss_err"] = max(out["gauss_err"],
                                       float(diff.mean() / scale))
                far = diff.amax(dim=-1) > FAR_SHARE[f] * scale
                out["gauss_far"] = max(out["gauss_far"],
                                       float(far.float().mean()))
        for pv_, rv_, dv in zip(p["views"], r["views"], d, strict=True):
            images(pv_["image"], dv["image"], "image_mad", "image_bad")
            images(pv_["image"], rv_["image"], "view_mad", "view_bad")
            out["drop_gap"] = max(out["drop_gap"],
                                  _rel(pv_["drops"], dv["drops"]))
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys) -> List[float]:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each side: {"losses": [3 floats], "grads": {leaf: the first step's
    gradient as the optimizer got it, a host tensor}, "grad_norms": {leaf:
    its norm}, "change_norms": {leaf: norm of the change after the three
    steps}, "drops": [drops of each step] (stage 2)}.

    loss_gap    largest over steps of |loss - reference loss| over
                |reference loss|
    loss_gap1   the same at the first step alone (before any update)
    grad_gap    worst leaf: |norm - reference norm| over the larger of the
                reference's norm of that leaf and of the median leaf
    grad_med    the median leaf's gap of the same measure
    grad_diff   norm of the difference of the whole gradients (every
                leaf at once) over the reference's norm: direction as
                well as size
    grad_half   |the program's departure from the reference's gradient,
                projected on the departure that the first batch's first
                half alone makes (the reference's "half_grads")| over that
                departure's length: 0 where sound, 1 where the loss or the
                batch leaves out either half
    change_gap  the same for the change, over the leaves whose reference
                gradient is at least ZERO_GRAD_SHARE of the median leaf's
    change_med  the median leaf's gap of the change
    drop_gap    largest over steps of |drops - reference drops| over
                max(reference drops, 1)
    drop_gap1   the same at the first step alone
    """
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(prog["losses"], ref["losses"], strict=True)]
    out = {"loss_gap": max(gaps), "loss_gap1": gaps[0]}
    keys = sorted(ref["grad_norms"])
    gaps = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], keys)
    out["grad_gap"], out["grad_med"] = max(gaps), statistics.median(gaps)
    diff = sum(float((prog["grads"][k].double() - ref["grads"][k].double())
                     .square().sum()) for k in ref["grads"])
    whole = sum(float(g.double().square().sum())
                for g in ref["grads"].values())
    out["grad_diff"] = (diff / max(whole, 1e-60)) ** 0.5
    if "half_grads" in ref:
        along = length = 0.0
        for k, g in ref["grads"].items():
            d = ref["half_grads"][k].double() - g.double()
            along += float((d * (prog["grads"][k].double() - g.double()))
                           .sum())
            length += float(d.square().sum())
        out["grad_half"] = abs(along) / max(length, 1e-60)
    still = set(zero_grad_leaves(ref))
    gaps = _leaf_gaps(prog["change_norms"], ref["change_norms"],
                      [k for k in keys if k not in still])
    out["change_gap"], out["change_med"] = max(gaps), statistics.median(gaps)
    if "drops" in ref:
        gaps = [_rel(a, b) for a, b in
                zip(prog["drops"], ref["drops"], strict=True)]
        out["drop_gap"], out["drop_gap1"] = max(gaps), gaps[0]
    return out


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaves that set grad_gap and change_gap (for the calibration's
    record)."""
    out = {}
    still = set(zero_grad_leaves(ref))
    for name, key in (("grad", "grad_norms"), ("change", "change_norms")):
        keys = [k for k in sorted(ref["grad_norms"])
                if name == "grad" or k not in still]
        gaps = _leaf_gaps(prog[key], ref[key], keys)
        out[name] = keys[max(range(len(keys)), key=gaps.__getitem__)]
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
