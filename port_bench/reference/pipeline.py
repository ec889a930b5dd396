"""The plain reference's paths, end to end, for the comparison that decides
`correct`: a test sample read from the files and rectified online, the
frame's Gaussians, a novel view rendered under the configuration's caps,
and training steps (loss, gradient, AdamW).

Each piece follows the port at commit 19aea69 (named beside it) in plain
PyTorch and NumPy over the frozen copies in this package; nothing here
imports the program, and nothing takes what the program made.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from port_bench.reference import cameras, losses, stereo
from port_bench.reference.containers import (NovelCamera, NovelView,
                                             SourceView, StereoSample)
from port_bench.reference.gps_gaussian import GPSGaussianModel
from port_bench.reference.raster import (RasterizeConfig, compact_valid,
                                         rasterize)

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _exact_f32() -> None:
    """The reference computes f32 as f32 (the port turns TF32 off too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- dataset
# data/thuman.py `load_view`, `_build_rectified(need_flow=False)` and
# `get_test_sample`; the remap is csrc/host/image_ops.cpp
# `remap_bilinear_f32` in NumPy

def _read(path) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path))


def _view(root: Path, scan: str, vid: int):
    img = _read(root / "img" / scan / f"{vid}.jpg")
    mask = _read(root / "mask" / scan / f"{vid}.png")
    if mask.ndim == 3:
        mask = mask[..., 0]
    intr = np.load(root / "parm" / scan / f"{vid}_intrinsic.npy")
    extr = np.load(root / "parm" / scan / f"{vid}_extrinsic.npy")
    return img, mask, intr, extr


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap with a zero border (cv2.remap INTER_LINEAR): each
    output the sum, in f32, of the four taps in the order (y0, x0),
    (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1), each weighted tap fused
    into the sum (rounded once, as a fused multiply-add rounds); integer
    images are rounded to the nearest level."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    src = (img[..., None] if squeeze else img).astype(np.float32)
    h, w, c = src.shape
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    fx0, fy0 = np.floor(mx), np.floor(my)
    x0, y0 = fx0.astype(np.int64), fy0.astype(np.int64)
    ax, ay = mx - fx0, my - fy0
    one = np.float32(1.0)
    out = np.zeros(mx.shape + (c,), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            wgt = (ax if dx else one - ax) * (ay if dy else one - ay)
            tap = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            fused = (wgt[..., None].astype(np.float64) * tap
                     + out).astype(np.float32)
            out = np.where(inside[..., None], fused, out)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out


def test_sample(root, scan: str, source_ids: Sequence[int] = (0, 1)) -> dict:
    """One online-rectified inference sample, as numpy arrays, with the
    original source cameras for novel-pose interpolation."""
    root = Path(root)
    s0, s1 = source_ids
    img0, mask0, intr0, extr0 = _view(root, scan, s0)
    img1, mask1, intr1, extr1 = _view(root, scan, s1)
    size = (img0.shape[1], img0.shape[0])
    cam, map0, map1 = stereo.rectify_stereo_pair(intr0, extr0, intr1, extr1,
                                                 size)
    rect = {"img0": remap_bilinear(img0, *map0),
            "img1": remap_bilinear(img1, *map1),
            "mask0": remap_bilinear(mask0.astype(np.float32), *map0),
            "mask1": remap_bilinear(mask1.astype(np.float32), *map1)}
    sample = {"name": scan}
    for k, view in enumerate(("lmain", "rmain")):
        img = rect[f"img{k}"].astype(np.float32) / 255.0
        mask = rect[f"mask{k}"].astype(np.float32) / 255.0
        mask_bin = (mask >= 0.5).astype(np.float32)
        img = (2.0 * img - 1.0) * mask[..., None]
        tf_x = np.float32(cam["tf_x"])
        sample[view] = {
            "img": img, "mask": mask_bin[..., None],
            "intr": np.asarray(cam[f"intr{k}"], np.float32),
            "ref_intr": np.asarray(cam[f"intr{1 - k}"], np.float32),
            "extr": np.asarray(cam[f"extr{k}"], np.float32),
            "tf_x": tf_x if k == 0 else -tf_x,
        }
    sample["intr_ori"] = (np.asarray(intr0, np.float32),
                          np.asarray(intr1, np.float32))
    sample["extr_ori"] = (np.asarray(extr0, np.float32),
                          np.asarray(extr1, np.float32))
    return sample


def stereo_batch(sample: dict, device) -> StereoSample:
    """A batch of one sample (data/loader.py `collate`) on `device`."""
    def view(d):
        return SourceView(**{k: torch.as_tensor(np.asarray(d[k])[None],
                                                device=device)
                             for k in ("img", "mask", "intr", "ref_intr",
                                       "extr", "tf_x")})
    return StereoSample(lmain=view(sample["lmain"]),
                        rmain=view(sample["rmain"]))


# ------------------------------------------------------------------- model
# train/trainer.py `make_model`, `make_raster_config`

def build_model(recipe: dict, with_gs: bool,
                device="cpu") -> GPSGaussianModel:
    raft, gsnet = recipe["raft"], recipe.get("gsnet", {})
    return GPSGaussianModel(
        encoder_dims=tuple(raft["encoder_dims"]),
        hidden_dim=raft["hidden_dims"][2],
        context_dim=raft["hidden_dims"][2],
        corr_levels=raft.get("corr_levels", 4),
        corr_radius=raft.get("corr_radius", 4),
        gsnet_encoder_dims=tuple(gsnet.get("encoder_dims", (32, 48, 96))),
        gsnet_decoder_dims=tuple(gsnet.get("decoder_dims", (48, 64, 96))),
        gsnet_head_dim=gsnet.get("parm_head_dim", 32),
        with_gs=with_gs,
        compute_dtype=torch.bfloat16 if raft["mixed_precision"] else None,
    ).to(device)


def raster_config(recipe: dict) -> RasterizeConfig:
    r = recipe["raster"]
    return RasterizeConfig(max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
                           max_per_tile=r["max_per_tile"],
                           fg_cap=r.get("fg_cap"),
                           pair_budget=r.get("pair_budget"))


def load_params(path) -> dict:
    """The `params` state_dict of a checkpoint file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


# ----------------------------------------------------------------- serving
# infer/freeview.py `gaussians`, `render`, `novel_camera_at`

@torch.no_grad()
def frame_gaussians(model: GPSGaussianModel, batch: StereoSample,
                    iters: int, fg_cap: Optional[int]):
    """The frame's Gaussians of both views, compacted to fg_cap rows."""
    _exact_f32()
    out = model(batch, iters=iters, test_mode=True)
    gauss = out.lmain_gs.flatten().concat(out.rmain_gs.flatten())
    return gauss if fg_cap is None else compact_valid(gauss, fg_cap)[0]


def novel_camera(sample: dict, ratio: float, res: int, hr_scale: float,
                 znear: float, zfar: float, device) -> NovelCamera:
    intr0, intr1 = sample["intr_ori"]
    extr0, extr1 = sample["extr_ori"]
    cam, _, _ = cameras.interpolated_novel_camera(
        intr0, extr0, intr1, extr1, ratio, res, res, hr_scale=hr_scale,
        znear=znear, zfar=zfar)
    return cameras.make_novel_camera([cam], res, res, device=device)


@torch.no_grad()
def render_view(gauss, camera: NovelCamera, bg, rcfg: RasterizeConfig):
    """(image (H, W, 3) in [0, 1] as numpy, pairs the caps dropped)."""
    img, aux = rasterize(gauss, camera, bg,
                         dataclasses.replace(rcfg, fg_cap=None),
                         device=gauss.xyz.device)
    drops = int(aux.num_dropped.sum() + aux.num_fg_dropped.sum()
                + aux.num_pair_dropped.sum())
    return img[0].clamp(0, 1).cpu().numpy(), drops


# ---------------------------------------------------------------- training
# train/trainer.py `make_train_step` (loss_fn), train/state.py (AdamW, the
# one-cycle schedule, clipping)

def onecycle_linear(peak_lr: float, total_steps: int, pct_start: float = 0.01,
                    div_factor: float = 25.0, final_div_factor: float = 1e4):
    up = max(int(total_steps * pct_start), 1)
    init = peak_lr / div_factor
    final = init / final_div_factor
    down = total_steps - up

    def schedule(step: int) -> float:
        if step < up:
            return init + (peak_lr - init) * (step / up)
        return peak_lr + (final - peak_lr) * (min(step - up, down) / down)

    return schedule


def learning_rate(recipe: dict, step: int) -> float:
    if recipe.get("scheduler", "onecycle") == "constant":
        return recipe["lr"]
    total = recipe.get("scheduler_steps") or recipe["num_steps"] + 100
    return onecycle_linear(recipe["lr"], total)(step)


def step_loss(model: GPSGaussianModel, batch: StereoSample, recipe: dict,
              stage: str, loss_rows: Optional[int] = None):
    """(loss, metrics) of one training batch. `loss_rows` (a planted
    fault) takes the loss over the batch's first `loss_rows` samples alone,
    while the forward and the render run over all of them."""
    out = model(batch, iters=recipe["raft"]["train_iters"])
    flow_gt = torch.cat([batch.lmain.flow, batch.rmain.flow], dim=0)
    valid = torch.cat([batch.lmain.valid, batch.rmain.valid], dim=0)
    preds = out.flow_preds
    if loss_rows is not None:
        # flow stacks the left views over the right views
        b = batch.lmain.flow.shape[0]
        rows = torch.cat([torch.arange(loss_rows),
                          b + torch.arange(loss_rows)]).to(flow_gt.device)
        preds = [p[rows] for p in preds]
        flow_gt, valid = flow_gt[rows], valid[rows]
    if stage == "stage1":
        return losses.sequence_loss(preds, flow_gt, valid)
    bg = torch.zeros(3, dtype=torch.float32, device=flow_gt.device)
    gauss = out.lmain_gs.flatten().concat(out.rmain_gs.flatten())
    img, aux = rasterize(gauss, batch.novel.camera, bg, raster_config(recipe),
                         device=flow_gt.device)
    target = batch.novel.img
    if loss_rows is not None:
        img, target = img[:loss_rows], target[:loss_rows]
    l1 = losses.l1_loss(img, target)
    ssim_val = losses.ssim(img, target)
    w = {k: recipe.get(k, d) for k, d in (("flow_weight", 1.0),
                                          ("l1_weight", 0.8),
                                          ("ssim_weight", 0.2))}
    total = w["l1_weight"] * l1 + w["ssim_weight"] * (1.0 - ssim_val)
    metrics = {"l1": l1, "ssim": ssim_val,
               "num_dropped": aux.num_dropped.sum().float(),
               "num_fg_dropped": aux.num_fg_dropped.sum().float(),
               "num_pair_dropped": aux.num_pair_dropped.sum().float()}
    if w["flow_weight"] != 0.0:
        flow_loss, fm = losses.sequence_loss(preds, flow_gt, valid)
        total = total + w["flow_weight"] * flow_loss
        metrics.update(flow_loss=flow_loss, **fm)
    return total, metrics


def _clip_coef(grads: dict, clip: float) -> torch.Tensor:
    """The factor that clips the global norm of `grads` to `clip`."""
    total = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    return torch.clamp_max(clip / (total + 1e-6), 1.0)


def first_gradient(model: GPSGaussianModel, batch: StereoSample,
                   recipe: dict, stage: str) -> dict:
    """{name: the clipped gradient `train_steps` would take its first step
    with on `batch`, on the host}; the model's parameters are left as they
    were."""
    _exact_f32()
    model.zero_grad(set_to_none=True)
    loss, _ = step_loss(model, batch, recipe, stage)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    coef = _clip_coef(grads, recipe.get("grad_clip", 1.0))
    out = {k: (g * coef).float().cpu() for k, g in grads.items()}
    model.zero_grad(set_to_none=True)
    return out


def train_steps(model: GPSGaussianModel, batches: Sequence[StereoSample],
                recipe: dict, stage: str,
                loss_rows: Optional[int] = None) -> dict:
    """AdamW steps of `model` (in place), one per batch, as the port's
    TrainState takes them: clip the global gradient norm to
    `recipe['grad_clip']`, decoupled weight decay, bias-corrected moments,
    the schedule's rate at steps 0, 1, ...

    Returns {"losses": [...], "metrics": [...], "grads": {name: the first
    step's clipped gradient, on the host}, "grad_norms": {name: its norm},
    "change_norms": {name: norm of the parameters' change over all the
    steps}}. `loss_rows` is step_loss's planted fault."""
    _exact_f32()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    clip = recipe.get("grad_clip", 1.0)
    wd = recipe["wdecay"]
    out = {"losses": [], "metrics": []}
    for t, batch in enumerate(batches, start=1):
        model.zero_grad(set_to_none=True)
        loss, metrics = step_loss(model, batch, recipe, stage, loss_rows)
        loss.backward()
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        coef = _clip_coef(grads, clip)
        lr = learning_rate(recipe, t - 1)
        with torch.no_grad():
            for k, g in grads.items():
                g = g * coef
                p = params[k]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                bc1 = 1.0 - BETAS[0] ** t
                bc2 = 1.0 - BETAS[1] ** t
                denom = (v[k].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
        if t == 1:
            out["grad_norms"] = {k: float(torch.linalg.vector_norm(g * coef))
                                 for k, g in grads.items()}
            out["grads"] = {k: (g * coef).float().cpu()
                            for k, g in grads.items()}
        out["losses"].append(float(loss.detach()))
        out["metrics"].append({k: float(x.detach()) for k, x in
                               metrics.items()})
    out["change_norms"] = {
        k: float(torch.linalg.vector_norm(p.detach() - start[k]))
        for k, p in params.items()}
    return out


def train_batch(tensors: dict, device) -> StereoSample:
    """A reference StereoSample over the benchmark's batch tensors (see
    traffic/silhouette.py)."""
    def view(d):
        return SourceView(**{k: d[k].to(device) for k in d})
    novel = None
    if "novel" in tensors:
        n = tensors["novel"]
        cam = NovelCamera(height=n["height"], width=n["width"],
                          **{k: n["camera"][k].to(device)
                             for k in ("view", "proj", "cam_center",
                                       "tanfovx", "tanfovy")})
        novel = NovelView(camera=cam, img=n["img"].to(device),
                          intr=n["intr"].to(device), extr=n["extr"].to(device))
    return StereoSample(lmain=view(tensors["lmain"]),
                        rmain=view(tensors["rmain"]), novel=novel)
