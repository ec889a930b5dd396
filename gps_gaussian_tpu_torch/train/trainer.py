"""The two training stages' steps: stage 1 trains disparity only, stage 2
trains end to end through the differentiable rasterizer with the loss
flow_weight * flow + l1_weight * L1 + ssim_weight * (1 - SSIM).

Counterpart of gps_gaussian_tpu/train/trainer.py: `make_model` :34,
`make_raster_config` :48, `render_novel` :57, `drop_metrics` :67,
`_stacked_flow_gt` :78, `make_train_step` :84 and `make_eval_step` :192.
Convolutions compute in bf16 under raft.mixed_precision; parameters, losses
and the optimizer stay f32. Not ported yet: the `Trainer` class (loaders,
logging, checkpoint cadence, the eval sweep) and the stage-1 point-splat
preview, so the stage-1 eval step returns no image.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize)
from gps_gaussian_tpu_torch.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu_torch.train import losses
from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.train.state import TrainState
from gps_gaussian_tpu_torch.utils.containers import NovelView, StereoSample
from gps_gaussian_tpu_torch.utils.device import resolve_device


def make_model(cfg: Config, with_gs: bool) -> GPSGaussianModel:
    """The model of `cfg`; under raft.mixed_precision its convolutions
    compute in bf16 while parameters, norms, gates and heads stay f32."""
    return GPSGaussianModel(
        encoder_dims=tuple(cfg.raft.encoder_dims),
        hidden_dim=cfg.raft.hidden_dims[2],
        context_dim=cfg.raft.hidden_dims[2],
        corr_levels=cfg.raft.corr_levels,
        corr_radius=cfg.raft.corr_radius,
        gsnet_encoder_dims=tuple(cfg.gsnet.encoder_dims),
        gsnet_decoder_dims=tuple(cfg.gsnet.decoder_dims),
        gsnet_head_dim=cfg.gsnet.parm_head_dim,
        with_gs=with_gs,
        compute_dtype=torch.bfloat16 if cfg.raft.mixed_precision else None)


def make_raster_config(cfg: Config) -> RasterizeConfig:
    return RasterizeConfig(
        max_tiles_per_gaussian=cfg.raster.max_tiles_per_gaussian,
        max_per_tile=cfg.raster.max_per_tile,
        fg_cap=cfg.raster.fg_cap,
        pair_budget=cfg.raster.pair_budget)


def render_novel(out, novel: NovelView, bg_color, rcfg: RasterizeConfig,
                 device="cuda"):
    """Splat both views' pixel-aligned Gaussians into the novel camera.
    Returns (images, RasterizeAux)."""
    gauss = out.lmain_gs.flatten().concat(out.rmain_gs.flatten())
    return rasterize(gauss, novel.camera, bg_color, rcfg, device=device)


def drop_metrics(aux, prefix: str = "") -> dict:
    """Batch-summed capacity-cap drop counters as float metrics."""
    return {
        f"{prefix}num_dropped": aux.num_dropped.sum().float(),
        f"{prefix}num_fg_dropped": aux.num_fg_dropped.sum().float(),
        f"{prefix}num_pair_dropped": aux.num_pair_dropped.sum().float(),
    }


def _stacked_flow_gt(batch: StereoSample):
    flow = torch.cat([batch.lmain.flow, batch.rmain.flow], dim=0)
    valid = torch.cat([batch.lmain.valid, batch.rmain.valid], dim=0)
    return flow, valid


def _check_placement(model, dev) -> None:
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"the model is on {where}, the step runs on {dev}: "
                         "build the state with create_state(cfg, model, "
                         "device)")


def make_train_step(model: GPSGaussianModel, cfg: Config, stage: str,
                    rcfg: RasterizeConfig, state: TrainState,
                    device="cuda"):
    """One optimizer step on an in-memory batch.

    Returns `train_step(batch, mark=None) -> metrics`: forward, loss,
    backward, clipping and the update of `state` (in place). Model and
    batch live on `device`, CUDA unless the caller asks for the CPU.
    `mark(name)`, when given, is called after the "forward", "backward" and
    "optimizer" parts, so that a caller can time them. Metrics are detached
    scalars on the device. `train_step.loss_fn(batch) -> (loss, metrics)` is
    the step's differentiable part alone, for checks of its gradients."""
    dev = resolve_device(device)
    _check_placement(model, dev)
    bg = torch.tensor(cfg.dataset.bg_color, dtype=torch.float32, device=dev)

    def run_model(batch):
        return model(batch, iters=cfg.raft.train_iters)

    def apply_model(batch):
        if cfg.remat:
            # recompute the model's activations in the backward instead of
            # keeping them (memory for operations at high resolution)
            return checkpoint(run_model, batch, use_reentrant=False)
        return run_model(batch)

    def loss_fn(batch: StereoSample):
        out = apply_model(batch)
        if stage == "stage1":
            flow_gt, valid = _stacked_flow_gt(batch)
            return losses.sequence_loss(out.flow_preds, flow_gt, valid)
        img_pred, raux = render_novel(out, batch.novel, bg, rcfg, device=dev)
        img_gt = batch.novel.img
        l1 = losses.l1_loss(img_pred, img_gt)
        ssim_val = losses.ssim(img_pred, img_gt)
        total = cfg.l1_weight * l1 + cfg.ssim_weight * (1.0 - ssim_val)
        metrics = dict(l1=l1, ssim=ssim_val, **drop_metrics(raux))
        # flow_weight 0: the flow branch leaves the step entirely, loss and
        # metrics both; the gradient program is exactly the loss
        if cfg.flow_weight != 0.0:
            flow_gt, valid = _stacked_flow_gt(batch)
            flow_loss, fmetrics = losses.sequence_loss(
                out.flow_preds, flow_gt, valid)
            total = total + cfg.flow_weight * flow_loss
            metrics = dict(metrics, flow_loss=flow_loss, **fmetrics)
        return total, metrics

    def train_step(batch: StereoSample,
                   mark: Optional[Callable[[str], None]] = None) -> dict:
        mark = mark or (lambda name: None)
        batch = batch.to(dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        mark("forward")
        loss.backward()
        mark("backward")
        grad_norm = state.apply_gradients()
        mark("optimizer")
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    return train_step


def make_eval_step(model: GPSGaussianModel, cfg: Config, stage: str,
                   rcfg: RasterizeConfig, device="cuda"):
    """Returns `eval_step(batch, weight) -> (metrics, img_pred)`.

    `weight` (B,) f32 masks samples out of the means. Every metric is a
    (numerator, denominator) pair, so that sums over batches stay exact
    under any weights. Stage 2 also renders the novel view; stage 1
    returns None for the image."""
    dev = resolve_device(device)
    _check_placement(model, dev)
    bg = torch.tensor(cfg.dataset.bg_color, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def eval_step(batch: StereoSample, weight: torch.Tensor):
        batch = batch.to(dev)
        weight = weight.to(dev)
        out = model(batch, iters=cfg.raft.val_iters, test_mode=True)
        flow_gt, valid = _stacked_flow_gt(batch)
        epe = torch.sqrt(((out.final_flow - flow_gt) ** 2).sum(-1))
        w2 = torch.cat([weight, weight])[:, None, None]
        vm = (valid >= 0.5).float()[..., 0] * w2
        metrics = {
            "val_epe": ((epe * vm).sum(), vm.sum()),
            "val_1px": (((epe < 1).float() * vm).sum(), vm.sum()),
        }
        img_pred = None
        if stage == "stage2":
            img_pred, raux = render_novel(out, batch.novel, bg, rcfg,
                                          device=dev)
            metrics["val_psnr"] = (
                (losses.psnr(img_pred, batch.novel.img) * weight).sum(),
                weight.sum())
            one = torch.ones((), dtype=torch.float32, device=dev)
            metrics.update({k: (v, one) for k, v in
                            drop_metrics(raux, prefix="val_").items()})
        return metrics, img_pred

    return eval_step
