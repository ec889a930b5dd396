"""The two training stages: stage 1 trains disparity only, stage 2 trains
end to end through the differentiable rasterizer with the loss
flow_weight * flow + l1_weight * L1 + ssim_weight * (1 - SSIM).

Counterpart of gps_gaussian_tpu/train/trainer.py: `make_model` :34,
`make_raster_config` :48, `render_novel` :57, `drop_metrics` :67,
`_stacked_flow_gt` :78, `make_train_step` :84 with the in-step gradient
mean, `make_sharded_train_step` :146, `make_sharded_eval_step` :167,
`make_eval_step` :192 with its stage-1 point-splat preview :196, and the
`Trainer` :254 (loaders, logging, checkpoint cadence, the eval sweep).
Convolutions compute in bf16 under raft.mixed_precision; parameters, losses
and the optimizer stay f32.

Several devices: one process per rank over a torch.distributed group
(train/sharding.py), each on its rows of the global batch. After the
backward the gradients are averaged over the group with one all-reduce of
their flat concatenation (the JAX step's pmean); clipping and AdamW then
run on the mean, so every rank takes the same update. The model is not
wrapped in DistributedDataParallel: checkpoints hold the bare module's
keys, and every parameter of both stages gets a gradient, so no unused-
parameter search is needed.
"""

from __future__ import annotations

import contextlib
import logging
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from gps_gaussian_tpu_torch.data.loader import BatchLoader, eval_batches
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.geometry.pointcloud import (flow_to_inv_depth,
                                                        inv_depth_to_points)
from gps_gaussian_tpu_torch.kernels.point_splat import splat_points
from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize)
from gps_gaussian_tpu_torch.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.train import losses, sharding
from gps_gaussian_tpu_torch.train import state as state_lib
from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.train.state import TrainState
from gps_gaussian_tpu_torch.utils.containers import NovelView, StereoSample
from gps_gaussian_tpu_torch.utils.device import resolve_device
from gps_gaussian_tpu_torch.utils.images import write_image
from gps_gaussian_tpu_torch.utils.profiling import StepTimer, maybe_trace

log = logging.getLogger("gps_tpu_torch.train")


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


def average_gradients(params, group: sharding.Group) -> None:
    """Replace every gradient by its mean over `group`: one all-reduce of
    the gradients' flat concatenation. Every rank must hold gradients for
    the same parameters (the step's graph is the same on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= sharding.world_size(group)
    for g, mean in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(mean.view_as(g))


def reduce_metrics(metrics: dict, group: sharding.Group) -> dict:
    """Metrics over `group`: drop counters (batch sums) summed, everything
    else (batch means) averaged, with one all-reduce (JAX :136-139)."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, group=group)
    world = sharding.world_size(group)
    return {k: v if "drop" in k else v / world for k, v in zip(keys, vals)}


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
                    device="cuda", group: sharding.Group = None):
    """One optimizer step on an in-memory batch.

    Returns `train_step(batch, mark=None) -> metrics`: forward, loss,
    backward, clipping and the update of `state` (in place). Model and
    batch live on `device`, CUDA unless the caller asks for the CPU. With a
    `group`, `batch` is this rank's rows: the gradients are averaged over
    the group before clipping and the metrics reduced (`reduce_metrics`),
    so every rank returns the same metrics and takes the same update.
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
        average_gradients(model.parameters(), group)
        mark("backward")
        grad_norm = state.apply_gradients()
        mark("optimizer")
        metrics = reduce_metrics(dict(metrics, loss=loss), group)
        metrics = dict(metrics, grad_norm=grad_norm)
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    return train_step


def make_sharded_train_step(model: GPSGaussianModel, cfg: Config,
                            stage: str, rcfg: RasterizeConfig,
                            state: TrainState, group: sharding.Group,
                            device="cuda"):
    """The data-parallel step (JAX :146): `make_train_step` over `group`,
    each rank on its rows of the batch. For equal shares it takes the
    update of the one-process step on the whole batch, up to the means of
    valid-masked metrics, which are per-rank means averaged."""
    return make_train_step(model, cfg, stage, rcfg, state, device, group)


def stage1_preview(batch: StereoSample, flow_up: torch.Tensor):
    """Point-splat both views' predicted geometry into the novel camera (the
    reference's Taichi preview): (B, H, W, 3) in [0, 1]. `flow_up` stacks
    the left views' flow over the right views'."""
    bs = batch.lmain.img.shape[0]
    pts, rgbs, valids = [], [], []
    for i, view in enumerate((batch.lmain, batch.rmain)):
        flow_v = flow_up[i * bs:(i + 1) * bs]
        inv_d = flow_to_inv_depth(flow_v, view.intr, view.ref_intr,
                                  view.tf_x, view.mask)
        xyz = inv_depth_to_points(inv_d[..., 0], view.extr, view.intr)
        pts.append(xyz.reshape(bs, -1, 3))
        rgbs.append((view.img * 0.5 + 0.5).reshape(bs, -1, 3))
        valids.append((inv_d[..., 0] != 0).float().reshape(bs, -1))
    cam = batch.novel.camera
    return splat_points(torch.cat(pts, 1), torch.cat(rgbs, 1),
                        torch.cat(valids, 1), batch.novel.intr,
                        batch.novel.extr, cam.height, cam.width)


def make_eval_step(model: GPSGaussianModel, cfg: Config, stage: str,
                   rcfg: RasterizeConfig, device="cuda",
                   counts_batch: bool = True):
    """Returns `eval_step(batch, weight) -> (metrics, img_pred)`.

    `weight` (B,) f32 masks samples out of the means. Every metric is a
    (numerator, denominator) pair, so that sums over batches stay exact
    under any weights. Stage 2 renders the novel view; stage 1 returns the
    point-splat preview when the batch has a novel view, else None.

    A drop counter is (the batch's drops, 1): its ratio over a sweep is the
    mean drops per batch, every row counted whatever its weight. Where
    several steps share one batch (one per rank), only the step with
    `counts_batch` contributes the 1."""
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
            one = torch.tensor(float(counts_batch), device=dev)
            metrics.update({k: (v, one) for k, v in
                            drop_metrics(raux, prefix="val_").items()})
        elif batch.novel is not None:
            img_pred = stage1_preview(batch, out.final_flow)
        return metrics, img_pred

    return eval_step


def make_sharded_eval_step(model: GPSGaussianModel, cfg: Config,
                           stage: str, rcfg: RasterizeConfig,
                           group: sharding.Group, device="cuda"):
    """`make_eval_step` on this rank's rows, with every (numerator,
    denominator) pair summed over `group` (JAX :167-189), so each rank sees
    the global weighted ratio. Every rank adds its rows' drops, and rank 0
    alone counts the batch, so a drop counter stays the mean drops per
    batch (JAX counts the batch once per device). The image is this rank's
    rows."""
    if group is None:
        return make_eval_step(model, cfg, stage, rcfg, device)
    base = make_eval_step(model, cfg, stage, rcfg, device,
                          counts_batch=dist.get_rank(group) == 0)

    def eval_step(batch: StereoSample, weight: torch.Tensor):
        metrics, img_pred = base(batch, weight)
        keys = sorted(metrics)
        vals = torch.stack([torch.stack([metrics[k][0].float(),
                                         metrics[k][1].float()])
                            for k in keys])
        dist.all_reduce(vals, group=group)
        return {k: (v[0], v[1]) for k, v in zip(keys, vals)}, img_pred

    return eval_step


class Trainer:
    """Runs an experiment: loaders, steps, logging, checkpoints, the eval
    sweep. Runs on `device`, CUDA unless the caller asks for the CPU.

    The model is initialised from `torch.Generator().manual_seed(cfg.seed)`
    (no batch is needed, so the loader's data order starts at its first
    batch); stage 2 then warm-starts from `cfg.stage1_ckpt` (a run
    directory of `ckpt_<step>.pt` files or one file; `n_restored` counts
    the tensors copied), and `cfg.restore_ckpt` resumes a run with its
    optimizer, scheduler and step.

    With a torch.distributed `group` of several ranks (every rank builds
    its Trainer with the same config and datasets), each rank draws the
    batch sequence of a one-process run and trains on its rows of each
    batch, with the gradients averaged over the group; the global batch is
    cfg.batch_size, which the number of ranks must divide. Rank 0 alone
    writes checkpoints, logs and previews, and the group waits for each
    write. Checkpoints hold the bare model's keys, so a run resumes at any
    number of ranks."""

    def __init__(self, cfg: Config, exp_dir: Optional[str] = None,
                 dataset=None, val_dataset=None, device="cuda",
                 group: sharding.Group = None):
        self.cfg = cfg
        self.stage = cfg.stage
        self.device = resolve_device(device)
        self.group = group
        self.is_main = sharding.rank(group) == 0
        # raises unless the ranks divide the batch (JAX :292-297)
        self.rows = sharding.rank_rows(cfg.batch_size, group)
        self.exp_dir = Path(exp_dir or
                            f"{cfg.record.ckpt_path}/{cfg.name}")
        if self.is_main:
            for sub in ("ckpt", "show", "logs"):
                (self.exp_dir / sub).mkdir(parents=True, exist_ok=True)
        sharding.barrier(group)

        ds_cfg = DatasetConfig(
            data_root=cfg.dataset.data_root,
            src_res=cfg.dataset.src_res,
            source_ids=tuple(cfg.dataset.source_id),
            train_novel_ids=tuple(cfg.dataset.train_novel_id),
            val_novel_ids=tuple(cfg.dataset.val_novel_id),
            use_hr_img=cfg.dataset.use_hr_img,
            use_processed_data=cfg.dataset.use_processed_data,
            znear=cfg.dataset.znear, zfar=cfg.dataset.zfar)
        self.train_ds = (dataset if dataset is not None
                         else StereoHumanDataset(ds_cfg, "train"))
        self.val_ds = (val_dataset if val_dataset is not None
                       else StereoHumanDataset(ds_cfg, "val"))

        self.model = make_model(cfg, with_gs=(self.stage == "stage2"))
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed))
        self.n_restored = 0
        if self.stage == "stage2" and cfg.stage1_ckpt:
            self.n_restored = state_lib.restore_params_partial(
                cfg.stage1_ckpt, self.model)
            log.info("stage1 warm start: %d tensors restored",
                     self.n_restored)
        self.state = state_lib.create_state(cfg, self.model, self.device)
        if cfg.restore_ckpt:
            state_lib.restore_checkpoint(cfg.restore_ckpt, self.state)
            log.info("resumed at step %d", self.state.step)
        self.rcfg = make_raster_config(cfg)
        self.train_step = make_train_step(self.model, cfg, self.stage,
                                          self.rcfg, self.state, self.device,
                                          group)
        self.eval_step = make_sharded_eval_step(
            self.model, cfg, self.stage, self.rcfg, group, self.device)

        # built after the model is on the device: worker processes are
        # spawned, never forked from a process that holds a CUDA context
        self.train_loader = BatchLoader(
            self.train_ds, cfg.batch_size, tuple(cfg.dataset.train_novel_id),
            seed=cfg.seed if cfg.loader_seed is None else cfg.loader_seed,
            num_procs=cfg.dataset.num_workers, rows=self.rows)

        self.last_preview = None   # run_eval's first image, numpy
        # every loss_freq steps: the running means, and the latest step's
        # own time and wait for its batch (host clock)
        self.history: list = []
        self.writer = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(str(self.exp_dir / "logs"))
            except Exception:
                pass
            self._snapshot_provenance()

    def _save(self, ckpt_dir: Path) -> Path:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        path = ckpt_dir / f"ckpt_{self.state.step}.pt"
        if self.is_main:
            path = state_lib.save_checkpoint(ckpt_dir, self.state)
        sharding.barrier(self.group)
        return path

    def _snapshot_provenance(self):
        """Record the code's git revision and dirty files with the run."""
        try:
            root = Path(__file__).resolve().parents[2]
            rev = subprocess.run(["git", "-C", str(root), "rev-parse",
                                  "HEAD"], capture_output=True, text=True)
            dirty = subprocess.run(["git", "-C", str(root), "status",
                                    "--porcelain"], capture_output=True,
                                   text=True)
            with open(self.exp_dir / "provenance.txt", "w") as f:
                f.write(f"git: {rev.stdout.strip()}\n")
                f.write(f"dirty files:\n{dirty.stdout}")
        except Exception:
            pass

    def _log_scalars(self, values: dict, step: int):
        if self.writer:
            for k, v in values.items():
                self.writer.add_scalar(k, v, step)

    def train(self, num_steps: Optional[int] = None,
              trace_steps: Optional[tuple] = None,
              trace_dir: Optional[str] = None,
              eval_first: bool = False) -> TrainState:
        """Train to step `num_steps` (cfg.num_steps by default). Running
        means of the metrics are logged, and a checkpoint written, every
        record.loss_freq steps and at the end; the val sweep runs every
        record.eval_freq steps, and once before any update with
        `eval_first`. trace_steps=(lo, hi) writes a torch.profiler trace of
        that step window, rank 0's, to trace_dir/trace_<lo>_<hi>.json
        (default directory <exp>/logs/profile)."""
        cfg = self.cfg
        total = num_steps or cfg.num_steps
        running: dict = {}
        timer = StepTimer(cfg.batch_size, device=self.device)
        wait = StepTimer(cfg.batch_size, device="cpu")
        ckpt_dir = self.exp_dir / "ckpt"
        saved = None
        if eval_first and self.state.step == 0:
            self.run_eval(0)
        trace = contextlib.ExitStack()
        for step in range(self.state.step, total):
            if trace_steps and step == trace_steps[0] and self.is_main:
                trace.enter_context(maybe_trace(
                    trace_dir or self.exp_dir / "logs" / "profile",
                    f"trace_{trace_steps[0]}_{trace_steps[1]}.json"))
            wait.start()
            batch = next(self.train_loader).to(self.device)
            wait.stop()
            timer.start()
            metrics = self.train_step(batch)
            timer.stop()
            if trace_steps and step + 1 == trace_steps[1]:
                trace.close()

            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + float(v)
            if (step + 1) % cfg.record.loss_freq == 0:
                n = cfg.record.loss_freq
                msg = " ".join(f"{k}={v / n:.4f}"
                               for k, v in sorted(running.items()))
                if self.is_main:
                    log.info("step %d: %s (%.2f pairs/s, %.1f ms/step, "
                             "%.1f ms waiting for data)", step + 1, msg,
                             timer.pairs_per_s, timer.step_ms, wait.step_ms)
                self._log_scalars({k: v / n for k, v in running.items()},
                                  step + 1)
                self._log_scalars({"perf/pairs_per_s": timer.pairs_per_s,
                                   "perf/step_ms": timer.step_ms,
                                   "perf/data_wait_ms": wait.step_ms},
                                  step + 1)
                self.history.append(dict(
                    {k: v / n for k, v in running.items()}, step=step + 1,
                    step_ms=timer.last_s * 1e3,
                    data_wait_ms=wait.last_s * 1e3))
                running = {}
                saved = self._save(ckpt_dir)
            if (step + 1) % cfg.record.eval_freq == 0:
                self.run_eval(step + 1)
        trace.close()  # a window that outlasts the run ends with it
        if saved is None or saved.name != f"ckpt_{self.state.step}.pt":
            self._save(ckpt_dir)
        return self.state

    def run_eval(self, step: int, max_batches: Optional[int] = None) -> dict:
        """Deterministic full sweep of the val set (the reference's full val
        loop, not random batches), so val metrics compare run to run.
        PSNR, EPE and 1px are means over the weighted rows; the weight-0
        rows that wrap the last batch count in neither part. A drop counter
        is the mean drops per val batch, as in the JAX package on one
        device: it is not weighted, so the wrapped rows' drops count. Each
        rank evaluates its rows of every batch, every rank adds its drops,
        rank 0 alone counts the batches, and the sums are taken over the
        group, so the result does not depend on the number of ranks. The
        first batch's first image is written to <exp>/show/<step>.jpg when
        an image writer is importable."""
        num_agg: dict = {}
        den_agg: dict = {}
        preview = None
        for batch, weight in eval_batches(
                self.val_ds, self.cfg.batch_size,
                tuple(self.cfg.dataset.val_novel_id),
                max_batches=max_batches
                or self.cfg.dataset.eval_max_batches, rows=self.rows):
            metrics, img_pred = self.eval_step(batch, weight)
            for k, (num, den) in metrics.items():
                num_agg[k] = num_agg.get(k, 0.0) + float(num)
                den_agg[k] = den_agg.get(k, 0.0) + float(den)
            if preview is None and img_pred is not None:
                preview = img_pred[0].float().cpu().numpy()
        final = {k: num_agg[k] / max(den_agg[k], 1e-12) for k in num_agg}
        self.last_preview = preview
        if self.is_main:
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(final.items()))
            log.info("eval @%d: %s", step, msg)
            self._log_scalars(final, step)
            if preview is not None:
                try:
                    write_image(self.exp_dir / "show" / f"{step:08d}.jpg",
                                preview)
                except Exception as e:
                    log.warning("eval preview write failed: %s", e)
        sharding.barrier(self.group)
        return final

    def close(self):
        self.train_loader.close()
        if self.writer:
            self.writer.close()
