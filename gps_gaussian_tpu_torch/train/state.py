"""TrainState: AdamW + the one-cycle schedule, gradient clipping, checkpoints.

Counterpart of gps_gaussian_tpu/train/state.py: AdamW(lr, weight decay,
eps 1e-8), the linear one-cycle schedule with pct_start 0.01 (or a constant
rate), gradient clipping at `cfg.grad_clip`, per-module learning-rate
scales, checkpoints that resume with the optimizer and scheduler state, and
the cross-stage partial restore (stage 2 warm-starts the encoder and RAFT
from stage 1 while the fresh Gaussian head keeps its initialisation).

The schedule is a `LambdaLR` with the JAX formula (`onecycle_linear`
:38-50), not `torch.optim.lr_scheduler.OneCycleLR`: torch ends the warm-up
at step pct_start * total - 1, the JAX schedule at int(pct_start * total),
so the two differ by one step of warm-up everywhere.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Mapping, Optional, Union

import torch
import torch.nn as nn

from gps_gaussian_tpu_torch.train.config import Config
from gps_gaussian_tpu_torch.utils.device import resolve_device

KEEP_CHECKPOINTS = 3


@dataclasses.dataclass
class TrainState:
    """What one training run carries from step to step."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip: float = 1.0

    def apply_gradients(self) -> torch.Tensor:
        """Clip the parameters' gradients to `grad_clip` in global norm,
        take one optimizer and scheduler step. Returns the norm before
        clipping."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        norm = torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return norm


def onecycle_linear(peak_lr: float, total_steps: int,
                    pct_start: float = 0.01, div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up from peak / div_factor over
    int(total * pct_start) steps, then linear decay to
    peak / div_factor / final_div_factor over the rest, and flat after."""
    up = max(int(total_steps * pct_start), 1)
    init = peak_lr / div_factor
    final = init / final_div_factor
    down = total_steps - up

    def schedule(step: int) -> float:
        if step < up:
            return init + (peak_lr - init) * (step / up)
        frac = min(step - up, down) / down
        return peak_lr + (final - peak_lr) * frac

    return schedule


def _group_of(name: str) -> str:
    return name.split(".")[0]


def validate_group_scales(scales: Mapping[str, float],
                          model: nn.Module) -> None:
    """Every lr_group_scales key must name a top-level module that holds
    parameters: a mistyped key would otherwise silently scale nothing."""
    groups = {_group_of(name) for name, _ in model.named_parameters()}
    missing = sorted(set(scales) - groups)
    if missing:
        raise ValueError(
            f"lr_group_scales keys {missing} match no top-level module in "
            f"the model (groups present: {sorted(groups)})")


def make_optimizer(cfg: Config, model: nn.Module):
    """(AdamW, scheduler) of `cfg` over `model`'s parameters.

    With `lr_group_scales`, each top-level module is a parameter group whose
    rate is the schedule times its scale (1.0 when unnamed); the weight
    decay term scales with it, as a parameter group's does."""
    if cfg.scheduler == "constant":
        factor = lambda step: 1.0  # noqa: E731
    elif cfg.scheduler == "onecycle":
        sched = onecycle_linear(
            cfg.lr, cfg.scheduler_steps or (cfg.num_steps + 100))
        factor = lambda step: sched(step) / cfg.lr  # noqa: E731
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r} "
                         "(expected 'onecycle' or 'constant')")
    if cfg.lr_group_scales:
        scales = dict(cfg.lr_group_scales)
        validate_group_scales(scales, model)
        by_group: dict = {}
        for name, p in model.named_parameters():
            by_group.setdefault(_group_of(name), []).append(p)
        groups = [{"params": ps, "lr": cfg.lr * scales.get(g, 1.0),
                   "name": g} for g, ps in by_group.items()]
    else:
        groups = [{"params": list(model.parameters()), "lr": cfg.lr,
                   "name": "all"}]
    optimizer = torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.wdecay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler


def create_state(cfg: Config, model: nn.Module, device="cuda") -> TrainState:
    """Move `model` to `device` (CUDA unless the caller asks for the CPU) and
    build its optimizer and scheduler at step 0."""
    model.to(resolve_device(device))
    optimizer, scheduler = make_optimizer(cfg, model)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      scheduler=scheduler, grad_clip=cfg.grad_clip)


# ------------------------------------------------------------- checkpoints


def _checkpoint_path(ckpt: Union[str, Path], step: Optional[int]) -> Path:
    """A checkpoint file: `ckpt` itself when it is a file, else
    `ckpt/ckpt_<step>.pt` (the latest step when `step` is None)."""
    ckpt = Path(ckpt)
    if ckpt.is_file():
        return ckpt
    if step is None:
        steps = [int(m.group(1)) for f in ckpt.glob("ckpt_*.pt")
                 if (m := re.fullmatch(r"ckpt_(\d+)\.pt", f.name))]
        if not steps:
            raise FileNotFoundError(f"no ckpt_<step>.pt under {ckpt}")
        step = max(steps)
    return ckpt / f"ckpt_{step}.pt"


def save_checkpoint(ckpt_dir: Union[str, Path], state: TrainState) -> Path:
    """Write params, optimizer, scheduler and step to
    `ckpt_dir/ckpt_<step>.pt`, keeping the newest KEEP_CHECKPOINTS files."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"ckpt_{state.step}.pt"
    tmp = path.with_suffix(".tmp")
    torch.save({"step": state.step,
                "params": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, tmp)
    tmp.replace(path)
    steps = sorted(int(f.stem.split("_")[1])
                   for f in ckpt_dir.glob("ckpt_*.pt"))
    for old in steps[:-KEEP_CHECKPOINTS]:
        (ckpt_dir / f"ckpt_{old}.pt").unlink()
    return path


def restore_checkpoint(ckpt: Union[str, Path], state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Full resume into `state` (in place): params, optimizer moments,
    scheduler position and step. The next step then equals the
    uninterrupted run's."""
    device = next(state.model.parameters()).device
    saved = torch.load(_checkpoint_path(ckpt, step), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["optimizer"])
    # LambdaLR's state holds no lambda (it is not saved); the step count and
    # last rates are what resume needs
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state


def restore_params_partial(source, model: nn.Module,
                           step: Optional[int] = None) -> int:
    """Cross-stage warm start: copy into `model` every tensor of `source`
    whose name and shape match, and leave the rest as initialised. No
    optimizer state is restored.

    `source`: a state_dict, a checkpoint file, or a checkpoint directory.
    Returns the number of tensors copied."""
    if not isinstance(source, Mapping):
        source = torch.load(_checkpoint_path(source, step),
                            map_location="cpu", weights_only=True)["params"]
    target = model.state_dict()
    n_loaded = 0
    with torch.no_grad():
        for name, tensor in target.items():
            saved = source.get(name)
            if saved is not None and tuple(saved.shape) == tuple(tensor.shape):
                tensor.copy_(saved)
                n_loaded += 1
    return n_loaded
