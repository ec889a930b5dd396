"""Typed config tree + yaml recipe overlay.

Copy of gps_gaussian_tpu/train/config.py (the port imports nothing from the
JAX package). `load_config(path, **overrides)` overlays a recipe and then
keyword overrides onto the defaults. A `.json` recipe is read with the
standard library, anything else with PyYAML (imported only then): JSON is
a subset of YAML, so the JAX package's `load_config` reads a `.json` recipe
to the same Config (provided its floats carry a decimal point, which
`save_config` sees to), and a machine without PyYAML runs from one.

`RaftConfig.encoder` chooses RAFT-Stereo's own network (train/trainer.py
`make_model`), which the JAX package does not have; `as_dict` and
`save_config` leave it out where it holds GPS-Gaussian's value, so a
GPS-Gaussian recipe reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """reference config: raft.* (stereo_human_config.py:27-41).

    `encoder` "unet" is GPS-Gaussian's network (U-Net features at 1/8, one
    GRU level of width hidden_dims[2], GroupNorm); "raftstereo" is
    RAFT-Stereo's (its encoders of widths encoder_dims on the images, three
    GRU levels of widths hidden_dims, finest last as upstream lists them,
    BatchNorm in the context encoder: train_stereo.py's n_gru_layers 3 and
    context_norm batch). `remat_encoders` (RAFT-Stereo's only) recomputes
    its two encoders in the backward instead of keeping their activations,
    most of them at full resolution: memory for about a twentieth more of
    a step's operations."""

    mixed_precision: bool = False
    train_iters: int = 3
    val_iters: int = 3
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 3            # 1/8 resolution features
    encoder_dims: Tuple[int, ...] = (32, 48, 96)
    hidden_dims: Tuple[int, ...] = (96, 96, 96)
    encoder: str = "unet"
    remat_encoders: bool = False


# RaftConfig's keys the JAX package's Config lacks, at GPS-Gaussian's values
PORT_ONLY_RAFT = {"encoder": "unet", "remat_encoders": False}


@dataclasses.dataclass(frozen=True)
class GsnetConfig:
    """reference config: gsnet.* (stereo_human_config.py:43-47)."""

    encoder_dims: Tuple[int, ...] = (32, 48, 96)
    decoder_dims: Tuple[int, ...] = (48, 64, 96)
    parm_head_dim: int = 32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """reference config: dataset.* (stereo_human_config.py:13-25)."""

    data_root: str = ""
    source_id: Tuple[int, ...] = (0, 1)
    train_novel_id: Tuple[int, ...] = (2, 3, 4)
    val_novel_id: Tuple[int, ...] = (3,)
    src_res: int = 1024
    use_hr_img: bool = False
    use_processed_data: bool = True
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    znear: float = 0.01
    zfar: float = 100.0
    # loader workers (reference train_stage1.py:32-36 DataLoader workers):
    # processes fork numpy/PIL decode off the GIL; 0 = thread fallback
    num_workers: int = 0
    # cap on deterministic full-val-sweep batches per eval (None = all)
    eval_max_batches: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static capacities of the tile rasterizer (no reference equivalent —
    the CUDA rasterizer allocated dynamically; TPU shapes are static).
    All caps report drops through RasterizeAux (never silent)."""

    max_tiles_per_gaussian: int = 16
    max_per_tile: int = 1024
    fg_cap: Optional[int] = None       # foreground compaction before binning
    pair_budget: Optional[int] = None  # cap on total sorted pairs
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class RecordConfig:
    """reference config: record.* (stereo_human_config.py:49-55)."""

    ckpt_path: str = "experiments"
    show_path: str = "experiments"
    logs_path: str = "experiments"
    file_path: str = "experiments"
    loss_freq: int = 50
    eval_freq: int = 2000


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "exp"
    stage: str = "stage1"
    batch_size: int = 2
    lr: float = 2e-4
    wdecay: float = 1e-5
    grad_clip: float = 1.0
    num_steps: int = 40000
    scheduler_steps: Optional[int] = None   # None -> num_steps + 100
    # 'onecycle' = torch OneCycleLR(linear) exactly (the reference,
    # train_stage1.py:40-41); 'constant' = flat peak lr, used by short
    # proof recipes where the decay of a reference-length schedule
    # compressed into 1.2k steps starves the recovery phase
    scheduler: str = "onecycle"
    restore_ckpt: Optional[str] = None
    stage1_ckpt: Optional[str] = None
    seed: int = 1314
    # separate loader shuffling seed (None = seed).  Exists so a proof
    # recipe can pin the exact (init, data-order) pair a probe validated
    # — early stage-2 trajectories are sensitive to sample order (the
    # geometry either stays anchored or drifts before the fresh heads
    # adapt; ROADMAP.md stage-2 findings)
    loader_seed: Optional[int] = None
    remat: bool = False   # rematerialize the model fwd (HBM for FLOPs
                          # at hi-res stage2; SURVEY.md §7 hard part 4)
    # stage-2 loss mix (reference train_stage2.py:70-72 fixes
    # 1.0*flow + 0.8*L1 + 0.2*(1-SSIM); these knobs exist because at
    # short proof schedules the flow term — already converged by stage 1
    # — fights the photometric adaptation of the shared backbone, while
    # the reference's 100k-step schedule absorbs the conflict.  Defaults
    # are the reference's weights; only scaled-down proof recipes
    # override them)
    flow_weight: float = 1.0
    l1_weight: float = 0.8
    ssim_weight: float = 0.2
    # per-parameter-group lr multipliers keyed by TOP-LEVEL module name
    # (e.g. {"img_encoder": 0.1, "raft_stereo": 0.1}).  The reference has
    # a single param group; this exists because stage-2 warm starts mix
    # pretrained (encoder/raft) and fresh (gs_regresser) parameters, and
    # at short proof schedules the flow-dominated gradient drags the
    # shared encoder out from under the fresh gsnet heads faster than
    # they can adapt — measured as global opacity collapse (val PSNR
    # 33 -> 23 dB in 300 steps on synth-256).  None = single group.
    lr_group_scales: Optional[dict] = None
    raft: RaftConfig = RaftConfig()
    gsnet: GsnetConfig = GsnetConfig()
    dataset: DataConfig = DataConfig()
    raster: RasterConfig = RasterConfig()
    record: RecordConfig = RecordConfig()


def _overlay(dc, updates: dict):
    """Recursively overlay a dict onto a (frozen) dataclass."""
    kwargs = {}
    for k, v in updates.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = _overlay(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dataclasses.replace(dc, **kwargs)


def load_config(path: Optional[str] = None, **overrides) -> Config:
    cfg = Config()
    if path is not None:
        with open(path) as f:
            if str(path).endswith(".json"):
                data = json.load(f)
            else:
                import yaml

                data = yaml.safe_load(f)
        cfg = _overlay(cfg, data or {})
    if overrides:
        cfg = _overlay(cfg, overrides)
    return cfg


def as_dict(cfg: Config) -> dict:
    """`cfg` as nested dicts, without the keys of PORT_ONLY_RAFT that hold
    their GPS-Gaussian values: for a GPS-Gaussian recipe, the fields of the
    JAX package's Config."""
    out = dataclasses.asdict(cfg)
    for k, v in PORT_ONLY_RAFT.items():
        if out["raft"][k] == v:
            del out["raft"][k]
    return out


def save_config(cfg: Config, path: str):
    """Write `cfg` (`as_dict`) as JSON that PyYAML also reads to the same
    values: YAML 1.1 takes 5e-05 for a string, so an exponent gets its
    decimal point (5.0e-05). The JAX package's save_config writes 5e-05."""
    text = json.dumps(as_dict(cfg), indent=1)
    # with indent=1 every bare number ends its line, after ': ' or indent
    text = re.sub(r"(?m)(: |^\s+)(-?\d+)(e[-+]\d+)(,?)$", r"\1\2.0\3\4",
                  text)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
