"""What the four command-line tools share: flags, config overrides, the
test dataset and the renderer.

Every tool joins the torch.distributed group that `torchrun` describes
(train/sharding.py init_distributed; a plain `python -m` run is one
process), one rank per card:

    torchrun --nproc_per_node 4 -m gps_gaussian_tpu_torch.cli.train_stage2 \
        --config configs/stage2.yaml --data_root /path/to/data

The training tools then train data-parallel, the global batch split over
the ranks; the test tools shard each view's tile rows over the ranks with
`--shard_render`. Rank 0 alone writes files.

Tracing: `--trace_steps lo:hi` (training) or `--trace_frames lo:hi` (the
test tools) writes a torch.profiler trace of those steps or frames, with
the program's spans, to `--trace_dir` (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
from pathlib import Path


def train_main(stage: str, default_config: str, argv=None):
    """The training tools (counterparts of the root train_stage1.py and
    train_stage2.py): parse `argv`, build the Trainer, save the config as
    <exp>/cfg.json and train."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=default_config,
                    help="a .yaml recipe (needs PyYAML) or a .json one")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--exp_dir", default=None)
    if stage == "stage2":
        ap.add_argument("--stage1_ckpt", default=None)
    ap.add_argument("--restore_ckpt", default=None)
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--eval_freq", type=int, default=None)
    ap.add_argument("--eval_first", action="store_true",
                    help="run one val sweep at step 0 (untrained anchor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    _trace_flags(ap, "steps", "<exp>/logs/profile")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    from gps_gaussian_tpu_torch.train.config import load_config, save_config
    from gps_gaussian_tpu_torch.train.sharding import init_distributed
    from gps_gaussian_tpu_torch.train.trainer import Trainer

    group, device = init_distributed(args.device)

    overrides = {}
    if args.data_root:
        overrides["dataset"] = {"data_root": args.data_root}
    if getattr(args, "stage1_ckpt", None):
        overrides["stage1_ckpt"] = args.stage1_ckpt
    if args.restore_ckpt:
        overrides["restore_ckpt"] = args.restore_ckpt
    if args.num_steps:
        overrides["num_steps"] = args.num_steps
    if args.eval_freq:
        overrides["record"] = {"eval_freq": args.eval_freq}
    cfg = load_config(args.config, stage=stage, **overrides)

    trainer = Trainer(cfg, exp_dir=args.exp_dir, device=device, group=group)
    if trainer.is_main:
        save_config(cfg, str(trainer.exp_dir / "cfg.json"))
    try:
        trainer.train(eval_first=args.eval_first,
                      trace_steps=args.trace_steps,
                      trace_dir=args.trace_dir)
    finally:
        trainer.close()
    return trainer


def infer_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/stage2.yaml",
                    help="a .yaml recipe (needs PyYAML) or a .json one")
    ap.add_argument("--test_data_root", required=True)
    ap.add_argument("--ckpt_path", required=True,
                    help="a run directory of ckpt_<step>.pt files, or one")
    ap.add_argument("--src_view", type=int, nargs=2, default=(0, 1))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--shard_render", action="store_true",
                    help="shard each view's tile rows over the ranks of a "
                         "torchrun launch")
    _trace_flags(ap, "frames", "<out_dir>/profile")
    return ap


def _window(text: str) -> tuple:
    lo, hi = (int(x) for x in text.split(":"))
    if not 0 <= lo < hi:
        raise argparse.ArgumentTypeError(f"{text!r} is not lo:hi with "
                                         "0 <= lo < hi")
    return lo, hi


def _trace_flags(ap: argparse.ArgumentParser, what: str, default_dir: str):
    ap.add_argument(f"--trace_{what}", type=_window, default=None,
                    metavar="LO:HI",
                    help=f"write a torch.profiler trace of {what} lo to "
                         f"hi - 1 (the program's spans on its timeline)")
    ap.add_argument("--trace_dir", default=None,
                    help=f"where the trace goes (default {default_dir})")


def traced_frames(frames, args):
    """Yield the items of `frames` (one per frame); frames lo to hi - 1 of
    `args.trace_frames` are made under a torch.profiler trace written to
    `args.trace_dir` (default <out_dir>/profile) as
    trace_frames_<lo>_<hi>.json."""
    window = args.trace_frames
    if window is None:
        yield from frames
        return
    lo, hi = window
    where = args.trace_dir or str(Path(args.out_dir) / "profile")
    from gps_gaussian_tpu_torch.utils.profiling import maybe_trace

    end = object()
    with contextlib.ExitStack() as trace:
        it = iter(frames)
        for i in itertools.count():
            if i == lo:
                trace.enter_context(maybe_trace(
                    where, f"trace_frames_{lo}_{hi}.json"))
            item = next(it, end)
            if item is end:
                return
            if i + 1 == hi:
                trace.close()
            yield item


def load_test_renderer(args):
    """(renderer on the checkpoint's weights, the test dataset, whether this
    process writes the images: rank 0 alone)."""
    logging.basicConfig(level=logging.INFO)

    from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                    StereoHumanDataset)
    from gps_gaussian_tpu_torch.infer.freeview import load_renderer
    from gps_gaussian_tpu_torch.train.config import load_config
    from gps_gaussian_tpu_torch.train.sharding import (init_distributed,
                                                       rank)

    group, device = init_distributed(args.device)

    cfg = load_config(args.config)
    ds_cfg = DatasetConfig(
        data_root=args.test_data_root, src_res=cfg.dataset.src_res,
        source_ids=tuple(args.src_view), use_hr_img=cfg.dataset.use_hr_img,
        use_processed_data=False)
    dataset = StereoHumanDataset(ds_cfg, "test")
    renderer = load_renderer(cfg, args.ckpt_path, dataset, device=device,
                             group=group if args.shard_render else None)
    return renderer, dataset, rank(group) == 0
