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
"""

from __future__ import annotations

import argparse
import logging


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
        trainer.train(eval_first=args.eval_first)
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
    return ap


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
