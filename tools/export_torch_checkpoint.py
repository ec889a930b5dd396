#!/usr/bin/env python
"""Export an Orbax run directory of the JAX package as a checkpoint of the
PyTorch port, and measure the JAX reference on the synthetic val set.

    JAX_PLATFORMS=cpu python tools/export_torch_checkpoint.py \
        runs/synth256/stage2 [--out runs/synth256/stage2/torch] \
        [--val-reference]

Restores the run's latest step with the JAX `restore_params_partial`
(fresh initialisation for anything absent), converts it with the port's
`utils/weights.py state_dict_from_flax`, and writes {"step", "params"} to
<out>/ckpt_<step>.pt, which the port's `restore_params_partial`,
`Trainer` (cfg.stage1_ckpt) and `load_renderer` read from the directory.

--val-reference then runs the JAX eval step over the run's val set built in
memory (`gps_gaussian_tpu_torch.testing.SynthMemoryDataset`: the first
--val-scans val scans of `synth.generate_dataset`, no JPEG round trip) with
the run's config, and the port's `Trainer.run_eval` on the CPU over the
same samples from the exported file, and prints both sweeps' metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gps_gaussian_tpu.data.loader import eval_batches  # noqa: E402
from gps_gaussian_tpu.testing import fake_stereo_batch  # noqa: E402
from gps_gaussian_tpu.train import config as jconfig  # noqa: E402
from gps_gaussian_tpu.train import state as jstate  # noqa: E402
from gps_gaussian_tpu.train import trainer as jtrainer  # noqa: E402

from gps_gaussian_tpu_torch.data.thuman import DatasetConfig  # noqa: E402
from gps_gaussian_tpu_torch.testing import (SynthMemoryDataset,  # noqa: E402
                                            synth_scans)
from gps_gaussian_tpu_torch.train import config as tconfig  # noqa: E402
from gps_gaussian_tpu_torch.train.trainer import Trainer  # noqa: E402
from gps_gaussian_tpu_torch.utils.weights import \
    state_dict_from_flax  # noqa: E402


def latest_step(run_dir: Path) -> int:
    steps = [int(m.group(1)) for d in run_dir.iterdir()
             if (m := re.fullmatch(r"(?:ckpt_)?(\d+)", d.name))]
    if not steps:
        raise FileNotFoundError(f"no checkpoint step under {run_dir}")
    return max(steps)


def restore(run_dir: Path, cfg):
    """(flax params of the run's latest step, leaves restored)."""
    model = jtrainer.make_model(cfg, with_gs=True)
    batch = fake_stereo_batch(batch=1, res=64)
    target = jax.eval_shape(
        lambda k: model.init(k, batch, iters=3, test_mode=True),
        jax.random.PRNGKey(0))
    return jstate.restore_params_partial(str(run_dir), target)


def export(run_dir: Path, out: Path, cfg) -> Path:
    params, n = restore(run_dir, cfg)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    step = latest_step(run_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"ckpt_{step}.pt"
    torch.save({"step": step, "params": sd}, path)
    print(f"restored {n} flax leaves of step {step} from {run_dir}; wrote "
          f"{len(sd)} tensors to {path} ({path.stat().st_size} bytes)")
    return path


def val_dataset(cfg, n_scans: int) -> SynthMemoryDataset:
    return SynthMemoryDataset(DatasetConfig(
        data_root="", src_res=cfg.dataset.src_res,
        val_novel_ids=tuple(cfg.dataset.val_novel_id),
        use_hr_img=cfg.dataset.use_hr_img, use_processed_data=False),
        synth_scans("val", n_scans), phase="val")


def jax_val_sweep(run_dir: Path, cfg, ds) -> dict:
    params, _ = restore(run_dir, cfg)
    model = jtrainer.make_model(cfg, with_gs=True)
    step = jax.jit(jtrainer.make_eval_step(
        model, cfg, "stage2", jtrainer.make_raster_config(cfg)))
    num, den = {}, {}
    for batch, weight in eval_batches(ds, cfg.batch_size,
                                      tuple(cfg.dataset.val_novel_id)):
        metrics, _ = step(params, batch, jax.numpy.asarray(weight))
        for k, (a, b) in metrics.items():
            num[k] = num.get(k, 0.0) + float(a)
            den[k] = den.get(k, 0.0) + float(b)
    return {k: num[k] / max(den[k], 1e-12) for k in num}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", type=Path)
    ap.add_argument("--out", type=Path, default=None,
                    help="default: <run_dir>/torch")
    ap.add_argument("--val-reference", action="store_true")
    ap.add_argument("--val-scans", type=int, default=8)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")

    # the run's cfg.json through the port's JSON reader: the JAX package
    # reads it with PyYAML, which takes its 5e-05 for a string
    cfg_path = args.run_dir / "cfg.json"
    cfg = jconfig.load_config(None, **dataclasses.asdict(
        tconfig.load_config(str(cfg_path))))
    out = args.out or args.run_dir / "torch"
    export(args.run_dir, out, cfg)
    if not args.val_reference:
        return
    ds = val_dataset(cfg, args.val_scans)
    ref = jax_val_sweep(args.run_dir, cfg, ds)
    print("JAX package, CPU:", {k: round(v, 6) for k, v in ref.items()})
    tcfg = tconfig.load_config(
        str(cfg_path), stage1_ckpt=str(out), restore_ckpt=None,
        dataset=dict(num_workers=0))
    with tempfile.TemporaryDirectory() as exp:
        tr = Trainer(tcfg, exp_dir=exp, dataset=ds, val_dataset=ds,
                     device="cpu")
        try:
            port = tr.run_eval(0)
        finally:
            tr.close()
    print(f"port, CPU ({tr.n_restored} tensors restored):",
          {k: round(v, 6) for k, v in port.items()})
    print("difference port - JAX:",
          {k: round(port[k] - ref[k], 6) for k in ref})


if __name__ == "__main__":
    main()
