"""The FLOPs a configuration's stereo network spends on one sample, counted
by torch.utils.flop_counter over the benchmark's plain reference on the meta
device (no memory, no arithmetic), at the configuration's source width:

    python3 port_bench/tools/count_flops.py port_bench/configs/<config>.json

prints {"serve_forward": ..., "train_step_per_sample": ...}, the numbers
the configuration file carries under "flops":

* serve_forward: one test-mode forward of a stereo pair (the final
  iteration alone is upsampled), what a served frame costs;
* train_step_per_sample: one training-mode forward (every iteration
  upsampled) and its backward into every parameter and the inputs of the
  loss, per sample. The rasterizer, the losses and AdamW are not counted:
  the composites are f32 CUDA-core work with rooflines of their own.

The counts are fixed data: the same whatever implements the model.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.reference import pipeline  # noqa: E402
from port_bench.reference.containers import (SourceView,  # noqa: E402
                                             StereoSample)


def _batch(res: int, device) -> StereoSample:
    def view():
        return SourceView(img=torch.zeros(1, res, res, 3, device=device),
                          mask=torch.ones(1, res, res, 1, device=device),
                          intr=torch.eye(3, device=device)[None],
                          ref_intr=torch.eye(3, device=device)[None],
                          extr=torch.eye(3, 4, device=device)[None],
                          tf_x=torch.ones(1, device=device))
    return StereoSample(lmain=view(), rmain=view())


def count(config: dict, device="meta") -> dict:
    recipe = config["recipe"]
    with_gs = config["stage"] == "stage2"
    res = recipe["dataset"]["src_res"]
    model = pipeline.build_model(recipe, with_gs, device)
    batch = _batch(res, device)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(batch, iters=recipe["raft"]["val_iters"], test_mode=True)
    serve = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        out = model(batch, iters=recipe["raft"]["train_iters"])
        loss = sum(p.float().sum() for p in out.flow_preds)
        if with_gs:
            for g in (out.lmain_gs, out.rmain_gs):
                loss = loss + sum(getattr(g, f).float().sum() for f in
                                  ("rot", "scale", "opacity", "xyz"))
        loss.backward()
    return {"serve_forward": serve,
            "train_step_per_sample": fc.get_total_flops()}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count(json.load(f))))
