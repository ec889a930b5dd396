"""The FLOPs RAFT-Stereo spends on one sample (a stereo pair, matched in
both directions), counted by torch.utils.flop_counter over the benchmark's
plain reference (reference/raft_stereo.py) on the meta device (no memory,
no arithmetic), at the configuration's source width:

    python3 port_bench/tools/count_flops_raftstereo.py \
        port_bench/configs/<config>.json

prints {"serve_forward": ..., "train_step_per_sample": ..., "parameters":
...}, what the configuration file carries under "flops" (and its parameter
count):

* serve_forward: one test-mode forward at `val_iters` (the final iteration
  alone is upsampled);
* train_step_per_sample: one training-mode forward at `train_iters` (every
  iteration upsampled) and its backward into every parameter, per sample.
  The loss and AdamW are not counted, nor the encoders' second forward
  under `raft.remat_encoders` (memory bought with operations, not the
  model's own work).

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

from port_bench.reference import raft_stereo  # noqa: E402
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
    res = recipe["dataset"]["src_res"]
    model = raft_stereo.build_model(
        dict(recipe, raft=dict(recipe["raft"], remat_encoders=False)), device)
    batch = _batch(res, device)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(batch, iters=recipe["raft"]["val_iters"], test_mode=True)
    serve = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        out = model(batch, iters=recipe["raft"]["train_iters"])
        sum(p.float().sum() for p in out.flow_preds).backward()
    return {"serve_forward": serve,
            "train_step_per_sample": fc.get_total_flops(),
            "parameters": sum(p.numel() for p in model.parameters())}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count(json.load(f))))
