"""Readings for the limits of `correct` in a RAFT-Stereo training cell
(driver `train_raftstereo`), as tools/calibrate.py gives them for the
GPS-Gaussian cells: the program against the plain reference over many
seeds, and the control and the planted faults on the first few, in one
process:

    python3 port_bench/tools/calibrate_raftstereo.py \
        --workload train-raftstereo-1k --seeds 11 12 13 --control 3 \
        > readings.jsonl

Each seed prints one JSON line: {"seed", "program": {number: reading},
"steps", "losses", "setup_s", "zero_grad_leaves", and for the first
`--control` seeds "control" and "faults" ("half_batch": the second half of
every batch left out; "unchanged": a step that leaves its state unchanged,
1 on change_gap by definition)}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import harness, judge  # noqa: E402
from port_bench.drivers import train_raftstereo  # noqa: E402


def readings(cell, ctx, control: bool) -> dict:
    t = train_raftstereo.RaftStereoTrainRun(cell, ctx)
    t.setup()
    t.window()
    prog = t.program_answers()
    t.release()
    ref = t.reference_answers()
    out = {"program": judge.train_numbers(prog, ref), "steps": t.steps,
           "losses": {"program": prog["losses"], "reference": ref["losses"]},
           "setup_s": t.setup_s,
           "zero_grad_leaves": judge.zero_grad_leaves(ref)}
    if control:
        out["control"] = judge.train_numbers(
            t.reference_answers(control=True), ref)
        unchanged = dict(ref, change_norms={k: 0.0 for k in
                                            ref["change_norms"]})
        out["faults"] = {
            "half_batch": judge.train_numbers(
                t.reference_answers(half_batch=True), ref),
            "unchanged": judge.train_numbers(unchanged, ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
            ctx = harness.Ctx(seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device(args.device),
                              tmp=Path(tmp), t0=time.perf_counter(),
                              spans=harness.Spans(False, args.device))
            out = readings(cell, ctx, i < args.control)
        print(json.dumps({"seed": seed, **out}), flush=True)
        harness.free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
