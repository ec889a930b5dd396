"""Readings for the limits of `correct`: the program against the plain
reference over many seeds, and the control (the reference one precision
lower) and the planted faults against it on a few, in one process:

    python3 port_bench/tools/calibrate.py --workload <cell> \
        --seeds 11 12 13 --seconds 3 --control 3 > readings.jsonl

Each seed builds the cell anew, runs a short window through the timed path
(as long as a run's mix needs to finish its frames or steps), and prints
one JSON line: {"seed", "program": {number: reading}, "control": {...},
"faults": {fault: {...}}}; control and faults for the first `--control`
seeds. Faults, planted in the reference put in the program's place:
`half_batch` (training: the second half of every batch left out, the mean
taken over the rest), `unchanged` (training: a step that returns its
state unchanged; reads 1 on change_gap by definition, computed here),
`altered` (serving: one view's image changed where it is produced, one
pixel row set to 0), `altered_rect` (serving: one row of a rectified
source raised by 0.5 where the dataset produces it), `half_frame` (serving:
the second half of the frame's valid Gaussians, the right view's, left
out).
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
from port_bench.drivers import serve, train  # noqa: E402


def _serve(cell, ctx, control: bool) -> dict:
    s = serve.ServeRun(cell, ctx)
    s.setup()
    s.window()
    prog = s.program_answers()
    s.release()
    ref = s.reference_answers()
    out = {"program": judge.serve_numbers(prog, ref),
           "frames": len(s.times), "setup_s": s.setup_s}
    if control:
        out["control"] = judge.serve_numbers(
            s.reference_answers(control=True), ref)
        altered = [dict(f, views=[dict(v) for v in f["views"]]) for f in ref]
        img = altered[0]["views"][0]["image"].copy()
        img[img.shape[0] // 2] = 0.0
        altered[0]["views"][0]["image"] = img
        rect = [dict(f, rect=dict(f["rect"])) for f in ref]
        src = rect[0]["rect"]["lmain"].copy()
        src[src.shape[0] // 2] += 0.5
        rect[0]["rect"]["lmain"] = src
        out["faults"] = {"altered": judge.serve_numbers(altered, ref),
                         "altered_rect": judge.serve_numbers(rect, ref),
                         "half_frame": judge.serve_numbers(
                             s.reference_answers(half_frame=True), ref)}
    return out


def _train(cell, ctx, control: bool) -> dict:
    t = train.TrainRun(cell, ctx)
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
    kind = {"serve": _serve, "train": _train}[cell.workload["driver"]]
    for i, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
            ctx = harness.Ctx(seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device(args.device),
                              tmp=Path(tmp), t0=time.perf_counter(),
                              spans=harness.Spans(False, args.device))
            out = kind(cell, ctx, i < args.control)
        print(json.dumps({"seed": seed, **out}), flush=True)
        harness.free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
