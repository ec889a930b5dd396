"""Readings for the limits of `correct`, for a cell of any driver: the
program against the plain reference over many seeds, each sound variant of
the reference against the plain one, and the control (the reference one
precision lower) and the planted faults on a few, in one process:

    python3 port_bench/tools/calibrate.py --workload <cell> \
        --seeds 11 12 13 --seconds 3 --control 3 --variants 3 \
        > readings.jsonl

Each seed builds the cell anew through its driver's run class
(`harness.driver(...).Run`), runs a short window through the timed path (as
long as a run's mix needs to finish its frames or steps), and prints one
JSON line: {"seed", "program": {number: reading}, "correct": the program
against the cell's committed limits, "variants": {variant: {...}},
"control": {...}, "faults": {fault: {...}}, and what the driver adds
(frames or steps, set-up seconds, losses)}; variants for the first
`--variants` seeds, control and faults for the first `--control`. A sound
variant (reference/layers.py VARIANTS) does the reference's mathematics at
the configuration's precision with its f32 sums in another order:
`norm_order` every norm with statistics on its input flipped along the
width, `conv_layout` every convolution on channels-last tensors. The
faults are the driver's (`faults`): `half_batch`, `half_loss` and
`unchanged` in training; `altered`, `uncounted`, `altered_rect`,
`half_frame`, `region_rgb` and `region_xyz` in serving.

`--program_variant norm_order` (or `conv_layout`) makes the same change in
the program, in this process only, before anything is built: a probe of
whether a sound rewrite of the program's norms or convolutions would come
out correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness, judge  # noqa: E402
from port_bench.reference.layers import VARIANTS  # noqa: E402


@contextlib.contextmanager
def program_variant(kind: Optional[str]):
    """The sound variant `kind` made in the program while the context
    lasts: its norms with statistics (GroupNorm32, InstanceNorm32) on their
    input flipped along the width and their output flipped back
    (`norm_order`), or its convolutions on a channels-last input
    (`conv_layout`); None changes nothing."""
    if kind is None:
        yield
        return
    import torch

    from gps_gaussian_tpu_torch.models import layers

    if kind == "norm_order":
        classes = (layers.GroupNorm32, layers.InstanceNorm32)

        def wrap(plain):
            return lambda self, x: plain(self, x.flip(-1)).flip(-1)
    elif kind == "conv_layout":
        classes = (layers.Conv,)

        def wrap(plain):
            return lambda self, x: plain(self, x.contiguous(
                memory_format=torch.channels_last))
    else:
        raise ValueError(f"unknown variant {kind!r} (expected one of "
                         f"{VARIANTS})")
    plain = {cls: cls.forward for cls in classes}
    try:
        for cls in classes:
            cls.forward = wrap(plain[cls])
        yield
    finally:
        for cls in classes:
            cls.forward = plain[cls]


def readings(run, limits: dict, variants: int, control: bool) -> dict:
    """One seed's readings through the run object `run` (not set up)."""
    run.setup()
    run.window()
    prog = run.program_answers()
    run.release()
    ref = run.reference_answers()
    numbers = run.numbers(prog, ref)
    out = {"program": numbers,
           "correct": judge.passed(judge.checks(numbers, limits)),
           **run.details()}
    training = isinstance(ref, dict)     # serving answers a list of frames
    if training:
        out["reference_losses"] = ref["losses"]
        out["zero_grad_leaves"] = judge.zero_grad_leaves(ref)
        out["worst"] = {"program": judge.worst_leaves(prog, ref)}
    else:
        out["reference_drops"] = [[v["drops"] for v in f["views"]]
                                  for f in ref]
    others = {k: {"variant": k} for k in (VARIANTS if variants else ())}
    if control:
        others["control"] = {"control": True}
    for kind, how in others.items():
        ans = run.reference_answers(**how)
        numbers = run.own_numbers(ans, ref)
        if kind == "control":
            out["control"] = numbers
        else:
            out.setdefault("variants", {})[kind] = numbers
        if training:
            out["worst"][kind] = judge.worst_leaves(ans, ref)
    if control:
        out["faults"] = run.faults(ref)
    return out


def main(argv=None, device=None, bench=None, base=None) -> int:
    """`device`, `bench` and `base` are for the tests, which calibrate the
    benchmark at a small size on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--program_variant", choices=VARIANTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    device = device or args.device
    cell = harness.load_cell(args.workload, bench, base or harness.BENCH_DIR)
    run_class = harness.driver(cell.workload["driver"]).Run
    with program_variant(args.program_variant):
        for i, seed in enumerate(args.seeds):
            with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
                ctx = harness.Ctx(seed=seed, seconds=args.seconds,
                                  trace=False, device=torch.device(device),
                                  tmp=Path(tmp), t0=time.perf_counter(),
                                  spans=harness.Spans(False, device))
                out = readings(run_class(cell, ctx), cell.workload["limits"],
                               i < args.variants, i < args.control)
            print(json.dumps({"seed": seed, "cell": cell.name,
                              "program_variant": args.program_variant,
                              **out}), flush=True)
            harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
