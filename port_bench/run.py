"""Run one cell of the port's benchmark once, in this process:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It loads, warms up, measures for `--seconds`, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1). It exits non-zero, printing no result,
when the cell's cards are not there, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into build/torch_kernels there by design)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, bench=None, base=None) -> int:
    """One run. `device`, `bench` and `base` are for the tests,
    which drive the rest of a run on the CPU at a small size; a run from
    the command line takes the cards or fails."""
    args = parse(argv)
    _caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench import harness, judge

    bench = bench if bench is not None else harness.benchmark()
    cell = harness.load_cell(args.workload, bench,
                             base or harness.BENCH_DIR)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
        spans = harness.Spans(False, device)
        ctx = harness.Ctx(seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device(device),
                          tmp=Path(tmp), t0=T0, spans=spans,
                          profile=harness.Profile(Path(tmp), device)
                          if args.trace else None)
        out = harness.driver(cell.workload["driver"]).run(cell, ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_of(cell.name, bench, kind):
        value = (harness.reader(m["name"])(out.record) if args.trace
                 else out.end_to_end.get(m["name"]))
        if value is None and not args.trace:
            raise RuntimeError(f"{cell.name} did not measure {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checked = judge.checks(out.numbers, cell.workload["limits"])
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    breakdown = None
    if args.trace:
        p = out.record.profile
        info.update(busy_s=p["busy_s"], window_s=p["window_s"])
        breakdown = {"device_ops": p["device_ops"],
                     "idle_gaps": p["idle_gaps"]}
    build = sys.modules.get("gps_gaussian_tpu_torch.kernels.build")
    print(f"launches {dict(build.LAUNCHES) if build else {}}",
          file=sys.stderr)
    print(f"counters {out.record.counters}", file=sys.stderr)
    print(f"numbers {out.numbers}", file=sys.stderr)
    harness.emit(judge.passed(checked) and out.failed == 0, out.attempted,
                 out.failed, metrics, info, checked, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
