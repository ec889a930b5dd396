"""What every run shares: the cell's files found by name, spans, the
profiled stretch and its reading, the metric readers, and the result line.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<mix>.json`) and its
driver (`drivers/<driver>.py`); a per-layer metric is read by
`metrics/<metric>.py`. Nothing here names a cell, a configuration or a
metric: a later cell, configuration or metric is a new file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names a run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gps_gaussian_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among `modules` (sys.modules), each
    compared whole: `gps_gaussian_tpu_torch` is not `gps_gaussian_tpu`."""
    tops = {name.split(".")[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark with its files read."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    entry: dict            # the cell's entry in BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def weights(self, use: str) -> Path:
        """The checkpoint file the configuration serves, its bytes checked
        against the sha256 the configuration records."""
        spec = self.config["weights"][use]
        path = ROOT / spec["path"]
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != spec["sha256"]:
            raise RuntimeError(f"{path} is not the checkpoint the "
                               f"configuration names (sha256 {digest})")
        return path


def load_cell(name: str, bench: Optional[dict] = None,
              base: Path = BENCH_DIR) -> Cell:
    """The cell `name` with its files: workloads/ and traffic/ under
    `base`, the configuration where BENCHMARK.json's entry puts it."""
    bench = bench if bench is not None else benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    wl = load_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {wl[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[wl["config"]]
    return Cell(name=name, workload=wl, config=load_json(ROOT / cfg_file),
                traffic=load_json(base / "traffic" / f"{wl['traffic']}.json"),
                entry=entry)


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


@dataclasses.dataclass
class Ctx:
    """What a driver gets besides its cell: the run's arguments, device,
    scratch directory (under TMPDIR), its process's start on the host clock,
    its spans and, when traced, the profiled stretch."""

    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    t0: float
    spans: "Spans"
    profile: Optional["Profile"] = None


@dataclasses.dataclass
class Outcome:
    """A driver's result: what the window attempted and failed, its
    end-to-end values, what the readers read, the compared numbers, and the
    device's peak memory."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: "Record"
    numbers: Dict[str, float]
    memory_peak_bytes: int


class Phases:
    """Host seconds of each part of a set-up, printed on stderr as they
    end (the harness's own record; no metric reads it)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"setup {name} {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------- spans

class Spans:
    """Spans recorded from the benchmark's own files around calls into the
    program. Host spans take the host clock; device spans put a pair of
    CUDA events on the current stream, read once at the end, so no span
    synchronises. Each span is also a profiler range `pb.<name>`. Off, every
    span is a null context and nothing is recorded."""

    def __init__(self, enabled: bool, device):
        import torch

        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self._host: Dict[str, List[float]] = {}
        self._events: Dict[str, list] = {}

    @contextlib.contextmanager
    def host(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(f"pb.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)

    def event(self):
        """A recorded CUDA event (None off the GPU or when off)."""
        if not (self.enabled and self.cuda):
            return None
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add_device(self, name: str, start, end) -> None:
        if start is not None and end is not None:
            self._events.setdefault(name, []).append((start, end))

    @contextlib.contextmanager
    def device(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(f"pb.{name}"):
            start = self.event()
            try:
                yield
            finally:
                self.add_device(name, start, self.event())

    def host_ms(self, name: str) -> List[float]:
        return list(self._host.get(name, ()))

    def device_ms(self, name: str) -> List[float]:
        """Elapsed ms of each device span (synchronises once)."""
        pairs = self._events.get(name, ())
        if pairs:
            pairs[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in pairs]


# -------------------------------------------------------------- the profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160   # a device operation's name in `breakdown`, at most


class Profile:
    """torch.profiler over a short steady stretch of the traced window. The
    chrome trace is written under `out_dir` (the run's TMPDIR) and read
    back: device intervals (kernels, copies, sets), the stretch's host range
    `pb.window`, and the benchmark's host spans `pb.*`."""

    def __init__(self, out_dir: Path, device):
        self.out_dir = Path(out_dir)
        self.device = device
        self.prof = None
        self._range = None
        self.t_start = 0.0
        self.host_s: Optional[float] = None
        self.summary: Optional[dict] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.t_start = time.perf_counter()
        sync(self.device)
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._range = torch.profiler.record_function("pb.window")
        self._range.__enter__()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.host_s is None

    def stop(self) -> None:
        """End the stretch; `host_s` is the host time from start() to
        here, the profiler's own start and stop included."""
        sync(self.device)
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.host_s = time.perf_counter() - self.t_start

    def read(self) -> dict:
        """Export the trace under `out_dir`, summarize it, delete it."""
        path = self.out_dir / "pb_trace.json"
        self.prof.export_chrome_trace(str(path))
        self.summary = summarize_trace(load_json(path))
        path.unlink()
        return self.summary


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize_trace(trace: dict) -> dict:
    """busy_s and window_s of the stretch, device seconds by kernel name,
    the ten device operations that took most time, and the ten longest idle
    gaps named by the benchmark span the host was in."""
    events = [e for e in trace.get("traceEvents", ())
              if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == "pb.window"]
    if not window:
        raise RuntimeError("the trace holds no pb.window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, float] = {}
    clipped = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        clipped.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][3:]) for e in events
                   if str(e.get("name", "")).startswith("pb.")
                   and e.get("name") != "pb.window"
                   and e.get("cat") == "user_annotation")
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inner = [s for s in spans if s[0] <= mid < s[1]]
            # the innermost span: the one that started last
            name = max(inner)[2] if inner else "outside any span"
            gaps.append([name, (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    ops = [(k if len(k) <= NAME_CHARS else k[:NAME_CHARS - 3] + "...", v)
           for k, v in ops]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "kernels": by_name,
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": gaps[:10]}


# ---------------------------------------------------------------- readers

@dataclasses.dataclass
class Record:
    """What a run hands its per-layer readers: spans (ms per span),
    counters, the profiled stretch's summary (None untraced), and the
    cell's files."""

    cell: Cell
    spans: Dict[str, List[float]]
    counters: Dict[str, float]
    profile: Optional[dict]

    def mean(self, span: str) -> Optional[float]:
        xs = self.spans.get(span) or []
        return sum(xs) / len(xs) if xs else None

    def kernel_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds `name` in the
        profiled stretch (None when none ran there)."""
        if not self.profile:
            return None
        s = sum(v for k, v in self.profile["kernels"].items() if name in k)
        return s if s > 0 else None

    def idle_pct(self) -> Optional[float]:
        p = self.profile
        if not p or p["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def reader(metric: str) -> Callable[[Record], Optional[float]]:
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell_name: str, bench: dict, kind: str) -> List[dict]:
    """The cell's end-to-end (`end_to_end`) or per-layer (`per_layer`)
    metrics: those without a `workloads` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


# ----------------------------------------------------------------- result

def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
         device: dict, checks: Dict[str, dict],
         breakdown: Optional[dict] = None) -> None:
    """Each compared number beside its limit as the last lines on stderr,
    then the result as the last line on stdout, `checks` its last key."""
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    print(json.dumps(out), flush=True)
