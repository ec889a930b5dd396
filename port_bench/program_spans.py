"""What the readers of the program's own spans and counters share.

The program's tracer (`gps_gaussian_tpu_torch.utils.profiling`) records
spans and counters only while a torch profiler records, so in a traced run
it holds the profiled stretch alone: its last requests are the stretch's
frames or steps (`profile_frames` / `profile_steps` of the cell). A reader
sums a set of spans per request and takes the mean over those requests.

Where the program has no tracer (`records`, `counters`), or recorded none
of the spans asked for, every function here returns None, and the metric
is left out of the result line.
"""

from __future__ import annotations

from typing import Iterable, Optional


def _tracer():
    try:
        from gps_gaussian_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "records") and hasattr(profiling, "counters")):
        return None
    return profiling


def stretch(run) -> int:
    """Frames or steps in the cell's profiled stretch."""
    wl = run.cell.workload
    return int(wl.get("profile_frames") or wl.get("profile_steps") or 0)


def per_request(run, root: str, names: Iterable[str],
                field: str = "ms") -> Optional[float]:
    """Mean over the stretch's requests (the last `stretch(run)` top-level
    `root` spans: "frame" or "step") of the sum of `field` ("ms" or
    "self_ms") over the spans named `names` in each request."""
    tracer = _tracer()
    n = stretch(run)
    if tracer is None or n <= 0:
        return None
    recs = tracer.records()
    roots = [r for r in recs if r["name"] == root and r["parent"] is None]
    roots = roots[-n:]
    ids = {r["request"] for r in roots}
    names = set(names)
    picked = [r[field] for r in recs
              if r["request"] in ids and r["name"] in names]
    if not roots or not picked:
        return None
    return sum(picked) / len(roots)


def counter_share(num: str, den: str) -> Optional[float]:
    """100 x counter `num` over counter `den`, %."""
    tracer = _tracer()
    if tracer is None:
        return None
    c = tracer.counters()
    if not c.get(den) or num not in c:
        return None
    return 100.0 * c[num] / c[den]
