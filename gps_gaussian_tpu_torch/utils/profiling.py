"""The port's tracer: named spans and counters at the program's layer
boundaries, and `maybe_trace`, which writes a torch.profiler trace.

Spans and counters record only while a torch profiler records
(`maybe_trace`, `Trainer.train(trace_steps=...)`, or any
`torch.profiler.profile` around the work); there is no other switch. With
no profiler recording, a span is one check of the profiler's flag and
returns: no `record_function`, no CUDA event, no record. While one records,
every span is also a `record_function` range of the same name, so the
program's spans sit on the profiler's timeline beside the kernels and
copies.

    with span("read"):                        # host clock
        ...
    with device_span("net.stereo", device):   # CUDA events on the stream
        ...
    count("read.files_decoded")

A span records its name, its host start and end, the enclosing span (its
parent) and a request id: a span opened with `request=True` (a served
`frame`, a training `step`) opens a new request, and every span nested
under it carries its id. The enclosing span is tracked per thread and task
(`contextvars`), so loader threads do not share a parent; torch's profiler
records the thread that started it, and a span in another thread records
nothing. Records stay in memory, the last `BUFFER` spans; a device span
keeps its events unread and no span synchronises. `records()` resolves
them (one synchronisation), `counters()` reads the counters and `clear()`
empties both.

Activation checkpointing runs the model's forward again inside the
backward; spans opened while autograd runs a backward are skipped, so a
forward span counts the forward once.

Counterpart of gps_gaussian_tpu/utils/profiling.py `maybe_trace` :49.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

BUFFER = 4096   # spans kept, the newest

_recording = torch._C._autograd._profiler_enabled
_in_backward = torch._C._current_graph_task_id   # -1 outside a backward


class _Null:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "cuda", "opens", "request", "id", "parent", "t0",
                 "t1", "ev0", "ev1", "_fn", "_token")

    def __init__(self, name: str, cuda: bool, opens: bool):
        self.name, self.cuda, self.opens = name, cuda, opens
        self.ev0 = self.ev1 = None

    def __enter__(self):
        parent = _current.get()
        self.parent = parent
        self.id = next(_ids)
        if self.opens:
            self.request = next(_requests)
        else:
            self.request = parent.request if parent is not None else None
        self._token = _current.set(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.t1 = time.perf_counter()
        self._fn.__exit__(*exc)
        _current.reset(self._token)
        self._fn = self._token = None
        _spans.append(self)
        return False


_current: contextvars.ContextVar[Optional[_Span]] = contextvars.ContextVar(
    "gps_span", default=None)
_spans: collections.deque = collections.deque(maxlen=BUFFER)
_counters: Dict[str, float] = {}
_lock = threading.Lock()
_ids = itertools.count()
_requests = itertools.count()


def span(name: str, request: bool = False):
    """A span on the host clock (a context manager); `request` opens a new
    request id for it and the spans under it."""
    if not _recording() or _in_backward() != -1:
        return _NULL
    return _Span(name, False, request)


def device_span(name: str, device, request: bool = False):
    """A span timed by a pair of CUDA events on the current stream when
    `device` (a torch.device or its name) is a CUDA device, else by the
    host clock: work on the CPU is synchronous."""
    if not _recording() or _in_backward() != -1:
        return _NULL
    return _Span(name, torch.device(device).type == "cuda", request)


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name` (while a profiler records)."""
    if not _recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def clear() -> None:
    """Forget every recorded span and counter."""
    _spans.clear()
    with _lock:
        _counters.clear()


def _covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals within [lo, hi)."""
    total, end = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def records() -> List[dict]:
    """The recorded spans in the order they started, as plain dicts:

    `name`, `id`, `parent` (the enclosing span's name, None at the top),
    `parent_id`, `request` (None outside any request), `clock` ("host" or
    "cuda"), `host_start_ms` / `host_end_ms` (the host clock when the span
    was entered and left), `start_ms` / `end_ms` (the span on its own clock:
    the host's, or for a CUDA span the device's, placed so that the first
    CUDA span's start is its host start), `ms` (end - start) and `self_ms`.

    Self time is a span's duration minus the union of its direct children's
    intervals on the span's clock: the children's host intervals under a
    host span, the CUDA children's device intervals under a CUDA span (a
    host child of a CUDA span is not subtracted). Resolving the CUDA
    events synchronises once."""
    spans = sorted(_spans, key=lambda s: s.t0)
    cuda = [s for s in spans if s.cuda]
    anchor = None
    if cuda:
        torch.cuda.synchronize()
        anchor = cuda[0]
    out, by_id = [], {}
    for s in spans:
        host = (s.t0 * 1e3, s.t1 * 1e3)
        if s.cuda:
            base = anchor.t0 * 1e3
            start = base + anchor.ev0.elapsed_time(s.ev0)
            end = base + anchor.ev0.elapsed_time(s.ev1)
        else:
            start, end = host
        rec = {"name": s.name, "id": s.id,
               "parent": s.parent.name if s.parent is not None else None,
               "parent_id": s.parent.id if s.parent is not None else None,
               "request": s.request, "clock": "cuda" if s.cuda else "host",
               "host_start_ms": host[0], "host_end_ms": host[1],
               "start_ms": start, "end_ms": end, "ms": end - start}
        out.append(rec)
        by_id[s.id] = rec
    children: Dict[int, list] = {}
    for rec in out:
        if rec["parent_id"] in by_id:
            children.setdefault(rec["parent_id"], []).append(rec)
    for rec in out:
        kids = children.get(rec["id"], ())
        if rec["clock"] == "host":
            iv = [(c["host_start_ms"], c["host_end_ms"]) for c in kids]
        else:
            iv = [(c["start_ms"], c["end_ms"]) for c in kids
                  if c["clock"] == "cuda"]
        rec["self_ms"] = rec["ms"] - _covered(iv, rec["start_ms"],
                                              rec["end_ms"])
    return out


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], name: str = "trace.json"):
    """torch.profiler trace of the block (host, and the card when there is
    one) written to trace_dir/name as a Chrome trace; a no-op when
    trace_dir is None or empty. The program's spans record while it runs."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / name))
