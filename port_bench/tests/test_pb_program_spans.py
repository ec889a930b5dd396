"""The readers of the program's own spans and counters
(`port_bench/program_spans.py`, the metrics that read it): their values on
hand-made records, None where the program has no tracer (as on a commit
before it), and whole small traced runs on the CPU that print every one."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from conftest import BENCH, ROOT, run_small
from port_bench import harness

NEW = {
    "serve-seq-1view": {
        "serve.read.decode_ms", "serve.read.rectify_ms",
        "serve.read.remap_ms", "serve.read.normalize_ms",
        "serve.read.decode_use", "serve.upload_ms", "serve.copy_ms",
        "serve.unspanned_ms", "serve.net.stereo_ms",
        "serve.net.groupnorm_ms", "serve.raster.prep_ms"},
    "train-s2-2k": {"train.net.groupnorm_ms", "train.raster.prep_ms"},
}


def _rec(name, request, ms, parent=None, self_ms=None):
    return {"name": name, "request": request, "parent": parent, "ms": ms,
            "self_ms": ms if self_ms is None else self_ms}


# two profiled frames (requests 7 and 8) after an older one (request 3)
FRAMES = [
    _rec("frame", 3, 999.0, self_ms=99.0),
    _rec("read.decode", 3, 500.0, "read"),
    _rec("frame", 7, 400.0, self_ms=10.0),
    _rec("read", 7, 300.0, "frame"),
    _rec("read.decode", 7, 40.0, "read"),
    _rec("read.decode", 7, 60.0, "read"),
    _rec("read.rectify", 7, 100.0, "read"),
    _rec("read.remap", 7, 80.0, "read"),
    _rec("read.normalize", 7, 20.0, "read"),
    _rec("frame.upload", 7, 2.0, "frame"),
    _rec("net.encoder", 7, 10.0, "frame"),
    _rec("net.groupnorm", 7, 3.0, "net.encoder"),
    _rec("net.stereo", 7, 30.0, "frame"),
    _rec("net.groupnorm", 7, 5.0, "net.stereo"),
    _rec("raster.project", 7, 1.5, "frame"),
    _rec("raster.sort", 7, 4.5, "frame"),
    _rec("frame.copy", 7, 20.0, "frame"),
    _rec("frame", 8, 420.0, self_ms=14.0),
    _rec("read.decode", 8, 120.0, "read"),
    _rec("read.rectify", 8, 110.0, "read"),
    _rec("read.remap", 8, 90.0, "read"),
    _rec("read.normalize", 8, 30.0, "read"),
    _rec("frame.upload", 8, 4.0, "frame"),
    _rec("net.encoder", 8, 12.0, "frame"),
    _rec("net.stereo", 8, 28.0, "frame"),
    _rec("net.groupnorm", 8, 9.0, "net.gs"),
    _rec("raster.project", 8, 2.5, "frame"),
    _rec("raster.sort", 8, 5.5, "frame"),
    _rec("frame.copy", 8, 22.0, "frame"),
]
SERVE_WANT = {
    "serve.read.decode_ms": 110.0, "serve.read.rectify_ms": 105.0,
    "serve.read.remap_ms": 85.0, "serve.read.normalize_ms": 25.0,
    "serve.read.decode_use": 50.0, "serve.upload_ms": 3.0,
    "serve.copy_ms": 21.0, "serve.unspanned_ms": 12.0,
    "serve.net.stereo_ms": 40.0, "serve.net.groupnorm_ms": 8.5,
    "serve.raster.prep_ms": 7.0,
}
STEPS = [
    _rec("step", 1, 240.0),
    _rec("net.groupnorm", 1, 30.0, "net.encoder"),
    _rec("net.groupnorm", 1, 4.0, "net.gs"),
    _rec("raster.project", 1, 1.0, "step"),
    _rec("raster.sort", 1, 3.0, "step"),
    _rec("step", 2, 242.0),
    _rec("net.groupnorm", 2, 36.0, "net.encoder"),
    _rec("raster.project", 2, 1.0, "step"),
    _rec("raster.sort", 2, 5.0, "step"),
]
TRAIN_WANT = {"train.net.groupnorm_ms": 35.0, "train.raster.prep_ms": 5.0}


def _run(workload: dict):
    return SimpleNamespace(cell=SimpleNamespace(workload=workload))


@pytest.fixture
def program(monkeypatch):
    from gps_gaussian_tpu_torch.utils import profiling

    def use(recs, counters):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    return use


@pytest.mark.parametrize("metric", sorted(SERVE_WANT))
def test_serve_reader_on_hand_made_records(program, metric):
    program(FRAMES, {"read.files_needed": 8, "read.files_decoded": 16})
    got = harness.reader(metric)(_run({"profile_frames": 2}))
    assert got == pytest.approx(SERVE_WANT[metric])


@pytest.mark.parametrize("metric", sorted(TRAIN_WANT))
def test_train_reader_on_hand_made_records(program, metric):
    program(STEPS, {})
    got = harness.reader(metric)(_run({"profile_steps": 2}))
    assert got == pytest.approx(TRAIN_WANT[metric])


def test_readers_find_nothing_where_nothing_was_recorded(program):
    program([], {})
    for metric in sorted(SERVE_WANT) + sorted(TRAIN_WANT):
        assert harness.reader(metric)(_run({"profile_frames": 2,
                                            "profile_steps": 2})) is None


def test_readers_give_none_without_the_tracer(monkeypatch):
    from gps_gaussian_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(profiling, "counters")
    for metric in sorted(SERVE_WANT) + sorted(TRAIN_WANT):
        assert harness.reader(metric)(_run({"profile_frames": 4,
                                            "profile_steps": 2})) is None


def test_every_new_metric_is_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert cell in declared[name]["workloads"]
            assert (BENCH / "metrics" / f"{name}.py").exists()
    assert "train-s1-1k" in declared["train.net.groupnorm_ms"]["workloads"]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_prints_the_program_span_metrics(small_bench, cell):
    # a window long enough to reach its profiled stretch on a loaded host
    out = run_small(small_bench, cell, 2 ** 35 + 11, trace=1, seconds=10)
    assert out["correct"]
    got = out["metrics"]
    assert NEW[cell] <= set(got)
    if cell == "serve-seq-1view":
        assert got["serve.read.decode_use"]["value"] == 50.0
        parts = sum(got[f"serve.read.{k}_ms"]["value"] for k in
                    ("decode", "rectify", "remap", "normalize"))
        assert parts > 0
    for name in NEW[cell]:
        assert got[name]["value"] > 0, name


def test_traced_run_without_the_tracer_still_prints(small_bench,
                                                     monkeypatch):
    from gps_gaussian_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(profiling, "counters")
    out = run_small(small_bench, "serve-seq-1view", 2 ** 35 + 12, trace=1,
                    seconds=10)
    assert out["correct"]
    assert not NEW["serve-seq-1view"] & set(out["metrics"])
    assert "serve.read_ms" in out["metrics"]
