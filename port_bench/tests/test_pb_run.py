"""Whole runs of the benchmark at a small size on the CPU: the command
refuses to run without the card, each cell comes out correct, a traced run
reports its per-layer metrics, and the comparison catches the faults a
timed path can have and the control one precision lower."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from conftest import run_small

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["serve-seq-1view", "serve-interp-5view", "train-s2-2k",
         "train-s1-1k"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "serve-seq-1view", "--seed", "3000000000", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(small_bench, cell):
    out = run_small(small_bench, cell, 2 ** 33 + 17)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"


# what a CPU run can read: host spans and counters; CUDA events and the
# device trace's kernels are the card's
ON_THE_CPU = {"serve-seq-1view": {"serve.read_ms", "serve.mfu",
                                  "device.idle.serve"},
              "train-s2-2k": {"train.mfu", "device.idle.train"}}


@pytest.mark.parametrize("cell", sorted(ON_THE_CPU))
def test_traced_run_reports_per_layer_metrics(small_bench, cell):
    bench = small_bench[0]
    out = run_small(small_bench, cell, 2 ** 34 + 3, trace=1, seconds=5)
    assert out["correct"]
    mine = {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])}
    got = set(out["metrics"])
    assert ON_THE_CPU[cell] <= got <= mine
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _halve(x):
    """The first half of every batched tensor of a StereoSample."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _halve(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x[:max(1, x.shape[0] // 2)]
    return x


def _fault_step_unchanged(mp):
    from gps_gaussian_tpu_torch.train import state

    mp.setattr(state.TrainState, "apply_gradients",
               lambda self: torch.zeros(()))


def _fault_half_batch(mp):
    from gps_gaussian_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda batch, mark=None: step(_halve(batch), mark)

    mp.setattr(trainer, "make_train_step", make_half)


def _fault_altered_image(mp):
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer

    render = FreeviewRenderer.render

    def altered(self, gauss, camera):
        img, aux = render(self, gauss, camera)
        img = img.clone()
        img[:, img.shape[1] // 2] = 0.0
        return img, aux

    mp.setattr(FreeviewRenderer, "render", altered)


def _fault_half_frame(mp):
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer

    from port_bench.drivers.serve import drop_half

    gaussians = FreeviewRenderer.gaussians

    def half(self, batch):
        g = gaussians(self, batch)
        return dataclasses.replace(g, valid=drop_half(g.valid))

    mp.setattr(FreeviewRenderer, "gaussians", half)


def _fault_altered_source(mp):
    from gps_gaussian_tpu_torch.data.thuman import StereoHumanDataset

    get = StereoHumanDataset.get_test_sample

    def altered(self, index):
        sample = get(self, index)
        img = sample["lmain"]["img"].copy()
        img[img.shape[0] // 2] += 0.5
        sample["lmain"] = dict(sample["lmain"], img=img)
        return sample

    mp.setattr(StereoHumanDataset, "get_test_sample", altered)


@pytest.mark.parametrize("cell,fault", [
    ("train-s2-2k", _fault_step_unchanged),
    ("train-s2-2k", _fault_half_batch),
    ("train-s1-1k", _fault_step_unchanged),
    ("train-s1-1k", _fault_half_batch),
    ("serve-seq-1view", _fault_altered_image),
    ("serve-seq-1view", _fault_altered_source),
    ("serve-seq-1view", _fault_half_frame),
    ("serve-interp-5view", _fault_altered_image),
    ("serve-interp-5view", _fault_half_frame),
], ids=lambda x: x if isinstance(x, str) else x.__name__[7:])
def test_broken_timed_path_is_not_correct(small_bench, monkeypatch, cell,
                                          fault):
    fault(monkeypatch)
    out = run_small(small_bench, cell, 2 ** 35 + 5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_one_precision_lower_is_not_correct(small_bench, cell):
    """The reference one precision below the configuration's, in the
    program's place, fails the cell's committed limits."""
    from port_bench import harness, judge
    from port_bench.drivers import serve, train

    bench, base = small_bench
    c = harness.load_cell(cell, bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Ctx(seed=2 ** 32 + 9, seconds=0.2, trace=False,
                          device=torch.device("cpu"), tmp=Path(tmp),
                          t0=time.perf_counter(),
                          spans=harness.Spans(False, "cpu"))
        if c.workload["driver"] == "serve":
            run = serve.ServeRun(c, ctx)
            run.setup()
            ref = run.reference_answers()
            numbers = judge.serve_numbers(
                run.reference_answers(control=True), ref)
        else:
            run = train.TrainRun(c, ctx)
            run.setup()
            ref = run.reference_answers()
            numbers = judge.train_numbers(
                run.reference_answers(control=True), ref)
    checked = judge.checks(numbers, c.workload["limits"])
    assert not judge.passed(checked), json.dumps(checked)


def test_trace_summary_unions_device_time_and_names_gaps():
    """Busy time is the union of device intervals clipped to the stretch;
    each idle gap is named by the innermost benchmark span around it."""
    from port_bench import harness

    def ev(name, ts, dur, cat):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}

    trace = {"traceEvents": [
        ev("pb.window", 0, 1000, "user_annotation"),
        ev("pb.read", 100, 300, "user_annotation"),
        ev("pb.forward", 400, 400, "user_annotation"),
        ev("k1", -50, 100, "kernel"),          # clipped to [0, 50)
        ev("k2", 450, 200, "kernel"),
        ev("Memcpy", 600, 100, "gpu_memcpy"),  # overlaps k2
        ev("host op", 0, 1000, "cpu_op"),
    ]}
    s = harness.summarize_trace(trace)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(300e-6)
    assert s["kernels"]["k1"] == pytest.approx(50e-6)
    # gaps [50, 450) inside pb.read and [700, 1000) after pb.forward ends
    assert [g[0] for g in s["idle_gaps"]] == ["read", "outside any span"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([400e-6,
                                                            300e-6])
