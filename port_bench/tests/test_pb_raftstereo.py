"""Whole runs of the RAFT-Stereo cell (`train-raftstereo-1k`) at a small
size on the CPU, at the cell's batch of two pairs: it comes out correct,
and through `run.main` the comparison catches the faults its timed path
can have and the control one precision lower, under the committed limits.
Also drivers/train_raftstereo.py reading the iterations' device time from
a trace."""

from __future__ import annotations

import copy
import dataclasses
import json

import pytest
import torch

from conftest import run_small, write_small

CELL = "train-raftstereo-1k"


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    """The small benchmark, with the window's first step of this cell
    profiled, so that a traced run on a slow host still profiles one."""
    base = tmp_path_factory.mktemp("small_raftstereo")
    bench = write_small(base)
    cell = base / "workloads" / f"{CELL}.json"
    wl = dict(json.loads(cell.read_text()), profile_after=0)
    cell.write_text(json.dumps(wl))
    traffic = json.loads((base / "traffic" /
                          f"{wl['traffic']}.json").read_text())
    assert traffic["batch"] == 2
    return copy.deepcopy(bench), base


def test_cell_is_correct_and_traced(small_cell):
    out = run_small(small_cell, CELL, 2 ** 33 + 29, trace=1, seconds=4)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    # CPU spans run on the host clock; the trace has no kernels here
    assert {"train.net.update_ms", "train.net.encoder_ms",
            "train.net.instancenorm_ms", "train.stereo.corr_mib",
            "device.idle.train"} <= set(out["metrics"])
    assert "train.net.update_kernel_ms" not in out["metrics"]
    # the mfu reads the window's steps outside the profiled one
    assert ("train.mfu" in out["metrics"]) == (out["attempted"] > 1)


def _halve(x):
    """The first half of every batched tensor of a StereoSample."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _halve(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x[:max(1, x.shape[0] // 2)]
    return x


def _fault_half_batch(mp):
    """Each step on the first pair of its two."""
    from gps_gaussian_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda batch, mark=None: step(_halve(batch), mark)

    mp.setattr(trainer, "make_train_step", make_half)


def _fault_step_unchanged(mp):
    from gps_gaussian_tpu_torch.train import state

    mp.setattr(state.TrainState, "apply_gradients",
               lambda self: torch.zeros(()))


def _control_in_the_programs_place(mp):
    """The reference one precision below the configuration's (fp8
    convolutions) answers for the program."""
    from port_bench.drivers import train_raftstereo

    mp.setattr(train_raftstereo.RaftStereoTrainRun, "program_answers",
               lambda self: self.reference_answers(control=True))


@pytest.mark.parametrize("fault", [_fault_half_batch,
                                   _fault_step_unchanged,
                                   _control_in_the_programs_place],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_fault_is_not_correct(small_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = run_small(small_cell, CELL, 2 ** 35 + 7)
    assert not out["correct"], out["checks"]


def test_kernel_ms_within_sums_launches_inside_the_spans():
    """A device operation counts where its launch, matched by correlation
    id, lies inside a range of the name, wherever it ran on the card."""
    from port_bench.drivers.train_raftstereo import kernel_ms_within

    def ev(name, ts, dur, cat, corr=None):
        e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        ev("net.update", 0, 100, "user_annotation"),
        ev("net.update", 200, 100, "user_annotation"),
        ev("cudaLaunchKernel", 10, 5, "cuda_runtime", 1),
        ev("cuLaunchKernel", 250, 5, "cuda_driver", 2),
        ev("cudaMemsetAsync", 290, 5, "cuda_runtime", 3),
        ev("cudaLaunchKernel", 150, 5, "cuda_runtime", 4),   # between
        ev("gemm", 400, 30, "kernel", 1),        # runs after its range
        ev("gru", 260, 20, "kernel", 2),
        ev("Memset", 500, 4, "gpu_memset", 3),
        ev("other", 160, 50, "kernel", 4),
    ]}
    assert kernel_ms_within(trace, "net.update") == pytest.approx(54e-3)
    assert kernel_ms_within(trace, "net.encoder") is None
