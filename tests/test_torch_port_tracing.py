"""The port's tracer (utils/profiling.py) and its spans at the program's
layer boundaries, on the CPU at small sizes.

Spans and counters record only while a torch profiler records; with none,
a span creates no `record_function`, no CUDA event and no record. Under a
profiler: parents, request ids, self time, the bounded buffer, and the
spans of one served frame (`infer_sequence` over a 64^2 tree on disk) and
of one stage-2 training step, with activation checkpointing's second
forward left out.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from gps_gaussian_tpu_torch.cli.common import traced_frames
from gps_gaussian_tpu_torch.data import synth
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import silhouette_train_batch
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import state as tstate
from gps_gaussian_tpu_torch.train import trainer
from gps_gaussian_tpu_torch.utils import profiling

from thread_budget import thread_budget  # noqa: F401

RES = 64
TINY = dict(
    batch_size=1,
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32],
              train_iters=1, val_iters=1),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=8192),
    dataset=dict(src_res=RES, use_hr_img=False, num_workers=0))


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_spans_record_nothing_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("created while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with profiling.span("a", request=True):
        with profiling.device_span("b", "cuda"):
            profiling.count("c", 3)
    assert profiling.records() == [] and profiling.counters() == {}


def test_nested_spans_carry_parent_and_request(tmp_path):
    with profiling.maybe_trace(str(tmp_path), "t.json"):
        for _ in range(2):
            with profiling.span("gps_frame", request=True):
                with profiling.span("gps_read"):
                    with profiling.span("gps_read.decode"):
                        torch.ones(8).sum()
                with profiling.device_span("gps_net", "cpu"):
                    torch.ones(32, 32).matmul(torch.ones(32, 32))
        with profiling.span("gps_outside"):
            pass
    recs = profiling.records()
    assert [r["name"] for r in recs] == [
        "gps_frame", "gps_read", "gps_read.decode", "gps_net"] * 2 + [
        "gps_outside"]
    by = _by_name(recs)
    assert [r["parent"] for r in by["gps_read.decode"]] == ["gps_read"] * 2
    assert [r["parent"] for r in by["gps_net"]] == ["gps_frame"] * 2
    assert by["gps_frame"][0]["parent"] is None
    reqs = [r["request"] for r in by["gps_frame"]]
    assert reqs[0] != reqs[1]
    for r in recs[:8]:
        assert r["request"] == reqs[0 if r in recs[:4] else 1]
    assert by["gps_outside"][0]["request"] is None
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"gps_frame", "gps_read", "gps_read.decode", "gps_net"} <= names


def test_self_time_is_duration_minus_the_union_of_children():
    with _profiled():
        with profiling.span("top"):
            time.sleep(0.002)
            with profiling.span("kid"):
                time.sleep(0.004)
                with profiling.span("grandkid"):
                    time.sleep(0.002)
            with profiling.span("kid"):
                time.sleep(0.003)
    recs = profiling.records()
    top, kid1, grand, kid2 = recs
    covered = (kid1["host_end_ms"] - kid1["host_start_ms"]) + \
        (kid2["host_end_ms"] - kid2["host_start_ms"])
    assert top["self_ms"] == pytest.approx(top["ms"] - covered)
    assert top["self_ms"] >= 1.5
    assert kid1["self_ms"] == pytest.approx(kid1["ms"] - grand["ms"])
    assert grand["self_ms"] == grand["ms"]


def test_device_span_on_the_cpu_takes_the_host_clock():
    with _profiled():
        with profiling.device_span("dev", torch.device("cpu")):
            time.sleep(0.003)
    (r,) = profiling.records()
    assert r["clock"] == "host"
    assert r["ms"] == pytest.approx(r["host_end_ms"] - r["host_start_ms"])
    assert r["ms"] >= 3.0


def test_the_buffer_stays_bounded():
    with _profiled():
        for i in range(profiling.BUFFER + 10):
            with profiling.span("s"):
                pass
    recs = profiling.records()
    assert len(recs) == profiling.BUFFER
    assert recs[-1]["id"] - recs[0]["id"] == profiling.BUFFER - 1


def test_threads_do_not_share_a_parent():
    """A thread starts with no enclosing span (torch's profiler records
    only the thread that started it, so its spans record nothing)."""
    seen = {}

    def worker():
        seen["enclosing"] = profiling._current.get()
        with profiling.span("loader"):
            pass

    with _profiled():
        with profiling.span("main", request=True):
            t = threading.Thread(target=worker)
            t.start()
            t.join(30)
    assert not t.is_alive()
    assert "enclosing" in seen and seen["enclosing"] is None
    assert [r["name"] for r in profiling.records()] == ["main"]


def test_counters_count_while_recording_and_clear():
    profiling.count("n")
    with _profiled():
        profiling.count("n")
        profiling.count("n", 2)
    assert profiling.counters() == {"n": 3}
    profiling.clear()
    assert profiling.counters() == {}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_tree")
    synth.generate_dataset(root, n_train=2, n_val=0, res=RES, hr=False)
    return root / "train"


def test_served_frames_are_traced(tree):
    cfg = tconfig.load_config(None, **TINY)
    model = trainer.make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(0))
    ds = StereoHumanDataset(DatasetConfig(
        data_root=str(tree), src_res=RES, use_processed_data=False), "test")
    rend = FreeviewRenderer(cfg, model.state_dict(), ds, device="cpu")
    with _profiled():
        images = [img for _, img in rend.infer_sequence(0.5)]
    assert len(images) == 2
    recs = profiling.records()
    by = _by_name(recs)
    frames = by["frame"]
    assert len(frames) == 2 and all(f["parent"] is None for f in frames)
    for name in ("read", "frame.upload", "frame.compact", "net.encoder",
                 "net.stereo", "net.gs", "raster.project", "raster.sort",
                 "raster.composite", "frame.copy"):
        assert len(by[name]) == 2, name
    assert {r["parent"] for r in by["read"]} == {"frame"}
    for name in ("read.rectify", "read.remap", "read.normalize"):
        assert len(by[name]) == 2 and {r["parent"] for r in by[name]} == \
            {"read"}
    # two load_view calls a frame: an image, a mask and the cameras each
    assert len(by["read.decode"]) == 2 * 6
    assert {r["parent"] for r in by["net.groupnorm"]} == {
        "net.encoder", "net.stereo", "net.gs"}
    gn = [r for r in by["net.groupnorm"] if r["request"] ==
          frames[0]["request"]]
    assert len(gn) == sum(isinstance(m, torch.nn.GroupNorm)
                          for m in rend.model.modules())
    c = profiling.counters()
    assert c["read.files_needed"] == c["read.files_decoded"] == 2 * 4
    assert c["read.views_fused"] == c["read.views"] == 2 * 2
    for f in frames:
        mine = [x for x in recs if x["request"] == f["request"]]
        assert len(mine) > 40
        assert 0 <= f["self_ms"] < f["ms"]


@pytest.mark.parametrize("remat", [False, True])
def test_training_step_is_traced(remat):
    cfg = tconfig.load_config(None, **dict(TINY, stage="stage2",
                                           remat=remat))
    model = trainer.make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(1))
    state = tstate.create_state(cfg, model, device="cpu")
    step = trainer.make_train_step(model, cfg, "stage2",
                                   trainer.make_raster_config(cfg), state,
                                   device="cpu")
    batch = silhouette_train_batch(1, RES, RES, 0.3, seed=3)
    with _profiled():
        step(batch)
    by = _by_name(profiling.records())
    (s,) = by["step"]
    assert s["parent"] is None and s["request"] is not None
    for name in ("net.encoder", "net.stereo", "net.gs", "raster.project",
                 "raster.sort", "raster.composite", "step.loss"):
        assert len(by[name]) == 1, name
        assert by[name][0]["request"] == s["request"]
    # the forward's GroupNorms once each, none from the backward
    n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in model.modules())
    assert len(by["net.groupnorm"]) == n_gn


def test_traced_frames_writes_a_trace_of_its_window(tmp_path):
    def frames():
        for i in range(4):
            with profiling.span(f"gps_frame_{i}", request=True):
                torch.ones(8).sum()
            yield i

    args = SimpleNamespace(trace_frames=(1, 3), trace_dir=str(tmp_path),
                           out_dir=str(tmp_path / "out"))
    assert list(traced_frames(frames(), args)) == [0, 1, 2, 3]
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace_frames_1_3.json").read_text())["traceEvents"]}
    assert {"gps_frame_1", "gps_frame_2"} <= names
    assert not {"gps_frame_0", "gps_frame_3"} & names
    args = SimpleNamespace(trace_frames=None, trace_dir=None, out_dir="x")
    assert list(traced_frames(iter([7, 8]), args)) == [7, 8]
