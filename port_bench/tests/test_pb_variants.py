"""The comparison that decides `correct` against sound variants of the
reference and of the program, at a small size on the CPU: the variant hook
of the reference, the program with its norms or convolutions summed in
another order coming out correct through `run.main`, the serving driver
filing a read that runs ahead under its own frame, the control in the
program's place coming out not correct, and the calibration tool reading
every kind of reading through any driver."""

from __future__ import annotations

import copy
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from conftest import run_small

REORDERED_CELLS = ["serve-seq-1view", "train-s2-2k", "train-s1-1k"]


def _small_model(recipe_file: str):
    from conftest import ROOT
    from port_bench.drivers.train import seeded_weights
    from port_bench.reference import pipeline

    recipe = json.loads((ROOT / recipe_file).read_text())["recipe"]
    model = pipeline.build_model(recipe, with_gs=False)
    seeded_weights(model, 3, "cpu")
    return model


@pytest.mark.parametrize("kind", ["norm_order", "conv_layout"])
def test_variant_hook_sets_and_restores(kind):
    """A variant changes only where the f32 sums run: the flags are set on
    every norm with statistics or every convolution, the network gives the
    plain reference's values to rounding, and None restores its bits."""
    from port_bench.reference import layers

    model = _small_model("port_bench/configs/gps_stage1.json")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = model.img_encoder(x)
        model.set_variant(kind)
        convs = [m for m in model.modules() if isinstance(m, layers.Conv)]
        norms = [m for m in model.modules()
                 if isinstance(m, layers.GroupNorm32)]
        assert all(m.channels_last == (kind == "conv_layout")
                   for m in convs)
        assert all(m.flip == (kind == "norm_order") for m in norms)
        varied = model.img_encoder(x)
        model.set_variant(None)
        again = model.img_encoder(x)
    for a, b, c in zip(plain, varied, again, strict=True):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)
        assert torch.equal(c, a)
    with pytest.raises(ValueError):
        model.set_variant("bf16")


def test_norm_order_keeps_the_per_element_formula():
    """A flipped norm gives the plain norm's values to f32 rounding;
    InstanceNorm32 of the RAFT-Stereo reference flips too."""
    from port_bench.reference import layers, raft_stereo

    x = torch.randn(2, 16, 8, 12, generator=torch.Generator().manual_seed(2))
    for norm in (layers.GroupNorm32(2, 16), raft_stereo.InstanceNorm32(16)):
        plain = norm(x)
        norm.flip = True
        torch.testing.assert_close(norm(x), plain, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["norm_order", "conv_layout"])
@pytest.mark.parametrize("cell", REORDERED_CELLS)
def test_reordered_program_is_correct(small_bench, cell, kind):
    """The program with its GroupNorms (or convolutions) summing in another
    order, patched for this test alone, comes out correct."""
    from port_bench.tools.calibrate import program_variant

    with program_variant(kind):
        out = run_small(small_bench, cell, 2 ** 33 + 17)
    assert out["correct"], out["checks"]


def _prefetching_sequence(self, ratio: float = 0.5):
    """infer_sequence with the next frame read before this one renders, as
    a read that overlaps the card would run."""
    from gps_gaussian_tpu_torch.data.loader import collate

    out_res = self._out_res()
    n = len(self.dataset)
    ahead = self.dataset.get_test_sample(0)
    for idx in range(n):
        sample = ahead
        gauss = self.gaussians(collate([sample]))
        if idx + 1 < n:
            ahead = self.dataset.get_test_sample(idx + 1)
        cam = self.novel_camera_at(sample, ratio, out_res, out_res)
        img, _ = self.render(gauss, cam)
        yield sample["name"], self._to_host(img)
    self.flush_drop_report()


def test_read_ahead_is_compared_as_its_own_frame(small_bench, monkeypatch):
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer

    monkeypatch.setattr(FreeviewRenderer, "infer_sequence",
                        _prefetching_sequence)
    out = run_small(small_bench, "serve-seq-1view", 2 ** 33 + 41)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", REORDERED_CELLS)
def test_control_in_the_programs_place_is_not_correct(small_bench,
                                                      monkeypatch, cell):
    """The reference one precision below the configuration's answers for
    the program through `run.main`."""
    from port_bench import harness

    bench, base = small_bench
    run = harness.driver(harness.load_cell(cell, bench, base)
                         .workload["driver"]).Run
    monkeypatch.setattr(run, "program_answers",
                        lambda self: self.reference_answers(control=True))
    out = run_small(small_bench, cell, 2 ** 35 + 11)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["serve-seq-1view", "train-raftstereo-1k"])
def test_calibration_reads_every_kind_of_reading(small_bench, cell):
    """One seed of tools/calibrate.py through the cell's own driver: the
    program, both variants, the control and the faults, each number
    named; the planted faults fail the committed limits."""
    from port_bench import harness, judge
    from port_bench.reference.layers import VARIANTS
    from port_bench.tools import calibrate

    bench, base = small_bench
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = calibrate.main(["--workload", cell, "--seeds", str(2 ** 33 + 3),
                             "--seconds", "0.2", "--control", "1",
                             "--variants", "1"], device="cpu",
                            bench=copy.deepcopy(bench), base=base)
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    limits = harness.load_cell(cell, bench, base).workload["limits"]
    assert out["correct"]
    assert set(out["variants"]) == set(VARIANTS)
    for numbers in [out["program"], out["control"], *out["variants"].values(),
                    *out["faults"].values()]:
        assert set(limits) <= set(numbers)
    for name, numbers in out["faults"].items():
        if name == "uncounted":
            # a lost drop counter reads 1 where the caps dropped a pair,
            # which they do at full size and not at this one
            assert numbers["drop_gap"] == float(
                out["reference_drops"][0][0] > 0)
        else:
            assert not judge.passed(judge.checks(numbers, limits)), name
