"""Faults confined to part of the work, planted in the timed path at a small
size on the CPU, each seen to come out not correct through `run.main`: a
training loss taken over half of every batch while the forward runs over
all of it (the drop counters stay as they are), and a served frame whose
Gaussians are wrong in one region alone (1% of them, their colours or
their positions)."""

from __future__ import annotations

import pytest
import torch

from conftest import run_small


def _loss_over_half_the_rows(mp):
    from gps_gaussian_tpu_torch.train import losses

    l1, ssim, seq = losses.l1_loss, losses.ssim, losses.sequence_loss

    def half(x):
        return x[:max(1, x.shape[0] // 2)]

    def half_stacked(x):
        # the flow stacks the left views over the right views
        b = x.shape[0] // 2
        k = max(1, b // 2)
        return torch.cat([x[:k], x[b:b + k]])

    mp.setattr(losses, "l1_loss", lambda a, b: l1(half(a), half(b)))
    mp.setattr(losses, "ssim",
               lambda a, b, *args, **kw: ssim(half(a), half(b), *args, **kw))
    mp.setattr(losses, "sequence_loss",
               lambda preds, gt, valid, *args, **kw: seq(
                   [half_stacked(p) for p in preds], half_stacked(gt),
                   half_stacked(valid), *args, **kw))


@pytest.mark.parametrize("cell", ["train-s2-2k", "train-s1-1k"])
def test_loss_over_half_the_batch_is_not_correct(small_bench, monkeypatch,
                                                  cell):
    _loss_over_half_the_rows(monkeypatch)
    out = run_small(small_bench, cell, 2 ** 35 + 17)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("field", ["rgb", "xyz"])
def test_gaussians_wrong_in_one_region_are_not_correct(small_bench,
                                                       monkeypatch, field):
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
    from port_bench.drivers.serve import alter_region

    gaussians = FreeviewRenderer.gaussians
    monkeypatch.setattr(FreeviewRenderer, "gaussians",
                        lambda self, batch: alter_region(
                            gaussians(self, batch), field))
    out = run_small(small_bench, "serve-seq-1view", 2 ** 35 + 23)
    assert not out["correct"], out["checks"]
