"""RAFT-Stereo in the port (`raft.encoder: raftstereo`, models/raft.py
`MultiLevelRaftStereo`) against the plain reference
(tests/plain_raft_stereo.py) on seeded random weights.

The model is configs/raftstereo_stage1.yaml with its widths cut (encoders
(16, 24, 32), GRU levels 32, 24 and 16 channels finest first, so a level
mix-up shows), 64^2 images, 3 iterations, f32 on the CPU. BatchNorm gets
random running statistics and affine values, so that a BatchNorm run in
training mode, or statistics that move, would show.

Tolerances. Both sides compute in f32; they differ only in the order of
sums (the correlation as einsum or matmul, the lookup through grid_sample
or a gather, the upsampling through unfold or shifted slices) and agree to
about 1e-6 of the flows' size (O(0.1-1)), so predictions are held to 2e-5
absolute. The loss is held to 1e-5 relative. A gradient leaf is held to
1e-4 of its own largest element plus 1e-6 of the largest over all leaves:
a leaf whose gradient is mostly cancellation (the mask head's last bias,
summed away by its softmax but for round-off) differs at the round-off of
the larger leaves it cancels. AdamW's first step moves an element by
lr * g / (|g| + eps), so a gradient known to within d moves it to within
lr * d / (|g| + eps): after one step each element is held as tightly as
its gradient is (the gradient tolerance above, clipped), plus 1e-4 of the
rate for the f32 arithmetic. An element whose gradient is round-off (the
biases before an InstanceNorm, whose gradient is 0 but for it) is held to
no more than the step's own size.

The checks are two test items, the numbers and the wiring, each calling
the `_check_*` functions below in turn: the tier-1 run distributes test
files by their count of items (pytest-xdist's loadfile order), and a file
of a dozen items would be dispatched among the first and push the long
files of few items later, past the run's time limit.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

import plain_raft_stereo as plain
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.models.raft_stereo import RaftStereoModel
from gps_gaussian_tpu_torch.testing import (SilhouetteDataset,
                                            silhouette_train_batch)
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import losses, trainer
from gps_gaussian_tpu_torch.train.state import create_state
from gps_gaussian_tpu_torch.utils import profiling

from thread_budget import thread_budget  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "configs" / "raftstereo_stage1.yaml"
ENC, HIDDEN, RES, ITERS = (16, 24, 32), (16, 24, 32), 64, 3
SMALL = dict(batch_size=1,
             raft=dict(encoder_dims=list(ENC), hidden_dims=list(HIDDEN),
                       train_iters=ITERS, val_iters=ITERS,
                       mixed_precision=False),
             dataset=dict(src_res=RES, num_workers=0))


def _cfg(**extra):
    return tconfig.load_config(str(YAML), **{**SMALL, **extra})


def _random_batchnorm(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)


def _model(cfg):
    model = trainer.make_model(cfg, with_gs=False)
    init_weights(model, torch.Generator().manual_seed(3))
    _random_batchnorm(model, 5)
    return model


def _reference(model):
    ref = plain.RAFTStereo(ENC, HIDDEN[::-1])
    ref.load_state_dict({k.removeprefix("raft_stereo."): v
                         for k, v in model.state_dict().items()})
    ref.train()
    ref.freeze_bn()
    return ref


def _batch(seed=0):
    return silhouette_train_batch(1, RES, 16, seed=seed)


def _nchw(view):
    return view.img.permute(0, 3, 1, 2)


def _ref_loss(ref, batch):
    preds = ref(_nchw(batch.lmain), _nchw(batch.rmain), ITERS)
    flow = torch.cat([batch.lmain.flow, batch.rmain.flow]).permute(0, 3, 1, 2)
    valid = torch.cat([batch.lmain.valid,
                       batch.rmain.valid]).permute(0, 3, 1, 2)
    return plain.sequence_loss(preds, flow, valid)


def _check_model_is_raft_stereo(model):
    assert isinstance(model, RaftStereoModel)
    update = model.raft_stereo.update_block
    assert [update.gru08.convz.out_channels, update.gru16.convz.out_channels,
            update.gru32.convz.out_channels] == [32, 24, 16]
    # the mask of a x4 convex upsampling: 9 taps of 4 x 4 subpixels
    assert update.mask[2].out_channels == 144
    # the recipe's: the encoders run again in the backward
    assert model.raft_stereo.remat_encoders


def _check_predictions(model, ref, test_mode):
    batch = _batch()
    with torch.no_grad():
        ours = model(batch, iters=ITERS, test_mode=test_mode).flow_preds
        theirs = ref(_nchw(batch.lmain), _nchw(batch.rmain), ITERS,
                     test_mode=test_mode)
    assert len(ours) == len(theirs) == (1 if test_mode else ITERS)
    for a, b in zip(ours, theirs):
        assert a.shape == (2, RES, RES, 1)
        torch.testing.assert_close(a, b.permute(0, 2, 3, 1), atol=2e-5,
                                   rtol=0)
    assert float(ours[-1].abs().max()) > 1e-2   # not a zero field


def _saved_bytes_loss_and_gradients(model, step, batch):
    """The step's loss and gradients, and the bytes its forward saved for
    the backward."""
    model.zero_grad(set_to_none=True)
    saved = []

    def pack(t):
        saved.append(t.untyped_storage().nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = step.loss_fn(batch)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return sum(saved), loss.detach(), grads


def _check_first_step_loss_and_gradients(model, ref):
    """Against the plain reference; returns the step, its batch and what
    `_saved_bytes_loss_and_gradients` gives, with the recipe's
    raft.remat_encoders."""
    cfg = _cfg()
    state = create_state(cfg, model, "cpu")
    step = trainer.make_train_step(model, cfg, "stage1", None, state, "cpu")
    batch = _batch(1)
    first = _saved_bytes_loss_and_gradients(model, step, batch)
    _, loss, grads = first
    ref.zero_grad(set_to_none=True)
    ref_loss = _ref_loss(ref, batch)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    grads = {k.removeprefix("raft_stereo."): g for k, g in grads.items()}
    ref_grads = dict((k, p.grad) for k, p in ref.named_parameters())
    assert grads.keys() == ref_grads.keys()
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for k, g in ref_grads.items():
        assert grads[k] is not None, k
        tol = 1e-4 * float(g.abs().max()) + 1e-6 * top
        torch.testing.assert_close(grads[k], g, atol=tol, rtol=0, msg=k)
    return step, batch, first


def _check_encoder_remat_keeps_the_bits(model, step, batch, remat):
    """raft.remat_encoders keeps only the encoders' outputs for the
    backward, which runs the encoders again: against the encoders' kept
    activations, the loss and every gradient to the bit, from fewer
    bytes saved by the forward."""
    model.raft_stereo.remat_encoders = False
    try:
        kept = _saved_bytes_loss_and_gradients(model, step, batch)
    finally:
        model.raft_stereo.remat_encoders = True
    assert torch.equal(remat[1], kept[1])
    for k, g in kept[2].items():
        assert torch.equal(remat[2][k], g), k
    # the encoders' maps at full resolution are most of what is left out
    assert remat[0] < 0.8 * kept[0]


def _check_step_keeps_batchnorm_statistics():
    """One step of the port's stage-1 step: BatchNorm's running statistics
    stay as they were, and the parameters take the reference's AdamW step
    from the frozen-BatchNorm gradient. A BatchNorm in training mode gives
    another loss on these statistics."""
    cfg = _cfg()
    model = _model(cfg)
    ref = _reference(model)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    start = {k.removeprefix("raft_stereo."): p.detach().clone()
             for k, p in model.named_parameters()}
    batch = _batch(2)
    ref_loss = _ref_loss(ref, batch)
    ref_loss.backward()

    state = create_state(cfg, model, "cpu")
    step = trainer.make_train_step(model, cfg, "stage1", None, state, "cpu")
    metrics = step(batch)
    torch.testing.assert_close(metrics["loss"], ref_loss.detach(), rtol=1e-5,
                               atol=0)
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k

    # the one-cycle schedule starts at the peak rate over 25
    lr = cfg.lr / 25.0
    grads = {k: p.grad for k, p in ref.named_parameters()}
    want = plain.adamw_step(start, grads, lr, cfg.wdecay, cfg.grad_clip)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    coef = min(cfg.grad_clip / (total + 1e-6), 1.0)
    top = max(float(g.abs().max()) for g in grads.values())
    for k, p in model.named_parameters():
        k = k.removeprefix("raft_stereo.")
        g = grads[k] * coef
        # the gradient test's tolerance for this leaf, clipped
        known = coef * (1e-4 * float(grads[k].abs().max()) + 1e-6 * top)
        tol = lr * (1e-4 + torch.clamp(known / (g.abs() + 1e-8), max=2.0))
        assert bool(((p.detach() - want[k]).abs() <= tol).all()), k

    live = _reference(_model(cfg))
    for m in live.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.train()
    with torch.no_grad():
        assert abs(float(_ref_loss(live, batch)) - float(ref_loss)) > \
            1e-3 * float(ref_loss)


def _check_refusals():
    """Stage 2 with this encoder is refused; GPS-Gaussian's network runs at
    1/8, and another raft.n_downsample is an error, not ignored, as is
    raft.remat_encoders, which only RAFT-Stereo's encoders take."""
    with pytest.raises(ValueError, match="GSRegresser"):
        trainer.make_model(_cfg(), with_gs=True)
    cfg = tconfig.load_config(None, raft={"n_downsample": 2})
    with pytest.raises(ValueError, match="raft.n_downsample"):
        trainer.make_model(cfg, with_gs=False)
    cfg = tconfig.load_config(None, raft={"remat_encoders": True})
    with pytest.raises(ValueError, match="raft.remat_encoders"):
        trainer.make_model(cfg, with_gs=False)


def _check_spans_and_counters(model):
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(_batch(), iters=ITERS)
    recs = profiling.records()
    names = [r["name"] for r in recs]
    for name in ("net.encoder", "net.stereo", "net.corr"):
        assert names.count(name) == 1, name
    assert names.count("net.update") == ITERS
    assert {r["parent"] for r in recs if r["name"] == "net.update"} == \
        {"net.stereo"}
    norms = sum(isinstance(m, torch.nn.InstanceNorm2d)
                for m in model.modules())
    assert names.count("net.instancenorm") == norms > 0
    c = profiling.counters()
    assert c["stereo.iters"] == ITERS
    # four levels of (2, 16, 16, 16 / 2^i) f32 correlations
    assert c["stereo.corr_bytes"] == 4 * 2 * 16 * 16 * (16 + 8 + 4 + 2)
    profiling.clear()


def _check_benchmark_reference(model, ref):
    """port_bench's frozen copy: in f32 the plain reference's predictions
    (the tolerance of `_check_predictions`: its correlation, lookup and
    upsampling are the program's formulation, summed in another order than
    the plain reference's); in bf16, the program's loss and gradients to
    the bit, as the benchmark's comparison on the card needs (an order of
    sums of its own would flip bf16 roundings)."""
    from port_bench.reference import raft_stereo as frozen
    from port_bench.reference.containers import SourceView, StereoSample

    batch = _batch(1)
    sample = StereoSample(*[
        SourceView(img=v.img, mask=v.mask, intr=v.intr, ref_intr=v.ref_intr,
                   extr=v.extr, tf_x=v.tf_x)
        for v in (batch.lmain, batch.rmain)])
    copy = frozen.RaftStereoModel(ENC, HIDDEN[::-1], 4, 4, None)
    copy.load_state_dict(model.state_dict())
    copy.train()
    copy.raft_stereo.freeze_bn()
    with torch.no_grad():
        ours = copy(sample, iters=ITERS).flow_preds
        theirs = ref(_nchw(batch.lmain), _nchw(batch.rmain), ITERS)
    for a, b in zip(ours, theirs, strict=True):
        torch.testing.assert_close(a, b.permute(0, 2, 3, 1), atol=2e-5,
                                   rtol=0)

    cfg = _cfg(raft=dict(SMALL["raft"], mixed_precision=True))
    program = _model(cfg)
    copy = frozen.build_model(dataclasses.asdict(cfg), "cpu")
    copy.load_state_dict(program.state_dict())
    state = create_state(cfg, program, "cpu")
    step = trainer.make_train_step(program, cfg, "stage1", None, state,
                                   "cpu")
    loss, _ = step.loss_fn(batch)
    loss.backward()
    flow = torch.cat([batch.lmain.flow, batch.rmain.flow])
    valid = torch.cat([batch.lmain.valid, batch.rmain.valid])
    ref_loss, _ = losses.sequence_loss(
        copy(sample, iters=ITERS).flow_preds, flow, valid)
    ref_loss.backward()
    assert torch.equal(loss, ref_loss)
    grads = dict(program.named_parameters())
    for k, p in copy.named_parameters():
        assert torch.equal(grads[k].grad, p.grad), k


def _check_benchmark_recipe_equals_yaml():
    cfg = json.loads((REPO / "port_bench" / "configs" /
                      "raftstereo_stage1.json").read_text())
    assert tconfig.load_config(None, **cfg["recipe"]) == \
        tconfig.load_config(str(YAML))


def _check_trainer_builds_and_steps_from_yaml(tmp_path, monkeypatch):
    """The stage-1 tool's Trainer from the recipe, narrowed by overrides:
    it builds RAFT-Stereo and takes a step through its loader."""
    # without its optional log writer, whose first import takes seconds
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg = _cfg(record=dict(loss_freq=1))
    tr = trainer.Trainer(cfg, exp_dir=str(tmp_path),
                         dataset=SilhouetteDataset(RES, 16, 2),
                         val_dataset=SilhouetteDataset(RES, 16, 1, seed=1),
                         device="cpu")
    try:
        assert isinstance(tr.model, RaftStereoModel)
        tr.train(num_steps=1)
    finally:
        tr.close()
    assert tr.state.step == 1
    assert torch.isfinite(torch.tensor(tr.history[-1]["loss"]))
    assert (tmp_path / "ckpt" / "ckpt_1.pt").exists()


def test_raft_stereo_matches_the_plain_reference():
    """Predictions (every iteration, and test mode), the first step's loss
    and gradients, the encoders' recomputation, BatchNorm frozen through a step and its AdamW update,
    the spans and counters, and the benchmark's copy of the reference."""
    model = _model(_cfg())
    ref = _reference(model)
    _check_model_is_raft_stereo(model)
    for test_mode in (False, True):
        _check_predictions(model, ref, test_mode)
    _check_encoder_remat_keeps_the_bits(
        model, *_check_first_step_loss_and_gradients(model, ref))
    _check_step_keeps_batchnorm_statistics()
    _check_spans_and_counters(model)
    _check_benchmark_reference(model, ref)


def test_raft_stereo_configuration_and_entry_points(tmp_path, monkeypatch):
    """The refusals of `make_model`, the benchmark's recipe against the
    YAML, and the stage-1 `Trainer` built from the YAML."""
    _check_refusals()
    _check_benchmark_recipe_equals_yaml()
    _check_trainer_builds_and_steps_from_yaml(tmp_path, monkeypatch)
