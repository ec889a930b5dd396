"""The port's training step against the JAX package's, on the CPU.

(d) the four losses on the same arrays;
(e) the learning rate at every step of a 300-step schedule against
    `onecycle_linear`, per-module scales, and `validate_group_scales`;
    the optimizer's moments and parameters over three steps on fixed
    gradients against optax;
(h) checkpoint save -> restore -> next step equals the uninterrupted run,
    and the partial restore of a stage-1 state dict into a stage-2 model.

The model is narrow (encoder (16, 24, 32), hidden 32, gsnet (16, 24, 32) /
(24, 32, 32) / 16), sources and target are 64^2, and the raster caps do not
bind. The whole stage-2 step against JAX's, (g), is in
tests/test_torch_port_step.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.train import losses as jlosses
from gps_gaussian_tpu.train import state as jstate

from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import (SilhouetteDataset,
                                            silhouette_train_batch)
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import losses, state as tstate, trainer

from thread_budget import thread_budget  # noqa: F401

RES = 64
NARROW = dict(
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32]),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=4096),
    dataset=dict(src_res=RES), num_steps=200)


# ------------------------------------------------------------- (d) losses


def test_losses_match_jax(rng):
    """Same arrays through both: sums and means of ~1e4 f32 terms in
    different orders, so 1e-5 relative (SSIM's windowed variances cancel:
    1e-5 absolute on a value in [0, 1])."""
    b, h, w = 2, 40, 56
    preds = [rng.normal(size=(b, h, w, 1)).astype(np.float32) * 3
             for _ in range(3)]
    gt = rng.normal(size=(b, h, w, 1)).astype(np.float32) * 3
    valid = (rng.uniform(size=(b, h, w, 1)) > 0.4).astype(np.float32)
    loss_j, met_j = jlosses.sequence_loss(list(map(jnp.asarray, preds)),
                                          jnp.asarray(gt), jnp.asarray(valid))
    loss_t, met_t = losses.sequence_loss(list(map(torch.tensor, preds)),
                                         torch.tensor(gt),
                                         torch.tensor(valid))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert set(met_t) == set(met_j) == {"train_epe", "train_1px",
                                        "train_3px"}
    for k in met_j:
        np.testing.assert_allclose(met_t[k].item(), float(met_j[k]),
                                   rtol=1e-5, err_msg=k)
    # all-invalid masks divide by 1, not by 0
    zero = losses.sequence_loss([torch.tensor(preds[0])], torch.tensor(gt),
                                torch.zeros(b, h, w, 1))
    assert zero[0].item() == 0.0

    img1 = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(scale=0.1, size=img1.shape), 0,
                   1).astype(np.float32)
    t1, t2 = torch.tensor(img1), torch.tensor(img2)
    j1, j2 = jnp.asarray(img1), jnp.asarray(img2)
    np.testing.assert_allclose(losses.l1_loss(t1, t2).item(),
                               float(jlosses.l1_loss(j1, j2)), rtol=1e-5)
    np.testing.assert_allclose(losses.ssim(t1, t2).item(),
                               float(jlosses.ssim(j1, j2)), atol=1e-5)
    np.testing.assert_allclose(losses.ssim(t1, t1).item(), 1.0, atol=1e-5)
    np.testing.assert_allclose(losses.psnr(t1, t2).numpy(),
                               np.asarray(jlosses.psnr(j1, j2)), rtol=1e-5)
    np.testing.assert_array_equal(losses._gaussian_window(),
                                  jlosses._gaussian_window())


# ----------------------------------------------------------- (e) schedule


def _tiny_model():
    cfg = tconfig.load_config(None, **NARROW)
    model = trainer.make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(3))
    return model


def test_learning_rate_matches_onecycle_linear():
    """Every step of the 300-step schedule (num_steps 200 + 100), and past
    its end: the port computes the JAX formula in Python floats, optax in
    f32 (6e-8 for each of its few operations), so 5e-6 relative. The scaled
    groups follow at their scales."""
    scales = {"img_encoder": 0.1, "raft_stereo": 0.5}
    cfg = tconfig.load_config(None, **dict(NARROW, lr_group_scales=scales))
    optimizer, scheduler = tstate.make_optimizer(cfg, _tiny_model())
    ref = jstate.onecycle_linear(cfg.lr, cfg.num_steps + 100)
    by_name = {g["name"]: g for g in optimizer.param_groups}
    assert set(by_name) == {"img_encoder", "raft_stereo",
                            "gs_parm_regresser"}
    peak_seen = 0.0
    for t in range(310):
        want = float(ref(t))
        for name, group in by_name.items():
            np.testing.assert_allclose(
                group["lr"], want * scales.get(name, 1.0), rtol=5e-6,
                err_msg=f"step {t} group {name}")
        peak_seen = max(peak_seen, by_name["gs_parm_regresser"]["lr"])
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(peak_seen, cfg.lr, rtol=5e-6)

    const = dataclasses.replace(cfg, scheduler="constant",
                                lr_group_scales=None)
    optimizer, scheduler = tstate.make_optimizer(const, _tiny_model())
    assert len(optimizer.param_groups) == 1
    for _ in range(5):
        assert optimizer.param_groups[0]["lr"] == cfg.lr
        optimizer.step()
        scheduler.step()
    with pytest.raises(ValueError, match="unknown scheduler"):
        tstate.make_optimizer(dataclasses.replace(cfg, scheduler="cosine"),
                              _tiny_model())


def test_optimizer_steps_match_optax_on_fixed_gradients(rng):
    """Three `apply_gradients` on the same seeded gradients through both
    optimizers, with settings under which every part shows: weight decay 0.1
    (a twentieth of each update), clipping at 0.05 of a global norm in the
    hundreds, per-module scales, a warm-up that changes the rate each step,
    and gradient magnitudes spread over eight decades so that the clipped
    ones straddle eps (1e-8). A new gradient each step makes the moments
    depend on both betas.

    Both sides compute in f32. Moments: 1e-5 relative (optax clips by
    max(norm, clip), torch by norm + 1e-6, a 1e-8 difference here, and the
    norm is a sum of 3e5 squares in another order), the first moment also
    1e-6 of its tensor's largest, since three gradients of either sign
    cancel in it. Parameter moves: 1e-4
    relative plus 1e-5 of the summed rates (bias correction and the eps
    division round differently) plus 4e-7 of the tensor's largest parameter
    (each of the three steps rounds the parameter at 6e-8 of its size, on
    both sides)."""
    scales = {"img_encoder": 0.1, "raft_stereo": 0.5}
    cfg = tconfig.load_config(None, **dict(
        NARROW, lr=0.05, wdecay=0.1, grad_clip=0.05,
        lr_group_scales=scales))
    model = _tiny_model()
    state = tstate.create_state(cfg, model, device="cpu")
    names = [k for k, _ in model.named_parameters()]
    split = lambda k: k.split(".", 1)  # noqa: E731
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    params_j: dict = {}
    for k, v in before.items():
        params_j.setdefault(split(k)[0], {})[split(k)[1]] = \
            jnp.asarray(v.numpy())
    jst = jstate.create_state(cfg, params_j)

    lrs = []
    for _ in range(3):
        grads = {k: (rng.normal(size=before[k].shape)
                     * 10.0 ** rng.uniform(-8, 0, size=before[k].shape)
                     ).astype(np.float32) for k in names}
        grads_j: dict = {}
        for k, g in grads.items():
            grads_j.setdefault(split(k)[0], {})[split(k)[1]] = jnp.asarray(g)
        jst = jst.apply_gradients(grads_j)
        for k, prm in model.named_parameters():
            prm.grad = torch.tensor(grads[k])
        lrs.append(state.optimizer.param_groups[-1]["lr"])
        norm = state.apply_gradients()
        want = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads.values()))
        np.testing.assert_allclose(norm.item(), want, rtol=1e-5)
        assert want > 100 * cfg.grad_clip
    assert state.step == int(jst.step) == 3
    assert lrs[0] < lrs[1] < lrs[2]

    adam = jst.opt_state[1][0]
    assert int(adam.count) == 3
    small = 0
    for k, prm in model.named_parameters():
        g, rest = split(k)
        st = state.optimizer.state[prm]
        assert int(st["step"]) == 3
        mu = np.asarray(adam.mu[g][rest])
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=1e-5,
                                   atol=1e-6 * np.abs(mu).max(), err_msg=k)
        nu = np.asarray(adam.nu[g][rest])
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=1e-5,
                                   atol=1e-24, err_msg=k)
        small += int((np.sqrt(nu / (1 - 0.999 ** 3)) < 1e-8).sum())
        d_t = (prm.detach() - before[k]).numpy()
        d_j = np.asarray(jst.params[g][rest]) - before[k].numpy()
        atol = 1e-5 * sum(lrs) * scales.get(g, 1.0) \
            + 4e-7 * float(before[k].abs().max())
        np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=atol, err_msg=k)
        assert np.abs(d_j).max() > 0.5 * sum(lrs) * scales.get(g, 1.0), k
    total = sum(p.numel() for p in model.parameters())
    assert 0.05 * total < small < 0.95 * total, \
        "second moments lie on both sides of eps"


def test_validate_group_scales_raises_on_unknown_key():
    model = _tiny_model()
    tstate.validate_group_scales({"raft_stereo": 0.1}, model)
    with pytest.raises(ValueError, match="gs_regresser"):
        tstate.validate_group_scales({"gs_regresser": 0.1}, model)
    cfg = tconfig.load_config(None, **dict(
        NARROW, lr_group_scales={"img_encodr": 0.1}))
    with pytest.raises(ValueError, match="img_encodr"):
        tstate.create_state(cfg, model, device="cpu")


def test_stage1_step_and_eval_steps_run(tmp_path, monkeypatch):
    """Stage 1 is the same step with only the sequence loss; the eval steps
    return (numerator, denominator) pairs, and stage 1 returns the
    point-splat preview when the batch has a novel view, else no image.
    The Trainer logs each interval's mean step time and wait for data on
    the host clock, with no device synchronisation of its own."""
    cfg = tconfig.load_config(None, **dict(NARROW, stage="stage1"))
    model = trainer.make_model(cfg, with_gs=False)
    init_weights(model, torch.Generator().manual_seed(1))
    state = tstate.create_state(cfg, model, device="cpu")
    rcfg = trainer.make_raster_config(cfg)
    step = trainer.make_train_step(model, cfg, "stage1", rcfg, state,
                                   device="cpu")
    batch = silhouette_train_batch(2, RES, RES, 0.3, seed=2)
    marks = []
    first = step(batch, mark=marks.append)
    second = step(batch)
    assert marks == ["forward", "backward", "optimizer"]

    tcfg = tconfig.load_config(None, **dict(
        NARROW, stage="stage1", batch_size=2,
        dataset=dict(src_res=RES, num_workers=0),
        record=dict(ckpt_path=str(tmp_path), loss_freq=2, eval_freq=1000)))
    ds = SilhouetteDataset(RES, RES, 2)
    tr = trainer.Trainer(tcfg, exp_dir=str(tmp_path / "exp"), dataset=ds,
                         val_dataset=ds, device="cpu")
    tr.train_loader.close()
    tr.train_loader = (batch for _ in range(4))
    monkeypatch.setattr(torch.cuda, "synchronize", None)   # never called
    tr.train(4)
    assert [row["step"] for row in tr.history] == [2, 4]
    for row in tr.history:
        assert row["step_ms"] > 0 and 0 <= row["data_wait_ms"] < \
            row["step_ms"]
    assert set(first) == {"loss", "grad_norm", "train_epe", "train_1px",
                          "train_3px"}
    assert second["loss"] < first["loss"]

    eval_step = trainer.make_eval_step(model, cfg, "stage1", rcfg,
                                       device="cpu")
    metrics, img = eval_step(batch, torch.ones(2))
    assert set(metrics) == {"val_epe", "val_1px"}
    assert img.shape == (2, RES, RES, 3) and img.min() >= 0 \
        and img.max() <= 1
    assert eval_step(dataclasses.replace(batch, novel=None),
                     torch.ones(2))[1] is None

    cfg2 = tconfig.load_config(None, **dict(NARROW, stage="stage2",
                                            remat=True))
    model2 = trainer.make_model(cfg2, with_gs=True)
    init_weights(model2, torch.Generator().manual_seed(1))
    ev = trainer.make_eval_step(model2, cfg2, "stage2", rcfg, device="cpu")
    m_all, img = ev(batch, torch.ones(2))
    m_one, _ = ev(batch, torch.tensor([1.0, 0.0]))
    assert tuple(img.shape) == (2, RES, RES, 3)
    assert m_all["val_psnr"][1] == 2 and m_one["val_psnr"][1] == 1
    assert m_one["val_epe"][1] * 2 == m_all["val_epe"][1]
    assert "val_num_pair_dropped" in m_all

    # rematerialising the model forward changes memory, not numbers
    st2 = tstate.create_state(cfg2, model2, device="cpu")
    remat = trainer.make_train_step(model2, cfg2, "stage2", rcfg, st2,
                                    device="cpu").loss_fn(batch)[0]
    plain = trainer.make_train_step(
        model2, dataclasses.replace(cfg2, remat=False), "stage2", rcfg, st2,
        device="cpu").loss_fn(batch)[0]
    assert remat.item() == plain.item()


# ------------------------------------------------------- (h) checkpoints


def _stage2_run():
    cfg = tconfig.load_config(None, **dict(NARROW, stage="stage2"))
    model = trainer.make_model(cfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(5))
    state = tstate.create_state(cfg, model, device="cpu")
    step = trainer.make_train_step(model, cfg, "stage2",
                                   trainer.make_raster_config(cfg), state,
                                   device="cpu")
    return cfg, model, state, step


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    """Save after step 1, restore into a fresh state, take step 2: the
    same parameters, bit for bit, as the run that was never interrupted
    (the CPU ops involved are deterministic)."""
    batch = silhouette_train_batch(1, RES, RES, 0.3, seed=4)
    _, model_a, state_a, step_a = _stage2_run()
    step_a(batch)
    path = tstate.save_checkpoint(tmp_path, state_a)
    assert path.name == "ckpt_1.pt"
    m_a = step_a(batch)

    _, model_b, state_b, step_b = _stage2_run()
    # a different starting point, so that the restore has work to do
    with torch.no_grad():
        for prm in model_b.parameters():
            prm.add_(0.01)
    tstate.restore_checkpoint(tmp_path, state_b)
    assert state_b.step == 1
    m_b = step_b(batch)
    assert state_b.step == 2
    assert m_a["loss"].item() == m_b["loss"].item()
    assert state_a.optimizer.param_groups[0]["lr"] \
        == state_b.optimizer.param_groups[0]["lr"]
    for (name, a), b in zip(model_a.named_parameters(),
                            model_b.parameters()):
        assert torch.equal(a, b), name

    # the newest three checkpoints are kept
    for s in (2, 3, 4, 5):
        state_a.step = s
        tstate.save_checkpoint(tmp_path, state_a)
    assert sorted(f.name for f in tmp_path.glob("ckpt_*.pt")) == [
        "ckpt_3.pt", "ckpt_4.pt", "ckpt_5.pt"]
    with pytest.raises(FileNotFoundError):
        tstate.restore_checkpoint(tmp_path / "none", state_b)


def test_partial_restore_stage1_into_stage2(tmp_path):
    cfg = tconfig.load_config(None, **dict(NARROW, stage="stage1"))
    stage1 = trainer.make_model(cfg, with_gs=False)
    init_weights(stage1, torch.Generator().manual_seed(21))
    _, stage2, _, _ = _stage2_run()
    head_before = {k: v.clone() for k, v in stage2.state_dict().items()
                   if k.startswith("gs_parm_regresser")}
    assert head_before

    n = tstate.restore_params_partial(stage1.state_dict(), stage2)
    assert n == len(stage1.state_dict()) > 60
    after = stage2.state_dict()
    for k, v in stage1.state_dict().items():
        assert torch.equal(after[k], v), k
    for k, v in head_before.items():
        assert torch.equal(after[k], v), f"{k} keeps its initialisation"

    # from a checkpoint directory too, and a tensor of another shape stays
    state1 = tstate.create_state(cfg, stage1, device="cpu")
    tstate.save_checkpoint(tmp_path, state1)
    _, fresh, _, _ = _stage2_run()
    assert tstate.restore_params_partial(tmp_path, fresh) == n
    odd = dict(stage1.state_dict())
    name = next(iter(odd))
    odd[name] = torch.zeros(3)
    assert tstate.restore_params_partial(odd, fresh) == n - 1
