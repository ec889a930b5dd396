"""(g) The training slice as a whole against the JAX package, on the CPU.

From the same converted weights, one f32 stage-2 step: loss, metrics and
every parameter's gradient (JAX gradients pass through
`state_dict_from_flax`, which is linear); then two optimizer steps and the
parameters after them; once with `flow_weight` 0, where the step's metrics
hold no flow key.

The model is narrow (encoder (16, 24, 32), hidden 32, gsnet (16, 24, 32) /
(24, 32, 32) / 16), batch 2, sources and target are 64^2, and the raster
caps do not bind (the two packages drop different rows when `fg_cap`
binds). The JAX rasterizer runs its Pallas route in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.kernels.rasterizer import \
    RasterizeConfig as JRasterizeConfig
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train import losses as jlosses
from gps_gaussian_tpu.train import state as jstate
from gps_gaussian_tpu.train import trainer as jtrainer
from gps_gaussian_tpu.utils import containers as JC
from gps_gaussian_tpu.utils.torch_import import convert_state_dict

from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import silhouette_train_batch
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import state as tstate, trainer
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

RES = 64
NARROW = dict(
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32]),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=4096),
    dataset=dict(src_res=RES), num_steps=200)


def _jax_batch(batch):
    def conv(obj, cls, **more):
        return cls(**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                      for f in dataclasses.fields(cls)
                      if isinstance(getattr(obj, f.name), torch.Tensor)},
                   **more)

    cam = batch.novel.camera
    novel = conv(batch.novel, JC.NovelView, camera=conv(
        cam, JC.NovelCamera, height=cam.height, width=cam.width))
    return JC.StereoSample(lmain=conv(batch.lmain, JC.SourceView),
                           rmain=conv(batch.rmain, JC.SourceView),
                           novel=novel)


def _both_sides(flow_weight):
    over = dict(NARROW, stage="stage2", flow_weight=flow_weight)
    tcfg = tconfig.load_config(None, **over)
    jcfg = jconfig.load_config(None, **over)
    assert tconfig.as_dict(tcfg) == dataclasses.asdict(jcfg)

    model = trainer.make_model(tcfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(7))
    params = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    jmodel = jtrainer.make_model(jcfg, with_gs=True)
    jrcfg = JRasterizeConfig(backend="pallas", interpret=True,
                             **NARROW["raster"])
    batch = silhouette_train_batch(2, RES, RES, 0.3, seed=9)
    return tcfg, model, batch, jcfg, jmodel, params, jrcfg, _jax_batch(batch)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """The tolerances below were set with torch on 8 threads, so this file
    runs there, not on a test worker's share of the cores
    (tests/thread_budget.py). Torch's CPU convolutions sum in an
    order that follows the thread count: at 1, 2 or 4 threads one GroupNorm
    output of the Gaussian head's decoder (decoder2.1.norm2, about 2e-6)
    lands on the other side of its ReLU than at 3, 6 or 8 threads and in
    the JAX forward, and that one element moves the head's weight gradients
    by up to 1.8e-2 of their scale at flow_weight 0."""
    budget = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(budget)


def _flat(tree):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("flow_weight", [1.0, 0.0])
def test_stage2_step_matches_jax(flow_weight):
    """One f32 stage-2 step, then (at flow_weight 1) a second.

    Loss and metrics: 1e-4 relative (both forwards differ in convolution
    summation order, about 1e-6, and the loss is a mean over 64^2 pixels of
    renders that agree to 1e-5). Gradients: 5e-3 of each tensor's largest
    gradient, floored at 1% of the model's largest. On identical Gaussians
    the two rasterizers' gradients agree to 1e-5 (test_torch_port_grads);
    here the Gaussians come from two forwards that differ by about 1e-6,
    and such a shift can move one pixel's alpha across 1/255 or its T
    across 1e-4 on one side only, which changes that pair's gradient by a
    whole term. A handful of elements per tensor then differ by up to
    3e-3 of the scale (seen: 9 of 9216). Parameters after two steps: see
    below."""
    tcfg, model, batch, jcfg, jmodel, params, jrcfg, jbatch = \
        _both_sides(flow_weight)

    def jloss(p):
        out = jmodel.apply(p, jbatch, iters=jcfg.raft.train_iters)
        img, _ = jtrainer.render_novel(out, jbatch.novel,
                                       jcfg.dataset.bg_color, jrcfg)
        total = (jcfg.l1_weight * jlosses.l1_loss(img, jbatch.novel.img)
                 + jcfg.ssim_weight
                 * (1.0 - jlosses.ssim(img, jbatch.novel.img)))
        if flow_weight:
            flow_gt, valid = jtrainer._stacked_flow_gt(jbatch)
            total = total + flow_weight * jlosses.sequence_loss(
                out.flow_preds, flow_gt, valid)[0]
        return total

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jcfg, "stage2", jrcfg))
    jst = jstate.create_state(jcfg, params)
    if flow_weight:
        jst, met_j = jstep(jst, jbatch)
    else:
        # the metric names only (traced, not compiled): the values at
        # flow_weight 0 are the loss and gradients compared below
        met_j = jax.eval_shape(jstep, jst, jbatch)[1]

    state = tstate.create_state(tcfg, model, device="cpu")
    step = trainer.make_train_step(model, tcfg, "stage2",
                                   trainer.make_raster_config(tcfg), state,
                                   device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss, _ = step.loss_fn(batch)
    loss.backward()
    grads = {k: v.grad.clone() for k, v in model.named_parameters()}
    met = step(batch)

    # the step's metrics, and its loss, against the JAX step's
    assert set(met) == set(met_j) | {"grad_norm"}
    assert ("flow_loss" in met) == ("train_epe" in met) == bool(flow_weight)
    if flow_weight:
        for k, v in met_j.items():
            np.testing.assert_allclose(met[k].item(), float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert int(jst.step) == 1
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(met["loss"].item(), float(loss_j), rtol=1e-4)
    assert met["num_dropped"] == met["num_fg_dropped"] \
        == met["num_pair_dropped"] == 0
    assert state.step == 1

    ref = _flat(grads_j)
    top = max(float(r.abs().max()) for r in ref.values())
    assert set(grads) <= set(ref) and len(grads) > 200
    for name, g in grads.items():
        s = max(float(ref[name].abs().max()), 1e-2 * top)
        np.testing.assert_allclose(g.numpy() / s, ref[name].numpy() / s,
                                   atol=5e-3, rtol=0, err_msg=name)
    gs_grad = sum(float(g.abs().sum()) for k, g in grads.items()
                  if k.startswith("gs_parm_regresser"))
    assert gs_grad > 0, "the render's gradient reaches the Gaussian head"
    # optax clips by max(norm, clip), torch by norm + 1e-6: the same to 1e-6
    np.testing.assert_allclose(
        met["grad_norm"].item(),
        float(np.sqrt(sum(float((r.double() ** 2).sum())
                          for k, r in ref.items() if k in grads))),
        rtol=2e-3)

    if not flow_weight:
        return
    # Two optimizer steps. Adam's first update is lr * g / (|g| + 1e-8):
    # where a gradient is rounding noise (a conv bias in front of a
    # GroupNorm has none analytically) its sign, and so the whole update,
    # differs between any two implementations. Elements whose first
    # gradient is above 1e-4 of their tensor's largest are compared: all of
    # their updates agree to 10% of the two steps' learning rates and 99% of
    # them to 2% (the rest have a second-step gradient near zero), and
    # every element stays within the largest possible move. (Such a bound
    # cannot see a wrong decay, beta or eps: the optimizer's arithmetic is
    # held to optax tightly, on fixed gradients, in
    # tests/test_torch_port_train.py.)
    jst, _ = jstep(jst, jbatch)
    step(batch)
    assert state.step == 2 and int(jst.step) == 2
    after_j = _flat(jst.params)
    sched = tstate.onecycle_linear(tcfg.lr, tcfg.num_steps + 100)
    lr_sum = sched(0) + sched(1)
    compared = loose = 0
    for name, prm in model.named_parameters():
        d_t = (prm.detach() - before[name]).numpy()
        d_j = (after_j[name] - before[name]).numpy()
        assert np.abs(d_t).max() <= 1.01 * lr_sum * 3.2, name
        g = ref[name].abs().numpy()
        sel = g > 1e-4 * max(float(g.max()), 1e-2 * top)
        compared += int(sel.sum())
        if sel.any():
            np.testing.assert_allclose(d_t[sel], d_j[sel],
                                       atol=0.1 * lr_sum, rtol=0,
                                       err_msg=name)
            loose += int((np.abs(d_t[sel] - d_j[sel])
                          > 0.02 * lr_sum).sum())
    total = sum(p.numel() for p in model.parameters())
    assert compared > 0.5 * total, (compared, total)
    assert loose < 0.01 * compared, (loose, compared)
