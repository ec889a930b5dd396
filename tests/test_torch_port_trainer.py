"""The port's Trainer and eval step against the JAX package's, on the CPU.

A narrow f32 model (encoder (16, 24, 32), hidden 32, gsnet (16, 24, 32) /
(24, 32, 32) / 16, one GRU iteration) on synthetic scans rendered in memory at 64^2
(SynthMemoryDataset: the real rectification and flow code), batch 2, caps
that do not bind. The JAX side rasterizes through its CPU route (`backend`
"auto" is the jnp composite there). Tolerances are those of
tests/test_torch_port_step.py: metrics 1e-4 relative (atol 1e-6), since the
two forwards differ in convolution summation order by about 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.data import loader as jloader
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train import sharding
from gps_gaussian_tpu.train import trainer as jtrainer

from gps_gaussian_tpu_torch.data import loader
from gps_gaussian_tpu_torch.data.thuman import DatasetConfig
from gps_gaussian_tpu_torch.testing import (SilhouetteDataset,
                                            SynthMemoryDataset, synth_scans)
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import trainer
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

RES = 64
NARROW = dict(
    batch_size=2, num_steps=2,
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32],
              train_iters=1, val_iters=1),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=8192),
    dataset=dict(src_res=RES, use_hr_img=False, num_workers=0))


class Recorder:
    """Stands in for the TensorBoard writer: keeps every scalar."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, key, value, step):
        self.scalars[(key, step)] = float(value)

    def close(self):
        pass


class Fixed:
    """Stands in for the training loader: the given batches, in order."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def __next__(self):
        return next(self.batches)

    def close(self):
        pass


def _samples(ds, n, novel=(2, 3, 4)):
    return [ds.get_sample(i, novel, np.random.default_rng(i))
            for i in range(n)]


def _assert_metrics(got: dict, ref: dict):
    assert set(ref) <= set(got), (set(ref), set(got))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _jax_params_into(jparams, model):
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A JAX and a port Trainer from the same initial parameters, each
    trained 2 steps on the same fixed batches (metrics logged at each)."""
    root = tmp_path_factory.mktemp("port_trainer")
    over = dict(NARROW, stage="stage2",
                record=dict(ckpt_path=str(root), loss_freq=1, eval_freq=100))
    jcfg = jconfig.load_config(None, **over)
    tcfg = tconfig.load_config(None, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    ds_cfg = DatasetConfig(data_root="", src_res=RES)
    train_ds = SynthMemoryDataset(ds_cfg, synth_scans("train", 4), "train")
    val_ds = SynthMemoryDataset(ds_cfg, synth_scans("val", 3), "val")
    samples = _samples(train_ds, 4)

    jtr = jtrainer.Trainer(jcfg, exp_dir=str(root / "jax"), dataset=train_ds,
                           val_dataset=val_ds, mesh=sharding.make_mesh(1))
    # the JAX step's first update moves the step counter onto the mesh, and
    # its second call compiles again for that placement; placed so now, it
    # compiles once (same values, half the test's time)
    jtr.state = jtr.state.replace(
        step=sharding.replicate(jtr.mesh, jtr.state.step))
    ttr = trainer.Trainer(tcfg, exp_dir=str(root / "port"), dataset=train_ds,
                          val_dataset=val_ds, device="cpu")
    _jax_params_into(jtr.state.params, ttr.model)
    for tr, collate in ((jtr, jloader.collate), (ttr, loader.collate)):
        tr.train_loader.close()
        tr.train_loader = Fixed([collate(samples[:2]), collate(samples[2:])])
        tr.writer = Recorder()
    jtr.train()
    ttr.train()
    yield jtr, ttr, tcfg, samples, root
    jtr.close()
    ttr.close()


def test_trainer_steps_match_jax(trainers):
    jtr, ttr, _, _, _ = trainers
    assert int(jtr.state.step) == ttr.state.step == 2
    for step in (1, 2):
        ref = {k: v for (k, s), v in jtr.writer.scalars.items()
               if s == step and not k.startswith("perf/")}
        got = {k: v for (k, s), v in ttr.writer.scalars.items() if s == step}
        assert {"loss", "l1", "ssim", "flow_loss", "train_epe"} <= set(ref)
        _assert_metrics(got, ref)
        assert got["num_dropped"] == got["num_pair_dropped"] == 0
    assert [row["step"] for row in ttr.history] == [1, 2]
    assert sorted(p.name for p in (ttr.exp_dir / "ckpt").iterdir()) == \
        ["ckpt_1.pt", "ckpt_2.pt"]


def test_trainer_eval_sweep_matches_jax(trainers):
    """run_eval over 3 val scans in batches of 2 (the wrapped tail weighs
    0): the same val metrics and preview image."""
    jtr, ttr, _, _, _ = trainers
    ref = jtr.run_eval(2)
    got = ttr.run_eval(2)
    assert {"val_psnr", "val_epe", "val_1px", "val_num_dropped"} <= set(ref)
    _assert_metrics(got, ref)
    assert ttr.last_preview.shape == (RES, RES, 3)
    assert (ttr.exp_dir / "show" / "00000002.jpg").exists()


def test_resume_matches_uninterrupted_run(trainers):
    """A Trainer resumed from the step-1 checkpoint takes the same second
    step, bit for bit, as the run that was not interrupted (under the
    profiler, whose trace it writes)."""
    _, ttr, tcfg, samples, root = trainers
    cfg = dataclasses.replace(
        tcfg, restore_ckpt=str(ttr.exp_dir / "ckpt" / "ckpt_1.pt"))
    resumed = trainer.Trainer(cfg, exp_dir=str(root / "resumed"),
                              dataset=ttr.train_ds, val_dataset=ttr.val_ds,
                              device="cpu")
    try:
        assert resumed.state.step == 1
        resumed.train_loader.close()
        resumed.train_loader = Fixed([loader.collate(samples[2:])])
        resumed.train(trace_steps=(1, 2), trace_dir=str(root / "trace"))
    finally:
        resumed.close()
    assert resumed.state.step == 2
    # the profiled window wrote its trace
    assert (root / "trace" / "trace_1_2.json").stat().st_size > 0
    assert resumed.history[-1] == dict(ttr.history[-1],
                                       step_ms=resumed.history[-1]["step_ms"],
                                       data_wait_ms=resumed.history[-1][
                                           "data_wait_ms"])
    for (name, a), b in zip(ttr.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_stage2_warm_start_restores_stage1_tensors(trainers, tmp_path):
    """cfg.stage1_ckpt: every tensor of a stage-1 checkpoint lands in the
    stage-2 model; the Gaussian head keeps its initialisation."""
    _, ttr, tcfg, _, _ = trainers
    cfg1 = dataclasses.replace(tcfg, stage="stage1")
    ds = ttr.val_ds
    s1 = trainer.Trainer(cfg1, exp_dir=str(tmp_path / "s1"), dataset=ds,
                         val_dataset=ds, device="cpu")
    s1.close()
    from gps_gaussian_tpu_torch.train.state import save_checkpoint

    save_checkpoint(tmp_path / "s1" / "ckpt", s1.state)
    s2 = trainer.Trainer(dataclasses.replace(
        tcfg, stage1_ckpt=str(tmp_path / "s1" / "ckpt")),
        exp_dir=str(tmp_path / "s2"), dataset=ds, val_dataset=ds,
        device="cpu")
    s2.close()
    stage1 = s1.model.state_dict()
    assert s2.n_restored == len(stage1)
    for name, t in s2.model.state_dict().items():
        if name in stage1:
            assert torch.equal(t, stage1[name]), name
    assert any(name.startswith("gs_parm_regresser")
               for name in s2.model.state_dict())


def test_jax_model_has_the_port_tensor_names():
    """state_dict_from_flax of a JAX stage-2 init names exactly the port
    model's tensors (what the Trainer parity above relies on)."""
    jcfg = jconfig.load_config(None, **dict(NARROW, stage="stage2"))
    tcfg = tconfig.load_config(None, **dict(NARROW, stage="stage2"))
    batch = jloader.collate(_samples(SilhouetteDataset(RES, RES, 1), 1))
    target = jax.eval_shape(
        lambda k: jtrainer.make_model(jcfg, with_gs=True).init(
            k, batch, iters=3), jax.random.PRNGKey(0))
    names = set(state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), target)))
    assert names == set(trainer.make_model(tcfg, True).state_dict())
