"""Data parallelism in the port: the sharded eval step against JAX's, the
loader's rank rows, `init_distributed`, and a world-2 `Trainer` against
world 1.

A rank's loader rows must be the rows of the batch a one-process loader
delivers (the same draws, bit for bit). The world-2 Trainer (two spawned
gloo ranks, one sample each) is held to the world-1 Trainer on the same
batches at the JAX package's tolerance between its sharded and one-device
steps (tests/test_sharded_rasterizer.py:129-136): metrics at 5e-3
relative, since valid-masked metrics are per-rank means averaged. Its
val sweep must equal world 1's, and its rank-0 checkpoint must resume at
world 1 with the same parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.testing import fake_stereo_batch as jfake_batch
from gps_gaussian_tpu.train import sharding as jsharding
from gps_gaussian_tpu.train import trainer as jtrainer

from gps_gaussian_tpu_torch.data import loader
from gps_gaussian_tpu_torch.testing import (SilhouetteDataset,
                                            fake_stereo_batch, spawn_ranks)
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import sharding
from gps_gaussian_tpu_torch.train import trainer as ttrainer
from gps_gaussian_tpu_torch.train.trainer import Trainer

from test_torch_port_ddp_step import BATCH, RES, both  # noqa: F401
from thread_budget import thread_budget  # noqa: F401

def test_two_rank_eval_matches_jax_mesh(both):
    """PSNR, EPE and 1px: every (numerator, denominator) pair summed over
    the ranks, against JAX's sums over the mesh; the second sample is
    weighted out. A drop counter's ratio equals one process's: JAX's mesh
    counts the batch once per device, which halves it (a fault the port
    does not share)."""
    tmp, tcfg, jcfg, params, jrcfg = both
    mesh = jsharding.make_mesh(2)
    jmodel = jtrainer.make_model(jcfg, with_gs=True)
    weight = np.array([1.0, 0.0], np.float32)
    jeval = jax.jit(jtrainer.make_sharded_eval_step(
        jmodel, jcfg, "stage2", jrcfg, mesh))
    met_j, _ = jeval(params, jsharding.shard_batch(mesh, jfake_batch(
        batch=2, res=RES, novel_res=RES)),
        jsharding.shard_batch(mesh, jnp.asarray(weight)))
    ranks = spawn_ranks("rank_eval", 2, dict(
        cfg=tcfg, init=str(tmp / "init.pt"), batch=BATCH,
        weight=torch.tensor(weight), device="cpu"), tmp)
    assert ranks[0] == ranks[1]
    assert set(ranks[0]) == set(met_j)
    model = ttrainer.make_model(tcfg, with_gs=True)
    model.load_state_dict(torch.load(tmp / "init.pt", weights_only=True))
    met_1, _ = ttrainer.make_eval_step(
        model, tcfg, "stage2", ttrainer.make_raster_config(tcfg),
        device="cpu")(fake_stereo_batch(**BATCH[1]), torch.tensor(weight))
    for k, (num, den) in ranks[0].items():
        if "drop" in k:
            np.testing.assert_allclose(
                num / den, float(met_1[k][0]) / float(met_1[k][1]),
                rtol=1e-6, err_msg=k)
            continue
        np.testing.assert_allclose([num, den], [float(met_j[k][0]),
                                                float(met_j[k][1])],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert ranks[0]["val_psnr"][1] == 1.0


def _same(a, b):
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("workers", ["threads", "processes"])
def test_loader_rank_rows_are_world1_rows(workers):
    """Each of two ranks' loaders delivers its half of every batch that the
    one-process loader delivers; eval_batches likewise."""
    ds = SilhouetteDataset(16, 16, 5, seed=3)
    kw = (dict(num_threads=2) if workers == "threads"
          else dict(num_procs=2))
    whole = loader.BatchLoader(ds, 4, (2, 3, 4), seed=5, num_threads=1)
    halves = [loader.BatchLoader(ds, 4, (2, 3, 4), seed=5,
                                 rows=slice(2 * r, 2 * r + 2), **kw)
              for r in range(2)]
    try:
        for _ in range(3):
            ref = next(whole)
            for r, it in enumerate(halves):
                got = next(it)
                rows = slice(2 * r, 2 * r + 2)
                _same(got.lmain.img, ref.lmain.img[rows])
                _same(got.rmain.flow, ref.rmain.flow[rows])
                _same(got.novel.camera.view, ref.novel.camera.view[rows])
                _same(got.novel.img, ref.novel.img[rows])
    finally:
        for it in [whole] + halves:
            it.close()
    sweep = list(loader.eval_batches(ds, 4, (3,)))
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        part = list(loader.eval_batches(ds, 4, (3,), rows=rows))
        assert len(part) == len(sweep) == 2
        for (b, w), (b_ref, w_ref) in zip(part, sweep):
            _same(b.lmain.img, b_ref.lmain.img[rows])
            _same(w, w_ref[rows])
    with pytest.raises(ValueError, match="contiguous"):
        loader.BatchLoader(ds, 4, None, rows=slice(0, 4, 2))


def test_init_distributed(monkeypatch):
    """One process: a no-op. Several: a LOCAL_RANK beyond the visible cards
    raises, and so does a failed initialisation (JAX only warns)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert sharding.init_distributed("cpu") == (None, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
            sharding.init_distributed("cuda")
    with pytest.raises(RuntimeError, match="initialisation failed"):
        sharding.init_distributed("cpu")
    assert sharding.rank_rows(4) == slice(0, 4)


CFG = dict(
    stage="stage2", batch_size=2, num_steps=100, loader_seed=0,
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32]),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=1024),
    dataset=dict(src_res=32, num_workers=0),
    record=dict(loss_freq=1, eval_freq=10 ** 6))


def test_trainer_world2_matches_world1(tmp_path):
    cfg = tconfig.load_config(None, **CFG)
    train_ds = SilhouetteDataset(32, 32, 4, seed=1)
    val_ds = SilhouetteDataset(32, 32, 3, seed=2)
    ranks = spawn_ranks("rank_trainer", 2, dict(
        cfg=cfg, train_ds=train_ds, val_ds=val_ds, device="cpu", steps=2,
        exp_dir=str(tmp_path / "w2"), out=str(tmp_path / "w2.pt")),
        tmp_path)
    one = Trainer(cfg, exp_dir=str(tmp_path / "w1"), dataset=train_ds,
                  val_dataset=val_ds, device="cpu")
    try:
        one.train(num_steps=2)
        val_1 = one.run_eval(2)
    finally:
        one.close()
    def untimed(history):
        return [{k: v for k, v in row.items() if not k.endswith("_ms")}
                for row in history]

    assert untimed(ranks[0]["history"]) == untimed(ranks[1]["history"])
    assert ranks[0]["val"] == ranks[1]["val"]
    assert ranks[0]["ckpts"] == ["ckpt_1.pt", "ckpt_2.pt"]
    for row, ref in zip(ranks[0]["history"], one.history, strict=True):
        for k, v in ref.items():
            if k.endswith("_ms"):
                continue
            np.testing.assert_allclose(row[k], v, rtol=5e-3, atol=1e-5,
                                       err_msg=k)
    for k, v in val_1.items():
        np.testing.assert_allclose(ranks[0]["val"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    w2 = torch.load(tmp_path / "w2.pt")
    assert set(w2) == set(one.model.state_dict())
    resumed = Trainer(dataclasses.replace(
        cfg, restore_ckpt=str(tmp_path / "w2" / "ckpt")),
        exp_dir=str(tmp_path / "w1-resumed"), dataset=train_ds,
        val_dataset=val_ds, device="cpu")
    try:
        assert resumed.state.step == 2
        for k, v in resumed.model.state_dict().items():
            assert torch.equal(v, w2[k]), k
        resumed.train(num_steps=3)
        assert resumed.state.step == 3
    finally:
        resumed.close()


def test_trainer_world2_val_drops_match_world1(tmp_path):
    """At caps that bind (K 1, 8 pairs a tile, 64 foreground pixels at
    32^2) a val drop counter is the mean drops per val batch, every row
    counted whatever its weight: two ranks' sweep gives one process's
    value, not half of it."""
    cfg = tconfig.load_config(None, **dict(CFG, raster=dict(
        max_tiles_per_gaussian=1, max_per_tile=8, fg_cap=64)))
    train_ds = SilhouetteDataset(32, 32, 4, seed=1)
    val_ds = SilhouetteDataset(32, 32, 3, seed=2)
    ranks = spawn_ranks("rank_trainer", 2, dict(
        cfg=cfg, train_ds=train_ds, val_ds=val_ds, device="cpu", steps=1,
        exp_dir=str(tmp_path / "w2"), out=str(tmp_path / "w2.pt")),
        tmp_path)
    one = Trainer(cfg, exp_dir=str(tmp_path / "w1"), dataset=train_ds,
                  val_dataset=val_ds, device="cpu")
    try:
        one.train(num_steps=1)
        val_1 = one.run_eval(1)
    finally:
        one.close()
    drops = [k for k in val_1 if "drop" in k]
    assert len(drops) == 3 and all(val_1[k] > 0 for k in drops), val_1
    assert ranks[0]["val"] == ranks[1]["val"]
    for k, v in val_1.items():
        np.testing.assert_allclose(ranks[0]["val"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
