"""The data-parallel stage-2 step of the port against the JAX package's.

Two spawned ranks joined by a gloo group (`make_sharded_train_step`, each
rank on one sample) against JAX `make_sharded_train_step` on `make_mesh(2)`
(the Pallas rasterizer in interpret mode), from the same converted weights
on `fake_stereo_batch(batch=2, res=32)` (the sharded eval step is held to
JAX's in test_torch_port_ddp.py). Both sides average per-device means, so the
metrics agree as tightly as the one-device step's do
(test_torch_port_step.py): 1e-4 relative. The model is narrow (encoder
(16, 24, 32), hidden 32) and the raster caps do not bind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.kernels.rasterizer import \
    RasterizeConfig as JRasterizeConfig
from gps_gaussian_tpu.testing import fake_stereo_batch as jfake_batch
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train import sharding as jsharding
from gps_gaussian_tpu.train import state as jstate
from gps_gaussian_tpu.train import trainer as jtrainer
from gps_gaussian_tpu.utils.torch_import import convert_state_dict

from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import spawn_ranks
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import state as tstate, trainer
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

RES = 32
NARROW = dict(
    stage="stage2", batch_size=2, num_steps=200,
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32]),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096),
    dataset=dict(src_res=RES))
BATCH = ("fake_stereo_batch", dict(batch=2, res=RES, novel_res=RES))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_step")
    tcfg = tconfig.load_config(None, **NARROW)
    jcfg = jconfig.load_config(None, **NARROW)
    model = trainer.make_model(tcfg, with_gs=True)
    init_weights(model, torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), tmp / "init.pt")
    params = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    jrcfg = JRasterizeConfig(backend="pallas", interpret=True,
                             **NARROW["raster"])
    return tmp, tcfg, jcfg, params, jrcfg


def test_two_rank_step_matches_jax_mesh(both):
    """One step: every metric at 1e-4 relative; the parameters after it.
    AdamW's first update is lr * g / (|g| + 1e-8), so an element moves by
    about +-lr whatever its gradient's size, and where a gradient is
    rounding noise (a bias in front of a GroupNorm) its sign differs
    between any two implementations: 99% of the elements must agree to
    2% of lr, and every element stays within the largest possible move."""
    tmp, tcfg, jcfg, params, jrcfg = both
    mesh = jsharding.make_mesh(2)
    jmodel = jtrainer.make_model(jcfg, with_gs=True)
    jstep = jax.jit(jtrainer.make_sharded_train_step(
        jmodel, jcfg, "stage2", jrcfg, mesh))
    jst, met_j = jstep(jstate.create_state(jcfg, params),
                       jsharding.shard_batch(mesh, jfake_batch(
                           batch=2, res=RES, novel_res=RES)))

    ranks = spawn_ranks("rank_train_steps", 2, dict(
        cfg=tcfg, init=str(tmp / "init.pt"), batch=BATCH, steps=1,
        device="cpu", out=str(tmp / "after.pt")), tmp)
    met = ranks[0]["metrics"][0]
    assert ranks[1]["metrics"][0] == met, "every rank reduces alike"
    assert set(met) == set(met_j) | {"grad_norm"}
    for k, v in met_j.items():
        np.testing.assert_allclose(met[k], float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert met["num_dropped"] == met["num_pair_dropped"] == 0

    before = torch.load(tmp / "init.pt")
    after = torch.load(tmp / "after.pt")
    after_j = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jst.params))
    lr = tstate.onecycle_linear(tcfg.lr, tcfg.num_steps + 100)(0)
    close = total = 0
    for name, p0 in before.items():
        d_t = (after[name] - p0).numpy()
        d_j = (after_j[name] - p0).numpy()
        assert np.abs(d_t).max() <= 1.01 * lr, name
        close += int((np.abs(d_t - d_j) <= 0.02 * lr).sum())
        total += d_t.size
    assert close >= 0.99 * total, (close, total)
