"""(e) The whole serving slice: the port's FreeviewRenderer against the JAX
package's, on the committed stage-2 checkpoint (runs/synth256/stage2, full
stage-2 width) converted to a torch state_dict, a synthetic res-64 scene,
iters 3, and the Pallas route in interpret mode on the JAX side.

Tolerances, f32: the two stereo forwards differ only in convolution
summation order, so the Gaussians agree to ~1e-5 (atol 1e-4); such shifts
move a splat by far less than a pixel, leave every radius, tile rectangle
and quantized depth key alike, and the images agree to ~1e-5 (atol 1e-4).
The drop counters must be equal. bf16 (the stage-2 policy): the two
frameworks round bf16 convolutions at different places, so Gaussians move
by a few bf16 steps and the image is held in mean (2e-4) and max (3e-2)
instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.data import synth
from gps_gaussian_tpu.data.loader import collate
from gps_gaussian_tpu.data.thuman import DatasetConfig, StereoHumanDataset
from gps_gaussian_tpu.infer.freeview import FreeviewRenderer as JRenderer
from gps_gaussian_tpu.kernels.rasterizer import rasterize as jrasterize
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train.state import restore_params_partial
from gps_gaussian_tpu.train.trainer import make_model as jmake_model

from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.utils import containers as C
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

RES = 64
CKPT = "runs/synth256/stage2"
RASTER = dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=6000,
              pair_budget=None)
FIELDS = ("xyz", "rgb", "rot", "scale", "opacity")


def _overrides(mixed_precision):
    return dict(raft=dict(mixed_precision=mixed_precision),
                dataset=dict(src_res=RES, use_hr_img=False,
                             use_processed_data=False),
                raster=RASTER)


def _port_batch(batch):
    def view(v):
        return C.SourceView(**{
            f.name: torch.tensor(np.asarray(getattr(v, f.name)))
            for f in dataclasses.fields(C.SourceView)
            if getattr(v, f.name) is not None})

    return C.StereoSample(lmain=view(batch.lmain), rmain=view(batch.rmain))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("freeview_port")
    synth.generate_dataset(root, n_train=1, n_val=0, res=RES, hr=False)
    ds = StereoHumanDataset(DatasetConfig(data_root=str(root / "train"),
                                          src_res=RES,
                                          use_processed_data=False), "test")
    sample = ds.get_test_sample(0)
    batch = collate([sample])
    model = jmake_model(jconfig.load_config(None), with_gs=True)
    target = jax.eval_shape(
        lambda k: model.init(k, batch, iters=3, test_mode=True),
        jax.random.PRNGKey(0))
    params, n = restore_params_partial(CKPT, target)
    assert n == 246
    return sample, batch, params


def _renderers(scene, mixed_precision):
    sample, batch, params = scene
    jcfg = jconfig.load_config(None, **_overrides(mixed_precision))
    jcfg = dataclasses.replace(jcfg, raster=dataclasses.replace(
        jcfg.raster, backend="pallas"))
    jr = JRenderer(jcfg, params)
    jr.rcfg = dataclasses.replace(jr.rcfg, interpret=True)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tr = FreeviewRenderer(tconfig.load_config(
        None, **_overrides(mixed_precision)), sd, device="cpu")
    return jr, jr.gaussians(batch), tr, tr.gaussians(_port_batch(batch))


@pytest.fixture(scope="module")
def f32(scene):
    return _renderers(scene, False)


def _valid_rows(g_jax, g_port):
    """Both compactions keep the same rows in the same slots (groups of 8
    rows with a valid row, their dead rows included): the validity columns
    are equal. Returns the mask of valid rows, the same for both."""
    vj = np.asarray(g_jax.valid[0])
    vt = g_port.valid[0].numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 300 and (vt == 0).any()
    return vt > 0, vt > 0


def test_gaussians_match_f32(f32):
    """Valid rows at atol 1e-4; every row, the dead rows of kept groups
    too, at 1e-4 relative: a dead pixel's inverse depth is 0, so its point
    lies ~1e8 away, where the two forwards' f32 arithmetic differs by a few
    ulps (seen: 1.2e-5 relative)."""
    _, gj, _, gt = f32
    vj, vt = _valid_rows(gj, gt)
    assert gt.count == RASTER["fg_cap"]
    for f in FIELDS:
        ours, ref = getattr(gt, f)[0].numpy(), np.asarray(getattr(gj, f))[0]
        np.testing.assert_allclose(ours[vt], ref[vj], atol=1e-4, rtol=0,
                                   err_msg=f)
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("caps", ["config", "binding"])
def test_render_matches_f32(scene, f32, caps):
    sample = scene[0]
    jr, gj, tr, gt = f32
    jrcfg, saved = jr.rcfg, tr.rcfg
    if caps == "binding":
        new = dict(max_tiles_per_gaussian=2, max_per_tile=16,
                   pair_budget=600)
        jrcfg = dataclasses.replace(jrcfg, **new)
        tr.rcfg = dataclasses.replace(tr.rcfg, **new)
    try:
        for ratio in (0.25, 0.5):
            cam_j = jr.novel_camera_at(sample, ratio, RES, RES)
            img_j, aux_j = jrasterize(gj, cam_j, jnp.zeros(3), jrcfg)
            img_t, aux_t = tr.render(gt, tr.novel_camera_at(sample, ratio,
                                                            RES, RES))
            for f in ("num_dropped", "num_fg_dropped", "num_pair_dropped"):
                np.testing.assert_array_equal(
                    getattr(aux_t, f).numpy(), np.asarray(getattr(aux_j, f)),
                    f)
            np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(aux_t.transmittance.numpy(),
                                       np.asarray(aux_j.transmittance),
                                       atol=1e-4, rtol=0)
            # the scene is visible; with the binding caps only a few pairs
            # survive, so some pixels are still covered
            covered = float((aux_t.transmittance < 0.5).float().mean())
            assert covered > (0.02 if caps == "config" else 0.0), covered
    finally:
        tr.rcfg = saved
    fg, pair = tr.flush_drop_report()
    assert fg == 0
    assert (pair > 0) == (caps == "binding")
    assert tr.flush_drop_report() == (0, 0)


def test_slice_matches_bf16(scene):
    sample = scene[0]
    jr, gj, tr, gt = _renderers(scene, True)
    vj, vt = _valid_rows(gj, gt)
    for f in ("rot", "scale", "opacity"):
        np.testing.assert_allclose(getattr(gt, f)[0].numpy()[vt],
                                   np.asarray(getattr(gj, f))[0][vj],
                                   atol=5e-2, rtol=0, err_msg=f)
    img_j, _ = jr.render(gj, jr.novel_camera_at(sample, 0.5, RES, RES))
    img_t, aux_t = tr.render(gt, tr.novel_camera_at(sample, 0.5, RES, RES))
    diff = np.abs(img_t.numpy() - np.asarray(img_j))
    assert diff.mean() < 2e-4 and diff.max() < 3e-2, (diff.mean(),
                                                      diff.max())
    assert int(aux_t.num_pair_dropped.sum()) == 0
