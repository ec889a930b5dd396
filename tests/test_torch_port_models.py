"""Port model blocks against the JAX package on converted flax weights.

A narrow GPSGaussianModel (encoder (16, 24, 32), hidden 32, gsnet (16, 24,
32) / (24, 32, 32) / 16) is initialised in the port from a seed, its
weights are carried to flax by the JAX package's own importer
(`convert_state_dict`) and back by `state_dict_from_flax`, loaded strictly
into a second port model, and every block is run on the same numpy inputs
(res 64). In f32 both sides differ
only in convolution summation order, so block outputs agree to about 1e-6
relative; the tolerances below are 1e-4 absolute for single blocks and
2e-4 for the iterated RAFT head and the whole model, whose flows are
O(1-10). The bf16 case is held to a few bf16 rounding steps instead,
since the two frameworks round bf16 convolutions at different places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.kernels.rasterizer import \
    RasterizeConfig as JRasterizeConfig
from gps_gaussian_tpu.models.encoders import (MultiBasicEncoder,
                                              UnetExtractor)
from gps_gaussian_tpu.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu.models.gsnet import GSRegresser
from gps_gaussian_tpu.models.layers import ResidualBlock
from gps_gaussian_tpu.models.raft import RaftStereoHuman
from gps_gaussian_tpu.models.update import BasicUpdateBlock
from gps_gaussian_tpu.train.trainer import render_novel as jrender_novel
from gps_gaussian_tpu.utils.containers import NovelView as JNovelView
from gps_gaussian_tpu.utils.containers import SourceView, StereoSample
from gps_gaussian_tpu.utils.torch_import import convert_state_dict

from gps_gaussian_tpu_torch.geometry import cameras as tcam
from gps_gaussian_tpu_torch.kernels.rasterizer import RasterizeConfig
from gps_gaussian_tpu_torch.models.gps_gaussian import \
    GPSGaussianModel as TModel
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import silhouette_stereo_batch
from gps_gaussian_tpu_torch.train.trainer import render_novel
from gps_gaussian_tpu_torch.utils.containers import NovelView
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

ENC, HID, GS_ENC, GS_DEC, HEAD = (16, 24, 32), 32, (16, 24, 32), \
    (24, 32, 32), 16
RES = 64


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _close(ours, ref, atol, rtol=0.0, nchw=True):
    """ours: an NCHW port feature map (or NHWC with nchw=False)."""
    if nchw and ours.dim() == 4:
        ours = ours.permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def _models(dtype):
    cd = torch.bfloat16 if dtype else None
    seeded = TModel(ENC, HID, HID, 4, 4, GS_ENC, GS_DEC, HEAD, compute_dtype=cd)
    init_weights(seeded, torch.Generator().manual_seed(7))
    params = convert_state_dict(
        {k: v.numpy() for k, v in seeded.state_dict().items()})
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tm = TModel(ENC, HID, HID, 4, 4, GS_ENC, GS_DEC, HEAD, compute_dtype=cd)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    jm = GPSGaussianModel(ENC, HID, HID, 4, 4, GS_ENC, GS_DEC, HEAD,
                          with_gs=True, dtype=dtype)
    return jm, params["params"], tm.eval()


@pytest.fixture(scope="module")
def f32_models():
    return _models(None)


def test_residual_blocks_match(f32_models, rng):
    _, p, tm = f32_models
    x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    for jname, tblock, planes, stride in (
            ("res1a", tm.img_encoder.res1[0], ENC[0], 1),
            ("res2a", tm.img_encoder.res2[0], ENC[1], 2)):
        xin = x[..., :tblock.conv1.in_channels]
        ref = ResidualBlock(planes, stride).apply(
            {"params": p["img_encoder"][jname]}, jnp.asarray(xin))
        with torch.no_grad():
            _close(tblock(_nchw(xin)), ref, 1e-4)


def test_encoders_match(f32_models, rng):
    _, p, tm = f32_models
    img = rng.uniform(-1, 1, size=(2, RES, RES, 3)).astype(np.float32)
    refs = UnetExtractor(ENC).apply({"params": p["img_encoder"]},
                                    jnp.asarray(img))
    with torch.no_grad():
        ours = tm.img_encoder(_nchw(img))
    for o, r in zip(ours, refs):
        _close(o, r, 1e-4)
    f8 = np.asarray(refs[2])
    (h, c), f1, f2 = MultiBasicEncoder(ENC, HID, HID).apply(
        {"params": p["raft_stereo"]["cnet"]}, jnp.asarray(f8))
    with torch.no_grad():
        (th, tc), tf1, tf2 = tm.raft_stereo.cnet(_nchw(f8))
    for o, r in ((th, h), (tc, c), (tf1, f1), (tf2, f2)):
        _close(o, r, 1e-4)


def test_update_block_matches(f32_models, rng):
    _, p, tm = f32_models
    n, h, w = 2, 8, 8
    net = rng.normal(size=(n, h, w, HID)).astype(np.float32)
    czqr = [rng.normal(size=(n, h, w, HID)).astype(np.float32)
            for _ in range(3)]
    flow = rng.normal(size=(n, h, w, 2)).astype(np.float32)
    corr = rng.normal(size=(n, h, w, 36)).astype(np.float32)
    ref = BasicUpdateBlock(HID, 8).apply(
        {"params": p["raft_stereo"]["update_block"]}, jnp.asarray(net),
        tuple(map(jnp.asarray, czqr)), jnp.asarray(flow), jnp.asarray(corr))
    with torch.no_grad():
        ours = tm.raft_stereo.update_module["update_block"](
            _nchw(net), tuple(map(_nchw, czqr)), _nchw(flow), _nchw(corr))
    for o, r in zip(ours, ref):
        _close(o, r, 1e-4)


def test_raft_and_gsnet_match(f32_models, rng):
    _, p, tm = f32_models
    f8 = rng.normal(size=(2, 8, 8, ENC[2])).astype(np.float32)
    refs = RaftStereoHuman(ENC, HID, HID).apply(
        {"params": p["raft_stereo"]}, jnp.asarray(f8), iters=3)
    with torch.no_grad():
        ours = tm.raft_stereo(_nchw(f8), iters=3)
    assert len(ours) == len(refs) == 3
    for o, r in zip(ours, refs):
        _close(o, r, 2e-4, nchw=False)

    img = rng.uniform(-1, 1, size=(2, RES, RES, 3)).astype(np.float32)
    depth = rng.uniform(0, 0.6, size=(2, RES, RES, 1)).astype(np.float32)
    feats = UnetExtractor(ENC).apply({"params": p["img_encoder"]},
                                     jnp.asarray(img))
    ref = GSRegresser(ENC, GS_ENC, GS_DEC, HEAD).apply(
        {"params": p["gs_regresser"]}, jnp.asarray(img), jnp.asarray(depth),
        feats)
    with torch.no_grad():
        ours = tm.gs_parm_regresser(_nchw(img), _nchw(depth),
                                    tuple(_nchw(f) for f in feats))
    for o, r in zip(ours, ref):
        _close(o, r, 1e-4)


def _run_both(jm, p, tm):
    """Both full forwards on one silhouette pair, whose zero-flow geometry
    is a plane at z = 2, so points stay O(1) and well conditioned.
    Returns (port output, JAX output, the pair's numpy sample dict)."""
    batch_t, sample = silhouette_stereo_batch(RES, 0.3, seed=2)

    def jax_view(v):
        return SourceView(**{f.name: jnp.asarray(getattr(v, f.name).numpy())
                             for f in dataclasses.fields(SourceView)
                             if getattr(v, f.name) is not None})

    batch_j = StereoSample(lmain=jax_view(batch_t.lmain),
                           rmain=jax_view(batch_t.rmain))
    ref = jax.jit(lambda b: jm.apply({"params": p}, b, iters=3,
                                     test_mode=True))(batch_j)
    with torch.no_grad():
        out = tm(batch_t, iters=3, test_mode=True)
    return out, ref, sample


def _compare_model(out, ref, atol_flow, atol_maps, rtol_xyz, min_inv):
    assert len(out.flow_preds) == len(ref.flow_preds) == 1
    _close(out.final_flow, ref.final_flow, atol_flow, nchw=False)
    for gs_t, gs_j in ((out.lmain_gs, ref.lmain_gs),
                       (out.rmain_gs, ref.rmain_gs)):
        for f in ("rgb", "rot", "scale", "opacity", "valid", "depth"):
            _close(getattr(gs_t, f), getattr(gs_j, f), atol_maps, nchw=False)
        # z = 1 / inverse depth: a point's relative error is the inverse
        # depth's error over its size, so points are compared relative to
        # their magnitude where the inverse depth is well away from 0
        inv = np.asarray(gs_j.depth)[..., 0]
        sel = np.abs(inv) >= min_inv
        assert sel.mean() > 0.05
        np.testing.assert_allclose(gs_t.xyz.numpy()[sel],
                                   np.asarray(gs_j.xyz)[sel], rtol=rtol_xyz,
                                   atol=atol_maps)


@pytest.fixture(scope="module")
def f32_outputs(f32_models):
    return _run_both(*f32_models)


def test_full_model_matches_f32(f32_outputs):
    out, ref, _ = f32_outputs
    _compare_model(out, ref, atol_flow=2e-4, atol_maps=2e-4, rtol_xyz=1e-4,
                   min_inv=0.05)


def test_full_model_matches_bf16():
    """bf16 convolutions, f32 params/norms/gates/heads (the stage-2
    policy). Maps agree to a few bf16 steps (2^-7 relative): 5e-2 covers
    the normalised quaternion, which amplifies rounding where the raw
    head output is short; flows carry it through three GRU iterations."""
    out, ref, _ = _run_both(*_models(jnp.bfloat16))
    _compare_model(out, ref, atol_flow=0.1, atol_maps=5e-2, rtol_xyz=0.1,
                   min_inv=0.2)


def test_render_novel_matches(f32_outputs):
    """render_novel splats both views' Gaussians of the same model outputs;
    the port's (plain composite) against JAX's Pallas route in interpret
    mode, images at 1e-4 (the Gaussians already differ by ~1e-5) and the
    drop counters exactly. The caps do not bind here: where they do, a
    ~1e-5 shift can move a Gaussian's integer radius and with it a count,
    so binding caps are held on identical inputs in test_torch_port_raster.
    """
    out, ref, sample = f32_outputs
    intr0, intr1 = sample["intr_ori"]
    extr0, extr1 = sample["extr_ori"]
    args = (intr0, extr0, intr1, extr1, 0.5, RES, RES)
    jc, _, _ = jcam.interpolated_novel_camera(*args)
    tc, _, _ = tcam.interpolated_novel_camera(*args)
    caps = dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=4096)
    bg = np.array([0.0, 0.5, 1.0], np.float32)
    img_j, aux_j = jrender_novel(
        ref, JNovelView(camera=jcam.make_novel_camera([jc], RES, RES)), bg,
        JRasterizeConfig(backend="pallas", interpret=True, **caps))
    img_t, aux_t = render_novel(
        out, NovelView(camera=tcam.make_novel_camera([tc], RES, RES)), bg,
        RasterizeConfig(**caps), device="cpu")
    for f in ("num_dropped", "num_fg_dropped", "num_pair_dropped"):
        np.testing.assert_array_equal(getattr(aux_t, f).numpy(),
                                      np.asarray(getattr(aux_j, f)), f)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4,
                               rtol=0)
    assert float((aux_t.transmittance < 0.5).float().mean()) > 0.05
