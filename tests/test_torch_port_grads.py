"""Gradients of the port's rasterizer and RAFT head against the JAX package.

(a) `composite_bwd_plain` (the CUDA backward kernel's CPU counterpart)
    against `jax.vjp` of `_composite_core` in interpret mode on the same
    sorted pairs and cotangents, per property row;
(b) gradients of a scalar loss through `rasterize` with respect to xyz, rot,
    scale, opacity and rgb against `jax.grad` through the JAX `rasterize`
    (`backend="pallas", interpret=True`), batch 2, with invalid and culled
    rows, whose gradients are exactly 0;
(c) `composite_bwd_plain` with the pair sort's backward against
    `torch.autograd` through the exact oracle `composite_reference`;
(f) parameter gradients of the stage-1 loss at 3 GRU iterations in f32:
    they match only with the stop-gradient on `coords1` at the top of every
    iteration.

Tolerances are relative to the largest gradient of the row or tensor
compared, as tests/test_pallas_rasterizer.py states them: the two sides add
the same terms in different orders (JAX: 128-lane Hillis-Steele scans and a
sublane sum; the port: a sequential walk and torch.sum) and JAX recovers
exp(power) as alpha_un / opacity, about 1 ulp from the port's exp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.kernels.rasterizer import RasterizeConfig as JCfg
from gps_gaussian_tpu.kernels.rasterizer import rasterize as jrasterize
from gps_gaussian_tpu.kernels.rasterizer.pallas_kernel import (
    CHUNK, DCH, PROPW, _composite_core)
from gps_gaussian_tpu.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu.train import losses as jlosses
from gps_gaussian_tpu.utils import containers as JC
from gps_gaussian_tpu.utils.torch_import import convert_state_dict

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize,
                                                       take_rows_unique)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
    composite, composite_bwd, composite_bwd_plain, composite_fwd)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    render_sorted, stack_rows)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import (
    Projected, project_gaussians)
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import \
    composite_reference
from gps_gaussian_tpu_torch.models.gps_gaussian import \
    GPSGaussianModel as TModel
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.testing import silhouette_train_batch
from gps_gaussian_tpu_torch.train import losses
from gps_gaussian_tpu_torch.utils.containers import (FlatGaussians,
                                                     NovelCamera)
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

RES = 48  # 3 x 3 tiles
ROWS = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")


def _sorted_pairs(rng, tiles_y, tiles_x, batch):
    """Random depth-ordered pair segments: some tiles empty, some spanning
    several 128-pair chunks, opaque enough that many pixels end at T_EPS and
    some alphas clamp at 0.99."""
    n_tiles = batch * tiles_y * tiles_x
    count = rng.integers(0, 400, n_tiles)
    count[::5] = 0
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    P = int(count.sum())
    tile_of = np.repeat(np.arange(n_tiles), count) % (tiles_y * tiles_x)
    cx = (tile_of % tiles_x) * 16 + rng.uniform(-8, 24, P)
    cy = (tile_of // tiles_x) * 16 + rng.uniform(-8, 24, P)
    ca = rng.uniform(0.005, 0.2, P)
    cc = rng.uniform(0.005, 0.2, P)
    cb = rng.uniform(-0.5, 0.5, P) * np.sqrt(ca * cc)
    op = rng.uniform(0.05, 1.2, P)
    rgb = rng.uniform(0, 1, (3, P))
    props = np.stack([cx, cy, ca, cb, cc, op, *rgb]).astype(np.float32)
    return props, start.astype(np.int32), count.astype(np.int32)


def _jax_layout(props):
    """(9, P) -> the Pallas kernel's (p_chunks + DCH, 16, 128) layout."""
    P = props.shape[1]
    p_chunks = -(-P // CHUNK)
    rows = np.zeros((PROPW, p_chunks * CHUNK), np.float32)
    rows[:9, :P] = props
    props3d = rows.reshape(PROPW, p_chunks, CHUNK).transpose(1, 0, 2)
    return np.pad(props3d, ((0, DCH), (0, 0), (0, 0)))


def _port_layout(gprops3d, P):
    """The Pallas layout back to (9, P)."""
    g = np.asarray(gprops3d)[:-DCH]
    return g.transpose(1, 0, 2).reshape(PROPW, -1)[:9, :P]


@pytest.mark.parametrize("batch", [1, 2])
def test_plain_composite_bwd_matches_jax_vjp(rng, batch):
    """(a). Each row is held to 1e-5 of its largest gradient."""
    ty, tx = 3, 4
    props, start, count = _sorted_pairs(rng, ty, tx, batch)
    g_out = rng.normal(size=(batch * ty * tx, 256, 4)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda p: _composite_core(p, jnp.asarray(start), jnp.asarray(count),
                                  batch, ty, tx, True),
        jnp.asarray(_jax_layout(props)))
    ref = _port_layout(vjp(jnp.asarray(g_out))[0], props.shape[1])

    tp, ts, tc = (torch.tensor(props), torch.tensor(start),
                  torch.tensor(count))
    out = composite_fwd(tp, ts, tc, ty, tx)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    ours, walked, blended, reached = composite_bwd_plain(
        tp, ts, tc, out, torch.tensor(g_out), ty, tx, return_work=True)
    ours = ours.numpy()
    assert 0 < int(blended) < int(walked) <= int(count.sum()) * 256
    assert int(walked) / 256 <= int(reached) <= int(count.sum())
    assert (props[5] > 0.99).any(), "some alphas must clamp"
    for k, name in enumerate(ROWS):
        s = np.abs(ref[k]).max()
        assert s > 0, name
        np.testing.assert_allclose(ours[k] / s, ref[k] / s, atol=1e-5,
                                   rtol=0, err_msg=name)
    # pairs outside every segment (a tile's tail past its count is none
    # here, but empty tiles are) keep exactly zero, as do unreached pairs
    reached = np.abs(ref).sum(0) > 0
    assert (ours[:, ~reached] == 0).all()

    # the wrapper and the autograd function give the same on the CPU
    leaf = tp.clone().requires_grad_(True)
    img = composite(leaf, ts, tc, ty, tx)
    # a permuted, non-contiguous cotangent, as untile's backward hands over
    g_perm = torch.tensor(g_out).permute(2, 0, 1).contiguous().permute(
        1, 2, 0)
    assert not g_perm.is_contiguous()
    img.backward(g_perm)
    np.testing.assert_array_equal(leaf.grad.numpy(), ours)
    np.testing.assert_array_equal(
        composite_bwd(tp, ts, tc, out, torch.tensor(g_out), ty, tx).numpy(),
        ours)


def _scene(rng, n, batch):
    xyz = rng.normal(scale=0.3, size=(batch, n, 3)).astype(np.float32)
    xyz[:, ::17, 2] = -3.0   # behind the camera: culled by the near plane
    q = rng.normal(size=(batch, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scale = rng.uniform(0.005, 0.06, (batch, n, 3)).astype(np.float32)
    opacity = rng.uniform(0.1, 0.95, (batch, n, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (batch, n, 3)).astype(np.float32)
    # validity row by row inside groups of 8 rows, about 30% of the groups
    # wholly invalid: compaction keeps every group with a valid row, so
    # fg_cap 280 of the 320 rows does not bind
    valid = ((rng.uniform(size=(batch, n // 8, 1)) > 0.3)
             & (rng.uniform(size=(batch, n // 8, 8)) > 0.15)).reshape(
        batch, n).astype(np.float32)
    cams = []
    for b in range(batch):
        K = np.array([[0.8 * RES, 0, RES / 2 + 2 * b],
                      [0, 0.8 * RES, RES / 2], [0, 0, 1]], np.float32)
        E = np.eye(3, 4, dtype=np.float32)
        E[0, 3] = 0.05 * b
        E[2, 3] = 2.0
        cams.append(jcam.camera_from_intr_extr(K, E, RES, RES))
    cam = {k: np.stack([c[k] for c in cams]) for k in cams[0]}
    return dict(xyz=xyz, rot=q, scale=scale, opacity=opacity, rgb=rgb), \
        valid, cam


GRAD_NAMES = ("xyz", "rot", "scale", "opacity", "rgb")


@pytest.mark.parametrize("caps", ["none", "fg"])
def test_rasterize_gradients_match_jax_pallas(rng, caps):
    """(b). The caps do not bind (fg_cap 280 holds every valid row, but
    turns the compaction gather and its unique-index backward on). Each
    input's gradient is held to 1e-5 of its largest entry."""
    batch, n = 2, 320
    fields, valid, cam = _scene(rng, n, batch)
    raster = dict(max_tiles_per_gaussian=16, max_per_tile=512,
                  fg_cap=280 if caps == "fg" else None)
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    w_img = rng.normal(size=(batch, RES, RES, 3)).astype(np.float32)
    w_t = rng.normal(size=(batch, RES, RES, 1)).astype(np.float32)

    jc = JC.NovelCamera(**{k: jnp.asarray(v) for k, v in cam.items()},
                        height=RES, width=RES)
    jcfg = JCfg(backend="pallas", interpret=True, **raster)

    def jloss(f):
        img, aux = jrasterize(JC.FlatGaussians(valid=jnp.asarray(valid), **f),
                              jc, jnp.asarray(bg), jcfg)
        return (jnp.sum(img * w_img) + jnp.sum(aux.transmittance * w_t),
                aux)

    (loss_j, aux_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in fields.items()})

    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in fields.items()}
    tc = NovelCamera(**{k: torch.tensor(v) for k, v in cam.items()},
                     height=RES, width=RES)
    img, aux = rasterize(FlatGaussians(valid=torch.tensor(valid), **leaves),
                         tc, bg, RasterizeConfig(**raster), device="cpu")
    loss = (img * torch.tensor(w_img)).sum() \
        + (aux.transmittance * torch.tensor(w_t)).sum()
    loss.backward()

    for f in ("num_dropped", "num_fg_dropped", "num_pair_dropped"):
        assert int(getattr(aux, f).sum()) == 0 == \
            int(np.asarray(getattr(aux_j, f)).sum()), f
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    dead = (valid < 0.5) | (fields["xyz"][..., 2] < -2.5)
    assert 0.2 < dead.mean() < 0.6
    for name in GRAD_NAMES:
        ours, ref = leaves[name].grad.numpy(), np.asarray(g_j[name])
        s = np.abs(ref).max()
        assert s > 0, name
        np.testing.assert_allclose(ours / s, ref / s, atol=1e-5, rtol=0,
                                   err_msg=name)
        assert (ours[dead] == 0).all(), f"{name}: culled rows get exactly 0"
        assert (ref[dead] == 0).all()


def test_plain_composite_bwd_matches_oracle_autograd(rng):
    """(c). From the same projected Gaussians, the tiled path (pair sort,
    plain composite, `composite_bwd_plain`, the unsort backward) against
    autograd through the O(pixels x N) oracle. The oracle composes T as
    exp(cumsum(log1p(-alpha))), the tiled walk by repeated multiplication:
    1e-4 of each field's largest gradient."""
    fields, valid, cam = _scene(rng, 240, 1)
    p = project_gaussians(
        *(torch.tensor(fields[k][0]) for k in
          ("xyz", "rot", "scale", "opacity", "rgb")), torch.tensor(valid[0]),
        torch.tensor(cam["view"][0]), torch.tensor(cam["proj"][0]),
        float(cam["tanfovx"][0]), float(cam["tanfovy"][0]), RES, RES)
    bg = torch.tensor([0.2, 0.3, 0.4])
    w_img = torch.tensor(rng.normal(size=(RES, RES, 3)).astype(np.float32))
    names = ("mean2d", "conic", "opacity", "color")

    def grads(render):
        leaves = {k: getattr(p, k).clone().requires_grad_(True)
                  for k in names}
        (render(p._replace(**leaves)) * w_img).sum().backward()
        return [leaves[k].grad.numpy() for k in names]

    def tiled(q: Projected):
        stacked = stack_rows(q.mean2d, q.conic, q.opacity, q.color, q.depth,
                             q.radius)[None]
        return render_sorted(stacked, RES, RES, 16, 512, None, bg)[0][0]

    ours = grads(tiled)
    ref = grads(lambda q: composite_reference(q, bg, RES, RES))
    for name, a, b in zip(names, ours, ref):
        s = np.abs(b).max()
        assert s > 0, name
        np.testing.assert_allclose(a / s, b / s, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_take_rows_unique_backward_is_a_copy(rng):
    x = torch.tensor(rng.normal(size=(12, 3)).astype(np.float32),
                     requires_grad=True)
    idx = torch.tensor([7, 2, 11, 0])
    g = torch.tensor(rng.normal(size=(4, 3)).astype(np.float32))
    out = take_rows_unique(x, idx)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  x.detach().numpy()[idx.numpy()])
    out.backward(g)
    want = np.zeros((12, 3), np.float32)
    want[idx.numpy()] = g.numpy()
    np.testing.assert_array_equal(x.grad.numpy(), want)


# ---------------------------------------------------------------- (f) RAFT

ENC, HID = (16, 24, 32), 32


def _jax_batch(batch):
    def view(v):
        return JC.SourceView(**{
            f.name: jnp.asarray(getattr(v, f.name).numpy())
            for f in dataclasses.fields(JC.SourceView)
            if getattr(v, f.name) is not None})

    return JC.StereoSample(lmain=view(batch.lmain), rmain=view(batch.rmain))


def test_stage1_parameter_gradients_match_jax():
    """(f). Stage-1 sequence loss at 3 GRU iterations, f32, the same
    converted weights: every parameter's gradient against JAX's, passed
    through `state_dict_from_flax` (which is linear). Without the per-
    iteration stop-gradient on coords1 the update block's and encoders'
    gradients differ by tens of percent; with it both sides differ only in
    summation order: 1e-4 of each tensor's largest gradient, floored at
    1e-6 absolute for tensors whose gradient is rounding noise (conv biases
    in front of a GroupNorm)."""
    tm = TModel(ENC, HID, HID, 4, 4, with_gs=False)
    init_weights(tm, torch.Generator().manual_seed(11))
    params = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}))["params"]
    jm = GPSGaussianModel(ENC, HID, HID, 4, 4, with_gs=False)
    batch = silhouette_train_batch(1, 64, 64, 0.3, seed=5)
    jbatch = _jax_batch(batch)

    def stacked(b, lib):
        cat = torch.cat if lib is torch else jnp.concatenate
        return (cat([b.lmain.flow, b.rmain.flow]),
                cat([b.lmain.valid, b.rmain.valid]))

    def jloss(p):
        out = jm.apply({"params": p}, jbatch, iters=3)
        return jlosses.sequence_loss(out.flow_preds, *stacked(jbatch, jnp))[0]

    loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(params)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))

    out = tm(batch, iters=3)
    loss = losses.sequence_loss(out.flow_preds, *stacked(batch, torch))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert len(named) > 60 and set(named) <= set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    for name, prm in named.items():
        s = max(float(ref[name].abs().max()), 1e-2 * top)
        np.testing.assert_allclose(prm.grad.numpy() / s,
                                   ref[name].numpy() / s, atol=1e-4, rtol=0,
                                   err_msg=name)
