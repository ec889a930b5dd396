"""The span-staircase binning of the port against the JAX package.

On the scene of tests/test_staircase.py (512 Gaussians, 64^2, fg_cap 320,
which binds) the port's `rasterize_single` with a `span_schedule` is held to
JAX `rasterize_single(backend="pallas", interpret=True)`: images and
transmittance at atol 1e-5 with every counter equal, the gradients of a
fixed weighted image sum at 1e-5 of each input's largest (as
test_torch_port_grads.py); the one-class schedule at K 16 bit-equal to the
port's uniform-K path at 16, images and gradients; ellipse rectangles
against circles; a starved schedule counting JAX's drops; and
`validate_span_schedule` raising where JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.kernels.rasterizer import RasterizeConfig as JCfg
from gps_gaussian_tpu.kernels.rasterizer import \
    rasterize_single as jrasterize_single

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize_single)
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import (
    staircase_pairs, stack_rows, validate_span_schedule)
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians

from thread_budget import thread_budget  # noqa: F401

BASE = dict(fg_cap=320, max_per_tile=512, pair_budget=4096)
GRAD_NAMES = ("xyz", "rot", "scale", "opacity", "rgb")
SCHEDULES = {
    "one-class": dict(span_schedule=((16, 320),)),
    "staircase": dict(span_schedule=((16, 64), (8, 128), (4, 128))),
    "ellipse": dict(span_schedule=((16, 320),), ellipse_rects=True),
    "starved": dict(span_schedule=((2, 64), (1, 64))),
}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    res, n = 64, 512
    xyz = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    xyz[:, 2] += 2.0
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scale = rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32)
    op = rng.uniform(0.2, 0.9, (n, 1)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = (rng.uniform(size=(n,)) < 0.6).astype(np.float32)
    K = np.array([[0.8 * res, 0, res / 2], [0, 0.8 * res, res / 2],
                  [0, 0, 1]], np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    cam = jcam.camera_from_intr_extr(K, E, res, res)
    fields = dict(xyz=xyz, rot=q, scale=scale, opacity=op, rgb=col)
    w = np.cos(np.arange(res * res * 3, dtype=np.float32)).reshape(
        res, res, 3)
    return res, fields, valid, cam, w


def _port(scene, cfg):
    res, fields, valid, cam, w = scene
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in fields.items()}
    img, aux = rasterize_single(
        *(leaves[k] for k in GRAD_NAMES[:3]), leaves["opacity"],
        leaves["rgb"], torch.tensor(valid), torch.tensor(cam["view"]),
        torch.tensor(cam["proj"]), cam["tanfovx"], cam["tanfovy"], res, res,
        torch.zeros(3), cfg, device="cpu")
    (img * torch.tensor(w)).sum().backward()
    return img.detach(), aux._replace(
        transmittance=aux.transmittance.detach()), {
        k: leaves[k].grad for k in GRAD_NAMES}


def _jax(scene, cfg):
    res, fields, valid, cam, w = scene

    def loss(f):
        img, aux = jrasterize_single(
            f["xyz"], f["rot"], f["scale"], f["opacity"], f["rgb"],
            jnp.asarray(valid), jnp.asarray(cam["view"]),
            jnp.asarray(cam["proj"]), cam["tanfovx"], cam["tanfovy"], res,
            res, jnp.zeros(3, jnp.float32), cfg)
        return jnp.sum(img * w), (img, aux)

    (_, (img, aux)), g = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in fields.items()})
    return img, aux, g


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_staircase_matches_jax(scene, name):
    cfg = SCHEDULES[name]
    img_t, aux_t, g_t = _port(scene, RasterizeConfig(**BASE, **cfg))
    img_j, aux_j, g_j = _jax(scene, JCfg(backend="pallas", interpret=True,
                                         **BASE, **cfg))
    for f in ("num_dropped", "num_fg_dropped", "num_pair_dropped"):
        assert int(getattr(aux_t, f)) == int(getattr(aux_j, f)), f
    assert int(aux_t.num_fg_dropped) > 0, "fg_cap binds on this scene"
    assert (int(aux_t.num_dropped) > 0) == (name == "starved")
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux_t.transmittance.numpy(),
                               np.asarray(aux_j.transmittance), atol=1e-5,
                               rtol=0)
    for k in GRAD_NAMES:
        ref = np.asarray(g_j[k])
        s = np.abs(ref).max()
        assert s > 0, k
        np.testing.assert_allclose(g_t[k].numpy() / s, ref / s, atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["one-class", "staircase"])
def test_staircase_bit_equal_to_uniform_k(scene, name):
    """Ties of the packed (tile | depth) key are broken by the pair's
    original row, as in the uniform-K path's stable sort, and each row's
    pair gradients are summed by the same reduction: a schedule that drops
    nothing gives the same bits, images and gradients. The second schedule
    is JAX's own realistic staircase (tests/test_staircase.py:62)."""
    img_l, aux_l, g_l = _port(scene, RasterizeConfig(
        max_tiles_per_gaussian=16, **BASE))
    img_s, aux_s, g_s = _port(scene, RasterizeConfig(**BASE,
                                                     **SCHEDULES[name]))
    assert torch.equal(img_l, img_s)
    assert torch.equal(aux_l.transmittance, aux_s.transmittance)
    for k in GRAD_NAMES:
        assert torch.equal(g_l[k], g_s[k]), k
    assert [int(x) for x in aux_l[1:]] == [int(x) for x in aux_s[1:]]


def test_tie_heavy_staircase_bit_equal(scene):
    """Every Gaussian at one depth, so that the packed keys tie within each
    tile: the one-class staircase still gives the uniform-K path's bits,
    and the render with and without autograd agrees."""
    res, fields, valid, cam, w = scene
    xyz = fields["xyz"].copy()
    xyz[:, 2] = 2.0
    tied = (res, dict(fields, xyz=xyz), valid, cam, w)
    img_l, _, g_l = _port(tied, RasterizeConfig(max_tiles_per_gaussian=16,
                                                **BASE))
    cfg = RasterizeConfig(**BASE, **SCHEDULES["one-class"])
    img_s, _, g_s = _port(tied, cfg)
    assert torch.equal(img_l, img_s)
    for k in GRAD_NAMES:
        assert torch.equal(g_l[k], g_s[k]), k
    with torch.no_grad():
        img_n, _ = rasterize_single(
            *(torch.tensor(tied[1][k]) for k in GRAD_NAMES),
            torch.tensor(valid), torch.tensor(cam["view"]),
            torch.tensor(cam["proj"]), cam["tanfovx"], cam["tanfovy"], res,
            res, torch.zeros(3), cfg, device="cpu")
    assert torch.equal(img_n, img_s)


def test_ellipse_rects_fewer_pairs_and_close(scene):
    """Ellipse rectangles never make more pairs than circles; the image
    stays within 0.05 of the circles' (tests/test_staircase.py:84-98)."""
    res, fields, valid, cam, _ = scene
    t = {k: torch.tensor(v) for k, v in fields.items()}
    p = project_gaussians(t["xyz"], t["rot"], t["scale"], t["opacity"],
                          t["rgb"], torch.tensor(valid),
                          torch.tensor(cam["view"]), torch.tensor(cam["proj"]),
                          float(cam["tanfovx"]), float(cam["tanfovy"]), res,
                          res)
    stacked = stack_rows(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                         p.radius)[None]
    sched = SCHEDULES["one-class"]["span_schedule"]
    _, _, c_circle, _, _ = staircase_pairs(stacked, res, res, ((16, 512),),
                                           512, None)
    _, _, c_ellipse, _, _ = staircase_pairs(stacked, res, res, ((16, 512),),
                                            512, None, ellipse=True)
    assert 0 < int(c_ellipse.sum()) < int(c_circle.sum())
    img_c, _, _ = _port(scene, RasterizeConfig(**BASE, span_schedule=sched))
    img_e, aux_e, g_e = _port(scene, RasterizeConfig(
        **BASE, span_schedule=sched, ellipse_rects=True))
    assert float((img_c - img_e).abs().max()) < 0.05
    assert int(aux_e.num_dropped) == 0
    assert all(bool(torch.isfinite(g).all()) for g in g_e.values())


def test_validate_span_schedule_raises_as_jax():
    """The inputs of tests/test_bench_config.py:41-53."""
    with pytest.raises(ValueError, match="rows > fg_cap"):
        validate_span_schedule(
            ((9, 6144), (6, 56320), (4, 225280), (2, 71680), (1, 16384)),
            352_256)
    with pytest.raises(ValueError, match="6 bits"):
        validate_span_schedule(((64, 8),), 352_256)
    with pytest.raises(ValueError, match="batch"):
        validate_span_schedule(((9, 8),), 352_256, batch=9)
    with pytest.raises(ValueError, match="2\\^22"):
        validate_span_schedule(((9, 8),), (1 << 22) + 8)
    validate_span_schedule(((9, 8), (1, 8)), 16, batch=2)
    # bench.py's headline literals pass
    validate_span_schedule(((9, 6144), (6, 56320), (4, 217088), (2, 65536),
                            (1, 7168)), 352_256)
