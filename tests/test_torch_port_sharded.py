"""Tile-row-sharded rendering of the port against the JAX package.

`render_bands` (every band's `render_band` in one process) against JAX
`rasterize_tile_sharded` (Pallas in interpret mode) on `make_mesh(4)` (here)
and `make_mesh(8)` (test_torch_port_sharded_mesh8.py), on the scene of
tests/test_sharded_rasterizer.py at 112^2, whose 7 tile rows do not divide
among the bands: the images and transmittance at atol 1e-5 (the band shift
mean2d.y - y0 is a float subtraction on both sides) and every counter
summed over the bands equal.
Then two spawned ranks joined by a gloo group run `rasterize_tile_sharded`
and must return the band-by-band render bit for bit; and at caps that do
not bind the bands give `rasterize`'s image bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.kernels.rasterizer import RasterizeConfig as JCfg
from gps_gaussian_tpu.kernels.rasterizer.sharded import \
    rasterize_tile_sharded as jsharded
from gps_gaussian_tpu.train.sharding import make_mesh
from gps_gaussian_tpu.utils.containers import FlatGaussians as JFlat

from gps_gaussian_tpu_torch.geometry import cameras
from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize)
from gps_gaussian_tpu_torch.kernels.rasterizer.sharded import (
    band_height, render_band, render_bands)
from gps_gaussian_tpu_torch.testing import spawn_ranks
from gps_gaussian_tpu_torch.utils.containers import FlatGaussians

from thread_budget import thread_budget  # noqa: F401

NAMES = ("xyz", "rgb", "rot", "scale", "opacity", "valid")
COUNTERS = ("num_dropped", "num_fg_dropped", "num_pair_dropped")


def _scene(rng, n):
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return dict(
        xyz=rng.normal(0, 0.25, (1, n, 3)).astype(np.float32),
        rot=rot[None],
        scale=rng.uniform(0.005, 0.05, (1, n, 3)).astype(np.float32),
        opacity=rng.uniform(0.1, 0.95, (1, n, 1)).astype(np.float32),
        rgb=rng.uniform(0, 1, (1, n, 3)).astype(np.float32),
        valid=np.ones((1, n), np.float32))


def _camera(res):
    K = np.array([[0.8 * res, 0, res / 2], [0, 0.8 * res, res / 2],
                  [0, 0, 1]], np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    E[2, 3] = 2.0
    return jcam.camera_from_intr_extr(K, E, res, res)


def _both(arrays, cam, res):
    tg = FlatGaussians(**{k: torch.tensor(arrays[k]) for k in NAMES})
    tc = cameras.make_novel_camera([cam], res, res)
    jg = JFlat(**{k: jnp.asarray(arrays[k]) for k in NAMES})
    jc = jcam.make_novel_camera([cam], res, res)
    return tg, tc, jg, jc


# one JAX call per world (each compiles its interpret-mode kernel under
# shard_map, ~35 s on a CPU): 112^2 has 7 tile rows, which neither 4 nor 8
# bands divide, so the grid is padded and the image cropped in both
CASES = {
    # every cap binds: the band cap (96 of 300 rows), the duplication cap,
    # max_per_tile and the pair budget; drops are counted per band, summed
    4: dict(fg_cap=96, max_tiles_per_gaussian=2, max_per_tile=24,
            pair_budget=400),
    # the staircase in every band; the band cap (256 of 300) gathers
    8: dict(fg_cap=256, max_per_tile=512,
            span_schedule=((16, 96), (4, 160))),
}


def check_bands_match_jax(rng, world):
    res, n, caps = 112, 300, CASES[world]
    tg, tc, jg, jc = _both(_scene(rng, n), _camera(res), res)
    bg = np.array([0.15, 0.1, 0.05], np.float32)
    img_j, aux_j = jsharded(jg, jc, jnp.asarray(bg),
                            JCfg(backend="pallas", interpret=True, **caps),
                            make_mesh(world))
    img_t, aux_t = render_bands(tg, tc, bg, RasterizeConfig(**caps), world,
                                device="cpu")
    assert img_t.shape == (1, res, res, 3)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux_t.transmittance.numpy(),
                               np.asarray(aux_j.transmittance), atol=1e-5,
                               rtol=0)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(aux_t, f).numpy(),
                                      np.asarray(getattr(aux_j, f)), f)
    assert all((int(getattr(aux_t, f)[0]) > 0) == (world == 4)
               for f in COUNTERS)
    assert float((aux_t.transmittance < 0.5).float().mean()) > 0.01
    # one band alone is that band's rows of the whole
    h = band_height(res, world)
    img_b, _ = render_band(tg, tc, bg, RasterizeConfig(**caps), 1, world,
                           device="cpu")
    assert torch.equal(img_b, img_t[:, h:2 * h])


def test_bands_match_jax_sharded_4(rng):
    check_bands_match_jax(rng, 4)


@pytest.mark.parametrize("binning", ["uniform", "staircase"])
def test_bands_match_unsharded_render(rng, binning):
    """At caps that do not bind, the bands give `rasterize`'s image bit for
    bit. The lower half's depths are a few f32 steps apart and one Gaussian
    in the upper half lies 100 m away: quantized over the whole view's
    range those depths tie (and blend in row order), quantized over the
    lower band's own range, as the JAX package's bands do, they would not.
    Every band here quantizes as the whole view does."""
    res = 112
    arrays = _scene(rng, 300)
    low = arrays["xyz"][0, :, 1] > 0.05
    arrays["xyz"][0, low, 2] = np.float32(0.5) + np.float32(2.4e-7) * \
        rng.integers(0, 5, size=int(low.sum())).astype(np.float32)
    arrays["xyz"][0, low, :2] *= 0.3            # overlapping, in one band
    arrays["xyz"][0, low, 1] += 0.1
    arrays["xyz"][0, 0] = (0.0, -20.0, 98.0)      # 100 m away, top band
    arrays["scale"][0, 0] = 0.5
    tg, tc, _, _ = _both(arrays, _camera(res), res)
    bg = torch.tensor([0.15, 0.1, 0.05])
    cfg = RasterizeConfig(max_tiles_per_gaussian=16, max_per_tile=512)
    if binning == "staircase":
        cfg = RasterizeConfig(max_per_tile=512, ellipse_rects=True,
                              span_schedule=((16, 100), (8, 200)))
    img_1, aux_1 = rasterize(tg, tc, bg, cfg, device="cpu")
    for world in (2, 4):
        img_b, aux_b = render_bands(tg, tc, bg, cfg, world, device="cpu")
        assert torch.equal(img_b, img_1)
        assert torch.equal(aux_b.transmittance, aux_1.transmittance)
        for f in COUNTERS:
            assert int(getattr(aux_b, f)[0]) == int(getattr(aux_1, f)[0])


def test_group_render_equals_bands(rng, tmp_path):
    """Two gloo ranks, each rendering its band, all-gather the bands and
    sum the counters: every rank returns the band-by-band render's bits."""
    res = 112
    tg, tc, _, _ = _both(_scene(rng, 300), _camera(res), res)
    bg = torch.tensor([0.15, 0.1, 0.05])
    cfg = RasterizeConfig(max_tiles_per_gaussian=2, max_per_tile=512)
    ranks = spawn_ranks("rank_render", 2, dict(
        gauss=tg, camera=tc, bg=bg, cfg=cfg, device="cpu"), tmp_path)
    img_b, aux_b = render_bands(tg, tc, bg, cfg, 2, device="cpu")
    assert int(aux_b.num_dropped[0]) > 0
    for out in ranks:
        assert torch.equal(out["img"], img_b)
        assert torch.equal(out["trans"], aux_b.transmittance)
        assert out["counters"] == [int(getattr(aux_b, f)[0])
                                   for f in COUNTERS]
