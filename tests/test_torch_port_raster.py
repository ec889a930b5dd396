"""Port rasterizer against the JAX package's Pallas route (interpret mode).

(c) the port's plain composite (the CUDA kernel's CPU counterpart) against
    JAX `_composite_core` on the same sorted pairs, rgb and T at atol 1e-5;
(d) the port's `rasterize` against JAX `rasterize(backend="pallas",
    interpret=True)`, images at atol 1e-5 and every drop counter exactly,
    also when max_tiles_per_gaussian, max_per_tile, pair_budget and fg_cap
    bind; plus projection, the packed sort key and the exact oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.kernels.rasterizer import RasterizeConfig as JCfg
from gps_gaussian_tpu.kernels.rasterizer import rasterize as jrasterize
from gps_gaussian_tpu.kernels.rasterizer.pallas_kernel import (
    CHUNK, DCH, PROPW, _composite_core, pack_sort_key as jpack)
from gps_gaussian_tpu.kernels.rasterizer.preprocess import \
    project_gaussians as jproject
from gps_gaussian_tpu.kernels.rasterizer.reference import \
    composite_reference as jreference
from gps_gaussian_tpu.utils.containers import FlatGaussians as JFlat
from gps_gaussian_tpu.utils.containers import NovelCamera as JCam

from gps_gaussian_tpu_torch.kernels.rasterizer import (RasterizeConfig,
                                                       rasterize)
from gps_gaussian_tpu_torch.kernels.rasterizer.composite import \
    composite_fwd
from gps_gaussian_tpu_torch.kernels.rasterizer.pair_sort import pack_sort_key
from gps_gaussian_tpu_torch.kernels.rasterizer.preprocess import \
    project_gaussians
from gps_gaussian_tpu_torch.kernels.rasterizer.reference import \
    composite_reference
from gps_gaussian_tpu_torch.utils.containers import (FlatGaussians,
                                                     NovelCamera)

from thread_budget import thread_budget  # noqa: F401

RES = 48  # 3 x 3 tiles


def _sorted_pairs(rng, tiles_y, tiles_x, batch=1):
    """Random depth-ordered pair segments: some tiles empty, some short,
    some spanning several 128-pair chunks, opaque enough that many pixels
    end at T_EPS."""
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
    op = rng.uniform(0.05, 0.99, P)
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


@pytest.mark.parametrize("batch", [1, 2])
def test_plain_composite_matches_jax_composite_core(rng, batch):
    ty, tx = 3, 4
    props, start, count = _sorted_pairs(rng, ty, tx, batch)
    ref = np.asarray(_composite_core(
        jnp.asarray(_jax_layout(props)), jnp.asarray(start),
        jnp.asarray(count), batch, ty, tx, True))
    ours = composite_fwd(torch.tensor(props), torch.tensor(start),
                         torch.tensor(count), ty, tx).numpy()
    assert ours.shape == ref.shape == (batch * ty * tx, 256, 4)
    done = ours[..., 3] < 1e-3
    assert done.mean() > 0.05, "the scene must exercise T_EPS termination"
    # JAX composes T in a 128-pair chunk by a Hillis-Steele cumprod, the
    # port multiplies sequentially: the two agree to about 1 ulp, so a
    # pixel whose T lands on T_EPS itself could end one pair apart. Such
    # flipped pixels are counted (none occur on this data), the rest must
    # agree at 1e-5.
    bad = np.abs(ours - ref).max(-1) > 1e-5
    flipped = bad & (np.abs(np.minimum(ours[..., 3], ref[..., 3]) * 1e4 - 1)
                     < 1.0)
    assert int(flipped.sum()) == int(bad.sum()) == 0


def _scene(rng, n, batch):
    xyz = rng.normal(scale=0.3, size=(batch, n, 3)).astype(np.float32)
    q = rng.normal(size=(batch, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scale = rng.uniform(0.005, 0.06, (batch, n, 3)).astype(np.float32)
    opacity = rng.uniform(0.1, 0.95, (batch, n, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (batch, n, 3)).astype(np.float32)
    # validity row by row: where fg_cap binds, both packages keep the same
    # groups of 8 rows and count the same dropped valid rows
    valid = (rng.uniform(size=(batch, n)) > 0.3).astype(np.float32)
    cams = []
    for b in range(batch):
        K = np.array([[0.8 * RES, 0, RES / 2 + 2 * b],
                      [0, 0.8 * RES, RES / 2], [0, 0, 1]], np.float32)
        E = np.eye(3, 4, dtype=np.float32)
        E[0, 3] = 0.05 * b
        E[2, 3] = 2.0
        cams.append(jcam.camera_from_intr_extr(K, E, RES, RES))
    cam = {k: np.stack([c[k] for c in cams]) for k in cams[0]}
    return (xyz, rgb, q, scale, opacity, valid), cam


CAPS = {
    "none": dict(max_tiles_per_gaussian=16, max_per_tile=512),
    "dup": dict(max_tiles_per_gaussian=2, max_per_tile=512),
    "per_tile": dict(max_tiles_per_gaussian=16, max_per_tile=12),
    "budget": dict(max_tiles_per_gaussian=16, max_per_tile=512,
                   pair_budget=300),
    "fg": dict(max_tiles_per_gaussian=16, max_per_tile=512, fg_cap=160),
    "all": dict(max_tiles_per_gaussian=4, max_per_tile=24, pair_budget=500,
                fg_cap=200),
}


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_rasterize_matches_jax_pallas(rng, caps):
    batch, n = 2, 320
    (xyz, rgb, q, scale, opacity, valid), cam = _scene(rng, n, batch)
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    names = ("xyz", "rgb", "rot", "scale", "opacity", "valid")
    arrays = (xyz, rgb, q, scale, opacity, valid)

    jg = JFlat(**{k: jnp.asarray(v) for k, v in zip(names, arrays)})
    jc = JCam(**{k: jnp.asarray(v) for k, v in cam.items()}, height=RES,
              width=RES)
    img_j, aux_j = jrasterize(jg, jc, jnp.asarray(bg), JCfg(
        backend="pallas", interpret=True, **CAPS[caps]))

    tg = FlatGaussians(**{k: torch.tensor(v) for k, v in zip(names, arrays)})
    tc = NovelCamera(**{k: torch.tensor(v) for k, v in cam.items()},
                     height=RES, width=RES)
    img_t, aux_t = rasterize(tg, tc, bg, RasterizeConfig(**CAPS[caps]),
                             device="cpu")

    for f in ("num_dropped", "num_fg_dropped", "num_pair_dropped"):
        np.testing.assert_array_equal(getattr(aux_t, f).numpy(),
                                      np.asarray(getattr(aux_j, f)), f)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux_t.transmittance.numpy(),
                               np.asarray(aux_j.transmittance), atol=1e-5,
                               rtol=0)
    if caps == "none":
        assert not any(int(getattr(aux_t, f).sum()) for f in
                       ("num_dropped", "num_fg_dropped", "num_pair_dropped"))
    elif caps != "all":
        key = {"dup": "num_dropped", "fg": "num_fg_dropped"}.get(
            caps, "num_pair_dropped")
        assert int(getattr(aux_t, key).sum()) > 0, f"{caps} cap must bind"


def test_projection_and_oracle_match_jax(rng):
    (xyz, rgb, q, scale, opacity, valid), cam = _scene(rng, 160, 1)
    args = [xyz[0], q[0], scale[0], opacity[0], rgb[0], valid[0],
            cam["view"][0], cam["proj"][0]]
    pj = jproject(*map(jnp.asarray, args), cam["tanfovx"][0],
                  cam["tanfovy"][0], RES, RES)
    pt = project_gaussians(*map(torch.tensor, args),
                           float(cam["tanfovx"][0]),
                           float(cam["tanfovy"][0]), RES, RES)
    for f in pj._fields:
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), atol=1e-5,
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    np.testing.assert_allclose(
        composite_reference(pt, torch.tensor(bg), RES, RES).numpy(),
        np.asarray(jreference(pj, jnp.asarray(bg), RES, RES)), atol=1e-5)


def test_pack_sort_key_matches_jax(rng):
    total = 2 * 16384
    tile = rng.integers(0, total + 1, 5000).astype(np.int32)
    depth = rng.uniform(0.5, 4.0, 5000).astype(np.float32)
    depth[tile == total] = np.nan   # dead pairs may carry garbage depth
    kj, qj = jpack(jnp.asarray(tile), jnp.asarray(depth), total)
    kt, qt = pack_sort_key(torch.tensor(tile), torch.tensor(depth), total)
    assert qt == qj == 15
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    with pytest.raises(ValueError, match="depth bits"):
        pack_sort_key(torch.tensor(tile), torch.tensor(depth), 1 << 20)


def test_compaction_matches_jax_when_fg_cap_binds(rng):
    """Compaction with a binding fg_cap and a validity mask that is not in
    runs of 8 rows: `compact_gaussian_inputs` (N not a multiple of 8) and
    `compact_valid` keep JAX's rows in JAX's slots, bit for bit, dead rows
    of kept groups included, and count the same dropped valid rows; both
    raise where JAX raises."""
    from gps_gaussian_tpu.infer.freeview import compact_valid as jvalid
    from gps_gaussian_tpu.kernels.rasterizer import \
        compact_gaussian_inputs as jcompact

    from gps_gaussian_tpu_torch.infer.freeview import compact_valid
    from gps_gaussian_tpu_torch.kernels.rasterizer import \
        compact_gaussian_inputs

    names = ("xyz", "rgb", "rot", "scale", "opacity", "valid")
    for n, cap in ((1004, 480), (1000, 400)):
        (xyz, rgb, q, scale, opacity, valid), _ = _scene(rng, n, 1)
        valid[0, ::3] = 0.0          # no group of 8 rows is wholly valid
        arrays = dict(zip(names, (xyz, rgb, q, scale, opacity, valid)))
        tg = FlatGaussians(**{k: torch.tensor(v) for k, v in arrays.items()})
        ours, n_t = compact_gaussian_inputs(tg, 0, cap)
        ref, n_j = jcompact(*(jnp.asarray(arrays[k][0]) for k in
                              ("xyz", "rot", "scale", "opacity", "rgb",
                               "valid")), cap)
        assert int(n_t) == int(n_j) > 0
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the old row-exact compaction kept the first `cap` valid rows
        assert int(n_t) > int(valid.sum()) - cap
        if n % 8 == 0:
            gt, n_t = compact_valid(tg, cap)
            gj, n_j = jvalid(JFlat(**{k: jnp.asarray(v)
                                      for k, v in arrays.items()}), cap)
            assert int(n_t) == int(n_j) > 0
            for k in names:
                np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                              np.asarray(getattr(gj, k)), k)
    with pytest.raises(ValueError, match="multiple of 8"):
        compact_gaussian_inputs(tg, 0, 404)
    with pytest.raises(ValueError, match="multiples of 8"):
        compact_valid(tg, 404)
