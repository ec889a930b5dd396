"""What the port's composite kernels are designed from, tested on the CPU:

(a) the lockstep counters of the plain versions (`return_work` with
    `warp_shapes`) against a brute-force numpy walk, tile by tile and pair
    by pair, for both pixel-to-lane mappings (16x2 strips, 8x4 blocks);
(b) the conservative row cull (`cull_rows_plain`, the plain version of
    `cull_rows` in csrc/composite_common.cuh): on seeded pairs of every
    kind it never culls a row in which some pixel passes the include test,
    and it does cull most rows in which none does.

All counts are integers and must agree exactly. The brute force computes in
float32 with numpy and takes exp from torch, so that both sides see the
same bits at the include and T_EPS decisions.
"""

import numpy as np
import pytest
import torch

from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
    composite_bwd_plain, composite_fwd_plain, cull_rows_plain)

from thread_budget import thread_budget  # noqa: F401

ALPHA_MIN, ALPHA_MAX, T_EPS = 1.0 / 255.0, 0.99, 1e-4
SHAPES = [(16, 2), (8, 4)]


def _scene(seed, tiles_y, tiles_x, batch):
    """Seeded sorted pair segments: empty tiles, long tiles, opaque enough
    that many pixels end early, splats from a pixel to a tile wide."""
    rng = np.random.default_rng(seed)
    n_tiles = batch * tiles_y * tiles_x
    count = rng.integers(0, 150, n_tiles)
    count[::4] = 0
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    P = int(count.sum())
    tile_of = np.repeat(np.arange(n_tiles), count) % (tiles_y * tiles_x)
    cx = (tile_of % tiles_x) * 16 + rng.uniform(-6, 22, P)
    cy = (tile_of // tiles_x) * 16 + rng.uniform(-6, 22, P)
    ca = 10 ** rng.uniform(-2.5, 0.3, P)
    cc = 10 ** rng.uniform(-2.5, 0.3, P)
    cb = rng.uniform(-0.9, 0.9, P) * np.sqrt(ca * cc)
    op = rng.uniform(0.02, 1.2, P)
    rgb = rng.uniform(0, 1, (3, P))
    props = np.stack([cx, cy, ca, cb, cc, op, *rgb]).astype(np.float32)
    return props, start.astype(np.int32), count.astype(np.int32)


def _exp(x):
    return torch.exp(torch.from_numpy(x)).numpy()


def _brute_force(props, start, count, tiles_y, tiles_x, shapes):
    """Walk every tile pair by pair; count evaluations needed, blended,
    pairs reached, and per mapping the (group, pair) combinations with a
    live, an included and a blending pixel."""
    f = np.float32
    idx = np.arange(256)
    total = dict(walked=0, blended=0, tile_walked=0)
    per_shape = {s: dict(walked=0, included=0, blended=0) for s in shapes}
    for t in range(len(start)):
        local = t % (tiles_y * tiles_x)
        px = ((local % tiles_x) * 16 + idx % 16).astype(f)
        py = ((local // tiles_x) * 16 + idx // 16).astype(f)
        T = np.ones(256, f)
        done = np.zeros(256, bool)
        for j in range(start[t], start[t] + count[t]):
            mx, my, ca, cb, cc, op = (props[k, j] for k in range(6))
            live = ~done
            dx, dy = px - mx, py - my
            power = f(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = np.minimum(op * _exp(power), f(ALPHA_MAX))
            include = live & (power <= 0) & (alpha >= f(ALPHA_MIN))
            test_T = T * (f(1.0) - alpha)
            viol = include & (test_T < f(T_EPS))
            blend = include & ~viol
            T = np.where(blend, test_T, T)
            total["walked"] += int(live.sum())
            total["blended"] += int(blend.sum())
            total["tile_walked"] += int(live.any())
            for (w, h) in shapes:
                for name, m in (("walked", live), ("included", include),
                                ("blended", blend)):
                    groups = m.reshape(16 // h, h, 16 // w, w)
                    per_shape[(w, h)][name] += int(
                        groups.any(axis=(1, 3)).sum())
            done |= viol
    return total, per_shape


@pytest.mark.parametrize("shape", SHAPES, ids=["16x2", "8x4"])
def test_lockstep_counters_match_brute_force(shape):
    ty, tx, batch = 2, 3, 2
    props, start, count = _scene(7, ty, tx, batch)
    total, per_shape = _brute_force(props, start, count, ty, tx, [shape])
    assert 0 < total["blended"] < total["walked"]

    tp, ts, tc = (torch.tensor(props), torch.tensor(start),
                  torch.tensor(count))
    out, work, lock = composite_fwd_plain(tp, ts, tc, ty, tx,
                                          return_work=True,
                                          warp_shapes=[shape])
    assert int(work) == total["walked"]
    assert lock["tile_walked"] == total["tile_walked"]
    assert lock["warps"] == {shape: per_shape[shape]}
    # lockstep can only cost: a warp spends at least what its pixels need,
    # a block at least what its warps spend
    w, h = shape
    spent = w * h * lock["warps"][shape]["walked"]
    assert total["walked"] <= spent <= 256 * lock["tile_walked"]
    assert lock["warps"][shape]["blended"] \
        <= lock["warps"][shape]["included"] <= lock["warps"][shape]["walked"]

    rng = np.random.default_rng(8)
    g_out = torch.tensor(rng.normal(size=tuple(out.shape)),
                         dtype=torch.float32)
    _, walked, blended, reached, lock_b = composite_bwd_plain(
        tp, ts, tc, out, g_out, ty, tx, return_work=True,
        warp_shapes=[shape])
    assert (int(walked), int(blended), int(reached)) == (
        total["walked"], total["blended"], total["tile_walked"])
    assert lock_b == lock


def test_return_work_without_warp_shapes_keeps_its_form():
    ty, tx = 1, 2
    props, start, count = _scene(3, ty, tx, 1)
    tp, ts, tc = (torch.tensor(props), torch.tensor(start),
                  torch.tensor(count))
    out, work = composite_fwd_plain(tp, ts, tc, ty, tx, return_work=True)
    assert len(composite_bwd_plain(tp, ts, tc, out, out, ty, tx,
                                   return_work=True)) == 4
    assert torch.equal(out, composite_fwd_plain(tp, ts, tc, ty, tx))
    with pytest.raises(ValueError, match="warp shape"):
        composite_fwd_plain(tp, ts, tc, ty, tx, return_work=True,
                            warp_shapes=[(5, 4)])


def _included_rows(props, tile_x, tile_y, shape):
    """(P, rows) bool: some pixel of the row passes the include test, by
    the plain versions' arithmetic."""
    w, h = shape
    idx = torch.arange(256)
    px = (tile_x + idx % 16).to(torch.float32)[None]
    py = (tile_y + idx // 16).to(torch.float32)[None]
    p = props[:, :, None]
    dx, dy = px - p[0], py - p[1]
    power = -0.5 * (p[2] * dx * dx + p[4] * dy * dy) - p[3] * dx * dy
    alpha = torch.clamp_max(p[5] * torch.exp(power), ALPHA_MAX)
    include = (power <= 0.0) & (alpha >= ALPHA_MIN)
    n = props.shape[1]
    return include.view(n, 16 // h, h, 16 // w, w).any(dim=4).any(dim=2) \
        .reshape(n, -1)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x2", "8x4"])
def test_row_cull_never_drops_an_included_pixel(shape):
    rng = np.random.default_rng(11)
    P = 30000
    tile_x, tile_y = 2032, 1008   # far from the origin: large coordinates
    cx = tile_x + rng.uniform(-60, 76, P)
    cy = tile_y + rng.uniform(-60, 76, P)
    ca = 10 ** rng.uniform(-4, 1.5, P)
    cc = 10 ** rng.uniform(-4, 1.5, P)
    # from round to needles beyond the cull's 1e-3 determinant guard
    cb = rng.choice([-1, 1], P) * (1 - 10 ** rng.uniform(-5, 0, P)) \
        * np.sqrt(ca * cc)
    op = 10 ** rng.uniform(-3.5, 0.5, P)
    props = np.stack([cx, cy, ca, cb, cc, op]).astype(np.float32)
    # the edges: opacity at the include threshold, centres on pixel
    # corners, an indefinite form, a zero and a negative conic entry
    props[5, :50] = np.float32(1.0 / 255.0)
    props[0, 50:100] = tile_x + rng.integers(-1, 17, 50)
    props[1, 50:100] = tile_y + rng.integers(-1, 17, 50)
    props[3, 100:150] = 2.0 * np.sqrt(props[2, 100:150] * props[4, 100:150])
    props[2, 150:175] = 0.0
    props[4, 175:200] = -props[4, 175:200]
    props = torch.tensor(props)

    cull = cull_rows_plain(props, tile_x, tile_y, shape)
    included = _included_rows(props, tile_x, tile_y, shape)
    assert cull.shape == included.shape == (P, 8)
    assert int((cull & included).sum()) == 0
    # and it is worth having: among the pairs past its determinant guard it
    # finds nearly every row that no pixel can touch
    ca, cb, cc = props[2], props[3], props[4]
    guarded = (ca > 0) & (cc > 0) & (ca * cc - cb * cb >= 1e-3 * ca * cc)
    assert int(cull[guarded].sum()) \
        >= 0.99 * int((~included)[guarded].sum()) > 0
    # what must cull nothing does: indefinite, zero or negative conics
    # (whose opacity can reach 1/255 at all)
    odd = torch.zeros(P, dtype=torch.bool)
    odd[100:200] = True
    assert not cull[odd & (props[5] > ALPHA_MIN)].any()
    # an opacity that cannot reach 1/255 is culled everywhere
    dim = props[5] < 0.9 / 255.0
    assert dim.any() and cull[dim].all()
