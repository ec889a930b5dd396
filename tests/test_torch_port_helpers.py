"""The helpers the JAX package exports, held to it on the inputs of its own
tests: sampling (tests/test_ops.py), the inverse-depth round trip, the
stereo flow and the projection (tests/test_geometry.py), the rotation and
covariance functions, and the exact rasterizer oracle
(tests/test_rasterizer.py:154), forward and gradients. Then the tracing
hooks, which have no numbers to compare, and the threads a port test and
the ranks it spawns take.

Tolerances: f32 on both sides, apart only in the order of sums: atol 1e-5
for sampling, rtol 1e-6 for the geometry (elementwise on both sides, true
f32), atol 1e-6 for the rotation and covariance, atol 1e-5 for the oracle's
image and 1e-4 of each input's largest gradient (JAX's own binned-vs-oracle
check is 1e-4 and 2e-4).
"""

import os
import queue
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gps_gaussian_tpu.geometry import pointcloud as jpc
from gps_gaussian_tpu.kernels.rasterizer import \
    rasterize_reference_single as jref_single
from gps_gaussian_tpu.kernels.rasterizer import preprocess as jpre
from gps_gaussian_tpu.ops import sampling as jsamp

from gps_gaussian_tpu_torch import testing
from gps_gaussian_tpu_torch.geometry import pointcloud as tpc
from gps_gaussian_tpu_torch.kernels.rasterizer import (
    RasterizeConfig, rasterize_reference_single, rasterize_single)
from gps_gaussian_tpu_torch.kernels.rasterizer import preprocess as tpre
from gps_gaussian_tpu_torch.ops import sampling as tsamp
from gps_gaussian_tpu_torch.utils import profiling

from test_geometry import _random_cam
from test_rasterizer import RES, _camera, _scene
from thread_budget import thread_budget  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(ours, ref, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def test_bilinear_sample_matches_jax_and_grid_sample(rng):
    b, h, w, c = 2, 13, 17, 3
    img = rng.normal(size=(b, h, w, c)).astype(np.float32)
    coords = rng.uniform(-2, max(h, w) + 1,
                         size=(b, 9, 11, 2)).astype(np.float32)
    ours = tsamp.bilinear_sample(_t(img), _t(coords))
    assert ours.shape == (b, 9, 11, c)
    _close(ours, jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    grid = torch.cat([2 * _t(coords[..., :1]) / (w - 1) - 1,
                      2 * _t(coords[..., 1:]) / (h - 1) - 1], dim=-1)
    ref = F.grid_sample(_t(img).permute(0, 3, 1, 2), grid,
                        align_corners=True).permute(0, 2, 3, 1)
    _close(ours, ref.numpy())


@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_bilinear_matches_jax(rng, align_corners):
    img = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ours = tsamp.interpolate_bilinear(_t(img), 16, 12, align_corners)
    _close(ours, jsamp.interpolate_bilinear(jnp.asarray(img), 16, 12,
                                            align_corners))
    if align_corners:
        ref = F.interpolate(_t(img).permute(0, 3, 1, 2), size=(16, 12),
                            mode="bilinear", align_corners=True)
        _close(ours, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (4, 4, 0),
                                                   (2, 1, 1)])
def test_avg_pool_2d_matches_jax(rng, window, stride, padding):
    x = rng.normal(size=(2, 10, 10, 5)).astype(np.float32)
    _close(tsamp.avg_pool_2d(_t(x), window, stride, padding),
           jsamp.avg_pool_2d(jnp.asarray(x), window, stride, padding))


def test_inv_depth_round_trip_matches_jax(rng):
    K, E = _random_cam(rng, res=32)
    intr = np.stack([K, K]).astype(np.float32)
    extr = np.stack([E, E]).astype(np.float32)
    inv_depth = (1.0 / rng.uniform(1.5, 2.5, size=(2, 32, 32))
                 ).astype(np.float32)
    pts = tpc.inv_depth_to_points(_t(inv_depth), _t(extr), _t(intr))
    back = tpc.points_to_inv_depth(pts, _t(extr), _t(intr))
    np.testing.assert_allclose(back.numpy(), inv_depth, rtol=1e-4)
    ref = jpc.points_to_inv_depth(jnp.asarray(pts.numpy()),
                                  jnp.asarray(extr), jnp.asarray(intr))
    _close(back, ref, atol=0, rtol=1e-6)


def test_stereo_flow_matches_jax(rng):
    res, b = 16, 2
    intr = np.tile(np.array([[100.0, 0, 7.5], [0, 100.0, 8.5], [0, 0, 1]],
                            np.float32), (b, 1, 1))
    ref_intr = intr.copy()
    ref_intr[:, 0, 2] += 3.0
    tf_x = np.full((b,), -40.0, np.float32)
    inv_depth = (1.0 / rng.uniform(1.5, 2.5, (b, res, res, 1))
                 ).astype(np.float32)
    flow = tpc.stereo_flow_from_inv_depth(_t(inv_depth), _t(intr),
                                          _t(ref_intr), _t(tf_x))
    _close(flow, jpc.stereo_flow_from_inv_depth(
        jnp.asarray(inv_depth), jnp.asarray(intr), jnp.asarray(ref_intr),
        jnp.asarray(tf_x)), atol=0, rtol=1e-6)
    back = tpc.flow_to_inv_depth(flow, _t(intr), _t(ref_intr), _t(tf_x),
                                 torch.ones((b, res, res, 1)))
    np.testing.assert_allclose(back.numpy(), inv_depth, rtol=1e-5)


def test_perspective_project_matches_jax(rng):
    K, E = _random_cam(rng, 64)
    pts = (rng.normal(scale=0.3, size=(1, 10, 3))
           + np.array([0, 0.85, 0])).astype(np.float32)
    calib = (K @ E)[None].astype(np.float32)
    out = tpc.perspective_project(_t(pts), _t(calib))
    _close(out, jpc.perspective_project(jnp.asarray(pts),
                                        jnp.asarray(calib)),
           atol=0, rtol=1e-6)
    cam_pts = E[:3, :3] @ pts[0].T.astype(np.float64) + E[:3, 3:]
    uv = K @ cam_pts
    np.testing.assert_allclose(out[0, :, 0].numpy(), uv[0] / uv[2],
                               rtol=1e-4)
    np.testing.assert_allclose(out[0, :, 2].numpy(), cam_pts[2], rtol=1e-4)


def test_quat_to_rotmat_and_cov3d_match_jax(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(0.005, 0.5, size=(50, 3)).astype(np.float32)
    R = tpre.quat_to_rotmat(_t(q))
    _close(R, jpre.quat_to_rotmat(jnp.asarray(q)), atol=1e-6)
    eye = R @ R.transpose(-1, -2)
    _close(eye, np.broadcast_to(np.eye(3), (50, 3, 3)), atol=1e-5)
    # a leading batch axis, as JAX allows
    _close(tpre.quat_to_rotmat(_t(q.reshape(5, 10, 4))),
           jpre.quat_to_rotmat(jnp.asarray(q.reshape(5, 10, 4))), atol=1e-6)
    cov = tpre.build_cov3d(_t(q), _t(s))
    _close(cov, jpre.build_cov3d(jnp.asarray(q), jnp.asarray(s)), atol=1e-6)
    # the covariance the projection uses is the same one
    for i, (r, c) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                (2, 2))):
        assert torch.equal(tpre.build_cov3d_rows(_t(q), _t(s))[i],
                           cov[:, r, c])


def _oracle_args(rng, n, **kw):
    cam = _camera()
    xyz, q, scale, opacity, color, valid = _scene(rng, n=n, **kw)
    bg = np.array([0.2, 0.2, 0.2], np.float32)
    arrays = (xyz, q, scale, opacity, color, valid)
    statics = (cam["view"], cam["proj"], cam["tanfovx"], cam["tanfovy"],
               RES, RES, bg)
    return arrays, statics


def test_rasterize_reference_single_matches_jax(rng):
    """Forward on test_rasterizer.py:154's scene: the port's oracle against
    JAX's, and the port's binned render (plain versions on the CPU)
    against the port's oracle at JAX's 1e-4."""
    arrays, (view, proj, tfx, tfy, h, w, bg) = _oracle_args(rng, 300)
    targs = [_t(a) for a in arrays] + [_t(view), _t(proj), tfx, tfy, h, w,
                                       _t(bg)]
    jargs = [jnp.asarray(a) for a in arrays] + [
        jnp.asarray(view), jnp.asarray(proj), tfx, tfy, h, w,
        jnp.asarray(bg)]
    ours = rasterize_reference_single(*targs)
    assert ours.shape == (RES, RES, 3)
    _close(ours, jref_single(*jargs))
    img, aux = rasterize_single(
        *targs, RasterizeConfig(max_tiles_per_gaussian=16, max_per_tile=512),
        device="cpu")
    assert int(aux.num_dropped) == 0
    _close(img, ours.numpy(), atol=1e-4)


def test_rasterize_reference_single_gradients_match_jax(rng):
    arrays, statics = _oracle_args(rng, 120, opacity_max=0.9)
    view, proj, tfx, tfy, h, w, bg = statics
    weight = rng.normal(size=(RES, RES, 3)).astype(np.float32)

    leaves = [_t(a).requires_grad_(True) for a in arrays[:5]]
    (rasterize_reference_single(
        *leaves, _t(arrays[5]), _t(view), _t(proj), tfx, tfy, h, w, _t(bg))
     * _t(weight)).sum().backward()

    def loss(*x):
        return jnp.sum(jref_single(*x, jnp.asarray(arrays[5]),
                                   jnp.asarray(view), jnp.asarray(proj),
                                   tfx, tfy, h, w, jnp.asarray(bg))
                       * jnp.asarray(weight))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in arrays[:5]])
    for leaf, gr, name in zip(leaves, ref, ("xyz", "rot", "scale",
                                            "opacity", "color")):
        top = float(np.abs(np.asarray(gr)).max()) + 1e-8
        np.testing.assert_allclose(leaf.grad.numpy() / top,
                                   np.asarray(gr) / top, atol=1e-4,
                                   err_msg=name)


def test_maybe_trace_and_annotate(tmp_path):
    """maybe_trace(None) is a no-op; with a directory it writes a Chrome
    trace of the block, where a program span shows by name."""
    with profiling.maybe_trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiling.maybe_trace(str(tmp_path / "t"), "step.json"):
        with profiling.span("gps_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    text = (tmp_path / "t" / "step.json").read_text()
    assert "gps_region" in text


def test_torch_runs_on_the_worker_share_of_the_cores(thread_budget):
    """Under pytest-xdist a port test module runs torch on its worker's
    share of the cores, and a subprocess it starts inherits the share."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    assert thread_budget == share == torch.get_num_threads()
    assert os.environ["OMP_NUM_THREADS"] == str(share)
    assert os.environ["MKL_NUM_THREADS"] == str(share)
    child = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120, check=True)
    assert int(child.stdout) == share


@pytest.mark.parametrize("omp", ["2", None])
def test_spawned_cpu_rank_takes_its_share_of_the_threads(omp, monkeypatch):
    """A CPU rank sets torch's threads before it joins its group: the
    OMP_NUM_THREADS it inherits, or the host's cores where that is unset,
    divided by the world size."""
    def stop(*args, **kwargs):
        raise RuntimeError("stopped before the group")

    monkeypatch.setattr(testing.dist, "init_process_group", stop)
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    threads, out_q = torch.get_num_threads(), queue.Queue()
    try:
        testing._rank_entry("rank_eval", 1, 2, "file:///unused", {}, out_q)
        assert torch.get_num_threads() == max(
            1, int(omp or os.cpu_count()) // 2)
    finally:
        torch.set_num_threads(threads)
    rank, ok, out = out_q.get_nowait()
    assert (rank, ok) == (1, False) and "stopped before the group" in out
