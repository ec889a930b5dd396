"""Port ops, geometry and fixtures against the JAX package on the same numpy
inputs: correlation, sampling, point-cloud geometry, cameras and the fake
stereo batch. f32 throughout; tolerance atol 1e-5 (both sides compute in
f32 and differ only in summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gps_gaussian_tpu.geometry import cameras as jcam
from gps_gaussian_tpu.geometry import pointcloud as jpc
from gps_gaussian_tpu.ops import corr as jcorr
from gps_gaussian_tpu.ops import sampling as jsamp
from gps_gaussian_tpu.testing import fake_stereo_batch as jax_fake_batch

from gps_gaussian_tpu_torch import testing as ttesting
from gps_gaussian_tpu_torch.geometry import cameras as tcam
from gps_gaussian_tpu_torch.geometry import pointcloud as tpc
from gps_gaussian_tpu_torch.ops import corr as tcorr
from gps_gaussian_tpu_torch.ops import sampling as tsamp

from thread_budget import thread_budget  # noqa: F401

ATOL = 1e-5


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def test_corr_pyramid_and_lookup_match_jax(rng):
    f1 = rng.normal(size=(2, 4, 24, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 4, 24, 16)).astype(np.float32)
    pyr_j = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    pyr_t = tcorr.build_corr_pyramid(torch.tensor(f1), torch.tensor(f2), 4)
    assert [p.shape[-1] for p in pyr_t] == [24, 12, 6, 3]
    for pt, pj in zip(pyr_t, pyr_j):
        _close(pt, pj)
    # coordinates cover in-range, fractional, edge and far out-of-range taps
    coords = rng.uniform(-6.0, 30.0, size=(2, 4, 24)).astype(np.float32)
    coords[0, 0, :4] = [0.0, 23.0, -0.5, 23.5]
    _close(tcorr.lookup_corr_pyramid(pyr_t, torch.tensor(coords), 4),
           jcorr.lookup_corr_pyramid(pyr_j, jnp.asarray(coords), 4))


def test_corr_lookup_zero_outside_range():
    vol = torch.ones(1, 1, 1, 5)
    x = torch.tensor([[[[-1.0, -0.5, 0.0, 4.0, 4.5, 5.0, 9.0]]]])
    out = tcorr.sample_lastdim(vol, x)
    np.testing.assert_allclose(out.numpy()[0, 0, 0],
                               [0, 0.5, 1, 1, 0.5, 0, 0])


def test_sampling_ops_match_jax(rng):
    _close(tsamp.coords_grid(2, 5, 7), jsamp.coords_grid(2, 5, 7))
    x = rng.normal(size=(2, 3, 4, 9)).astype(np.float32)
    _close(tsamp.avg_pool_lastdim(torch.tensor(x)),
           jsamp.avg_pool_lastdim(jnp.asarray(x)))
    _close(tsamp.shift_patches_3x3(torch.tensor(x)),
           jsamp.shift_patches_3x3(jnp.asarray(x)))
    flow = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    logits = rng.normal(size=(2, 5, 6, 9 * 64)).astype(np.float32)
    # the output is 8 x flow, up to ~30, where one f32 ulp is ~2e-6 and
    # the two 9-term softmax mixes differ by a few ulps
    _close(tsamp.convex_upsample(torch.tensor(flow), torch.tensor(logits)),
           jsamp.convex_upsample(jnp.asarray(flow), jnp.asarray(logits)),
           atol=5e-5)


def test_pointcloud_matches_jax(rng):
    b, h, w = 2, 8, 10
    flow = rng.normal(0, 3, size=(b, h, w, 1)).astype(np.float32)
    mask = (rng.uniform(size=(b, h, w, 1)) > 0.3).astype(np.float32)
    intr = np.tile(np.array([[50, 0, 5], [0, 50, 4], [0, 0, 1]],
                            np.float32), (b, 1, 1))
    ref_intr = intr.copy()
    ref_intr[:, 0, 2] += 3.0
    tf_x = np.array([-40.0, 40.0], np.float32)
    inv_j = jpc.flow_to_inv_depth(*map(jnp.asarray, (flow, intr, ref_intr,
                                                     tf_x, mask)))
    inv_t = tpc.flow_to_inv_depth(*map(torch.tensor, (flow, intr, ref_intr,
                                                      tf_x, mask)))
    _close(inv_t, inv_j)
    q = rng.normal(size=(b, 4))
    extr = np.stack([np.concatenate(
        [jcam.quat_to_mat(qi / np.linalg.norm(qi)),
         rng.normal(size=(3, 1))], axis=1) for qi in q]).astype(np.float32)
    inv = rng.uniform(0.3, 0.6, size=(b, h, w)).astype(np.float32)
    _close(tpc.inv_depth_to_points(torch.tensor(inv), torch.tensor(extr),
                                   torch.tensor(intr)),
           jpc.inv_depth_to_points(jnp.asarray(inv), jnp.asarray(extr),
                                   jnp.asarray(intr)))


@pytest.mark.parametrize("ratio,hr", [(0.3, 1.0), (0.75, 2.0)])
def test_cameras_match_jax(rng, ratio, hr):
    K0 = np.array([[80, 0, 32], [0, 80, 33], [0, 0, 1]], np.float32)
    K1 = K0 + np.float32(1.5)
    E0 = np.concatenate([jcam.quat_to_mat([0.99, 0.1, 0.05, 0.0]
                                          / np.linalg.norm([0.99, 0.1, 0.05,
                                                            0.0])),
                         [[0.1], [0.0], [2.0]]], axis=1).astype(np.float32)
    E1 = np.concatenate([np.eye(3), [[-0.1], [0.05], [2.1]]],
                        axis=1).astype(np.float32)
    out_j = jcam.interpolated_novel_camera(K0, E0, K1, E1, ratio, 128, 96,
                                           hr_scale=hr)
    out_t = tcam.interpolated_novel_camera(K0, E0, K1, E1, ratio, 128, 96,
                                           hr_scale=hr)
    for k in out_j[0]:
        np.testing.assert_array_equal(out_t[0][k], out_j[0][k])
    np.testing.assert_array_equal(out_t[1], out_j[1])
    np.testing.assert_array_equal(out_t[2], out_j[2])
    cam_t = tcam.make_novel_camera([out_t[0]], 128, 96)
    cam_j = jcam.make_novel_camera([out_j[0]], 128, 96)
    assert (cam_t.height, cam_t.width) == (cam_j.height, cam_j.width)
    np.testing.assert_array_equal(cam_t.proj.numpy(), np.asarray(cam_j.proj))


def test_fake_stereo_batch_is_bit_identical():
    bj = jax_fake_batch(batch=2, res=16, seed=3)
    bt = ttesting.fake_stereo_batch(batch=2, res=16, seed=3)
    for view in ("lmain", "rmain"):
        for f in ("img", "mask", "intr", "ref_intr", "extr", "tf_x", "flow",
                  "valid"):
            np.testing.assert_array_equal(
                getattr(getattr(bt, view), f).numpy(),
                np.asarray(getattr(getattr(bj, view), f)))
    for f in ("view", "proj", "cam_center", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(getattr(bt.novel.camera, f).numpy(),
                                      np.asarray(getattr(bj.novel.camera, f)))
    np.testing.assert_array_equal(bt.novel.img.numpy(),
                                  np.asarray(bj.novel.img))
