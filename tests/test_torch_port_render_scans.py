"""Scan rendering in the port against the JAX package, on the CPU.

The meshes are the lat-long spheres of tests/test_native.py and the
textured humanoid of `testing.humanoid_mesh`, built in code. Both packages
build their copy of mesh_raster.cpp with the same flags on this host, so
the native mesh rasterizer is held bit-equal; the numpy fallbacks exactly
equal; the port's native path against its own fallback at the JAX test's
limits (mask pixels 2%, inverse z 1e-3 relative, rgb 0.02). `read_obj`,
`normalize_scan` and `scan_yaw_degrees` are equal to JAX's;
`render_dataset` writes a tree byte-equal to JAX's, which the port's
`StereoHumanDataset` reads into JAX's samples bit for bit, from the files
and through the v2 cache.
"""

import pickle
import shutil

import numpy as np
import pytest

from gps_gaussian_tpu import native as jnative
from gps_gaussian_tpu.data import render_scans as jrender
from gps_gaussian_tpu.data.thuman import DatasetConfig as JDatasetConfig
from gps_gaussian_tpu.data.thuman import StereoHumanDataset as JDataset

from gps_gaussian_tpu_torch import native
from gps_gaussian_tpu_torch.data import render_scans
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.testing import humanoid_mesh, write_scan

from test_native import _camera, _icosphere
from test_torch_port_data import assert_same
from thread_budget import thread_budget  # noqa: F401


def _textured(n=8, r=0.4, center=(0, 0, 0), seed=0):
    """A sphere with per-vertex uv (longitude, latitude) and a seeded
    16 x 16 texture."""
    verts, faces = _icosphere(r=r, center=center, n=n)
    d = (verts - np.asarray(center, np.float32)) / r
    uv = np.stack([np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi],
                  axis=1).astype(np.float32)
    tex = np.random.default_rng(seed).uniform(
        size=(16, 16, 3)).astype(np.float32)
    return verts, faces, uv, tex


@pytest.mark.parametrize("textured", [False, True])
def test_mesh_raster_native_bit_equal_to_jax(textured):
    assert native.available() and jnative.available()
    res = 64
    K, E = _camera(res)
    verts, faces, uv, tex = _textured()
    color = np.random.default_rng(1).uniform(
        size=(len(verts), 3)).astype(np.float32)
    kw = dict(uv=uv, tex=tex) if textured else {}
    ours = native.rasterize_mesh(verts, faces, color, K, E, res, res, **kw)
    assert_same(jnative.rasterize_mesh(verts, faces, color, K, E, res, res,
                                       **kw), ours)
    lights = np.array([[0.0, 0.0, -1.0, 0.9, 0.9, 0.9]], np.float32)
    assert_same(jnative.rasterize_mesh(verts, faces, color, K, E, res, res,
                                       lights=lights, ambient=0.1, **kw),
                native.rasterize_mesh(verts, faces, color, K, E, res, res,
                                      lights=lights, ambient=0.1, **kw))
    # inverse z: the centre ray meets the sphere's front at z = 2 - 0.4
    rgb, invz, mask, _ = ours
    assert mask[res // 2, res // 2] == 255 and mask[2, 2] == 0
    np.testing.assert_allclose(1.0 / invz[res // 2, res // 2], 1.6,
                               atol=0.02)


def test_mesh_raster_fallback_equals_jax(monkeypatch):
    res = 48
    K, E = _camera(res)
    verts, faces = _icosphere(n=6)
    color = np.tile(np.array([[0.8, 0.5, 0.2]], np.float32),
                    (len(verts), 1))
    ref = jnative._rasterize_mesh_numpy(verts, faces, color, K, E, res, res,
                                        None, None, None, 0.25)
    assert_same(ref, native._rasterize_mesh_numpy(
        verts, faces, color, K, E, res, res, None, None, None, 0.25))
    # without a toolchain rasterize_mesh takes the fallback
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    assert_same(ref, native.rasterize_mesh(verts, faces, color, K, E, res,
                                           res))
    monkeypatch.undo()

    rgb_n, invz_n, mask_n, _ = native.rasterize_mesh(verts, faces, color,
                                                     K, E, res, res)
    rgb_p, invz_p, mask_p, _ = ref
    assert (mask_n != mask_p).mean() < 0.02      # edge pixels may differ
    both = (mask_n > 0) & (mask_p > 0)
    np.testing.assert_allclose(invz_n[both], invz_p[both], rtol=1e-3)
    np.testing.assert_allclose(rgb_n[both], rgb_p[both], atol=0.02)


def test_read_obj_equals_jax(tmp_path):
    """vt, quads (fan-triangulated), negative indices, faces with and
    without texture indices, comments and blank lines."""
    path = tmp_path / "m.obj"
    path.write_text(
        "# a test mesh\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvt 0.5 0.5\n"
        "f 1/1 2/2 3/3 4/4\n"
        "f -5/-5 -4/-4 -1/-1\n"
        "f 2//1 3//2 5//3\n"
        "f 4 1 5\n")
    ours = render_scans.read_obj(path)
    ref = jrender.read_obj(path)
    assert len(ours[1]) == 5
    assert_same(ref, ours)
    plain = tmp_path / "plain.obj"
    plain.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    ours = render_scans.read_obj(plain)
    assert ours[2] is None
    assert_same(jrender.read_obj(plain)[:2], ours[:2])


def test_normalize_scan_and_yaw_equal_jax(tmp_path):
    rng0 = np.random.default_rng(0)
    verts = rng0.normal(size=(500, 3)).astype(np.float32)
    for seed in range(20):
        assert_same(jrender.normalize_scan(verts,
                                           np.random.default_rng(seed)),
                    render_scans.normalize_scan(verts,
                                                np.random.default_rng(seed)))
    assert_same(jrender.normalize_scan(verts),
                render_scans.normalize_scan(verts))

    wide = np.stack([np.linspace(-0.4, 0.4, 200), np.linspace(0, 1.8, 200),
                     0.02 * rng0.normal(size=200)], axis=1).astype(np.float32)
    for deg in (0.0, 30.0, 60.0, -40.0):
        th = np.deg2rad(deg)
        rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]], np.float32)
        assert (render_scans.scan_yaw_degrees(tmp_path, wide @ rot.T)
                == jrender.scan_yaw_degrees(tmp_path, wide @ rot.T))

    # the SMPL-X fit, inside the scan directory or in the THuman2.0 layout
    scan_a = tmp_path / "scanA"
    scan_a.mkdir()
    with open(scan_a / "smplx_param.pkl", "wb") as f:
        pickle.dump({"global_orient": np.array([[0.0, np.pi / 2, 0.0]])}, f)
    scan_b = tmp_path / "data" / "scans" / "scanB"
    scan_b.mkdir(parents=True)
    paras = tmp_path / "THuman2.0_Smpl_X_Paras" / "scanB"
    paras.mkdir(parents=True)
    with open(paras / "smplx_param.pkl", "wb") as f:
        pickle.dump({"global_orient": np.array([0.1, -0.7, 0.2])}, f)
    for d in (scan_a, scan_b):
        assert (render_scans.scan_yaw_degrees(d, wide)
                == jrender.scan_yaw_degrees(d, wide))
    assert render_scans.scan_yaw_degrees(scan_a, wide) == \
        pytest.approx(90.0, abs=1e-4)


def _write_scans(root, n=2):
    """n textured humanoid "scans" (OBJ with v/vt faces + a png texture),
    the chip run's meshes at 960 triangles."""
    for i in range(n):
        verts, faces, uv, tex = humanoid_mesh(i, levels=(1, 0), tex_res=64)
        write_scan(root, f"{i:04d}", verts, faces, uv, tex)


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("hr", [False, True])
def test_render_dataset_tree_byte_equal(tmp_path, hr):
    """res 96, two scans, val_every 2: the same files with the same bytes;
    the port's dataset reads them into JAX's samples, from the files and
    through the v2 cache."""
    scans = tmp_path / "scans"
    _write_scans(scans)
    ours, ref = tmp_path / "port", tmp_path / "jax"
    done = list(render_scans.render_dataset(scans, ours, res=96, hr=hr,
                                            val_every=2))
    assert done == list(jrender.render_dataset(scans, ref, res=96, hr=hr,
                                               val_every=2))
    assert done == [("0000", "train"), ("0001", "val")]
    files = _files(ours)
    assert files == _files(ref)
    assert len(files) == 2 * 5 * 5 + (2 * 3 if hr else 0)
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f

    kw = dict(data_root=str(ours), src_res=96, use_hr_img=hr)
    for processed in (False, True):
        if processed:
            shutil.rmtree(ours / "rectified_local", ignore_errors=True)
        tds = StereoHumanDataset(DatasetConfig(
            **kw, use_processed_data=processed), "val")
        jds = JDataset(JDatasetConfig(**kw, use_processed_data=processed),
                       "val")
        assert tds.scans == jds.scans == ["0001"]
        sample = tds.get_sample(0, (2, 3, 4), np.random.default_rng(0))
        assert_same(jds.get_sample(0, (2, 3, 4), np.random.default_rng(0)),
                    sample)
        assert sample["lmain"]["img"].shape == (96, 96, 3)
        assert sample["lmain"]["valid"].sum() > 50  # flow from the depth
