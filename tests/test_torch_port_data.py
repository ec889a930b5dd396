"""The port's data layer against the JAX package's, on the CPU.

Stereo rectification, the native remap and erosion, the dataset's samples
(with the compressed rectification cache in both directions), `collate`,
`eval_batches` and the loader's batch order are held bit-equal; the
stage-1 preview's `splat_points` exactly, on points without ties, and the
stage-1 eval step's preview within 1e-5. The scenes are
`synth.generate_dataset` trees at 64^2 (or the same scenes in memory).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu import native as jnative
from gps_gaussian_tpu.data import loader as jloader
from gps_gaussian_tpu.data import synth as jsynth
from gps_gaussian_tpu.data.thuman import DatasetConfig as JDatasetConfig
from gps_gaussian_tpu.data.thuman import StereoHumanDataset as JDataset
from gps_gaussian_tpu.geometry import stereo as jstereo
from gps_gaussian_tpu.kernels.point_splat import \
    splat_points as jsplat_points
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train import trainer as jtrainer

from gps_gaussian_tpu_torch import native
from gps_gaussian_tpu_torch.data import loader
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.geometry import stereo
from gps_gaussian_tpu_torch.kernels.point_splat import splat_points
from gps_gaussian_tpu_torch.testing import (DelayedDataset,
                                            SilhouetteDataset,
                                            SynthMemoryDataset, synth_scans)
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.train import trainer
from gps_gaussian_tpu_torch.utils import profiling
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

RES = 64


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    jsynth.generate_dataset(root, n_train=2, n_val=1, res=RES, hr=True)
    return root


def _cfgs(root, **kw):
    kw = dict(data_root=str(root), src_res=RES, **kw)
    return JDatasetConfig(**kw), DatasetConfig(**kw)


def assert_same(a, b, path="sample"):
    """Nested dicts / tuples of arrays equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, int)):
        assert a == b, path
    else:
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)


def _camera_pairs():
    rng = np.random.default_rng(5)
    for res in (64, 96):
        base = rng.uniform(0, 2 * np.pi)
        i0, e0 = jsynth.ring_camera(base, res)
        i1, e1 = jsynth.ring_camera(base + np.deg2rad(22.5), res)
        yield i0, e0, i1, e1, (res, res)


def test_stereo_rectification_bit_equal():
    rng = np.random.default_rng(3)
    for i0, e0, i1, e1, size in _camera_pairs():
        cam_j, m0_j, m1_j = jstereo.rectify_stereo_pair(i0, e0, i1, e1, size)
        cam_t, m0_t, m1_t = stereo.rectify_stereo_pair(i0, e0, i1, e1, size)
        assert_same(cam_j, cam_t)
        assert_same((m0_j, m1_j), (m0_t, m1_t))
        img = rng.integers(0, 256, size[::-1] + (3,), dtype=np.uint8)
        mask = rng.uniform(size=size[::-1]).astype(np.float32)
        assert_same(jstereo.remap_bilinear(img, *m0_j),
                    stereo.remap_bilinear(img, *m0_t))
        assert_same(jstereo.remap_bilinear(mask, *m1_j),
                    stereo.remap_bilinear(mask, *m1_t))
        assert_same(jstereo.erode3x3(mask), stereo.erode3x3(mask))


def test_native_remap_and_erode_bit_equal():
    """The port's copy of image_ops.cpp, built with the same flags, gives
    the JAX package's native results bit for bit."""
    assert native.available() and jnative.available()
    rng = np.random.default_rng(4)
    for i0, e0, i1, e1, size in _camera_pairs():
        _, m0, _ = stereo.rectify_stereo_pair(i0, e0, i1, e1, size)
        img = rng.integers(0, 256, size[::-1] + (3,), dtype=np.uint8)
        flt = rng.normal(size=size[::-1]).astype(np.float32)
        assert_same(jnative.remap_bilinear(img, *m0),
                    native.remap_bilinear(img, *m0))
        assert_same(jnative.remap_bilinear(flt, *m0),
                    native.remap_bilinear(flt, *m0))
        assert_same(jnative.erode3x3(flt), native.erode3x3(flt))


@pytest.mark.parametrize("phase", ["train", "val"])
def test_samples_bit_equal(tree, phase):
    """get_sample with the same generator, hi-res novel targets, and
    get_test_sample, from files."""
    jc, tc = _cfgs(tree, use_hr_img=True, use_processed_data=False)
    jds, tds = JDataset(jc, phase), StereoHumanDataset(tc, phase)
    assert jds.scans == tds.scans
    for i in range(len(jds)):
        assert_same(jds.get_sample(i, (2, 3, 4), np.random.default_rng(i)),
                    tds.get_sample(i, (2, 3, 4), np.random.default_rng(i)))
    assert_same(jds.get_test_sample(0), tds.get_test_sample(0))


def _composed(img, mask, maps):
    """The test-mode view as separate passes: remap the 8-bit image and
    the f32 mask, then normalise (get_test_sample before the fused pass)."""
    img = native.remap_bilinear(img, *maps).astype(np.float32) / 255.0
    mask = native.remap_bilinear(mask.astype(np.float32), *maps) / 255.0
    mask_bin = (mask >= 0.5).astype(np.float32)
    return (2.0 * img - 1.0) * mask[..., None], mask_bin


def _rectify_case(res, zoom=1.0):
    """A seeded ring pair at res^2; `zoom` lengthens view 1's focal, so
    its map runs off the source."""
    rng = np.random.default_rng(res)
    base = rng.uniform(0, 2 * np.pi)
    i0, e0 = jsynth.ring_camera(base, res)
    i1, e1 = jsynth.ring_camera(base + np.deg2rad(22.5), res)
    i1 = np.array(i1, np.float64)
    i1[:2, :2] *= zoom
    imgs = [rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
            for _ in range(2)]
    # masks mostly 0 or 255, with soft edges around the 0.5 threshold
    masks = [np.where(rng.uniform(size=(res, res)) < 0.5, 0,
                      rng.choice([255, 255, 127, 128, 129], (res, res)))
             .astype(np.uint8) for _ in range(2)]
    return (i0, e0, i1, e1, (res, res)), imgs, masks


@pytest.mark.parametrize("case", ["native-64", "native-96", "native-1024",
                                  "border-96", "fallback-64", "counters"])
def test_rectify_view_bit_equal(case, tree, monkeypatch):
    """`native.rectify_view` (decode to network input in one pass) against
    the composition it replaced: `rectify_stereo_pair` maps,
    `native.remap_bilinear`, the NumPy normalisation, bit for bit; on
    seeded pairs, on a pose whose map runs off the source (zero border),
    and through its NumPy fallback. `counters`: one `get_test_sample`
    under the tracer decodes each needed file once and fuses both views."""
    if case == "counters":
        ds = StereoHumanDataset(_cfgs(tree, use_processed_data=False)[1],
                                "val")
        profiling.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ds.get_test_sample(0)
        c = profiling.counters()
        profiling.clear()
        assert c["read.files_decoded"] == c["read.files_needed"] == 4
        assert c["read.views_fused"] == c["read.views"] == 2
        return
    kind, res = case.split("-")
    pair, imgs, masks = _rectify_case(int(res), 2.0 if kind == "border"
                                      else 1.0)
    if kind == "fallback":
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    cam, maps0, maps1 = stereo.rectify_stereo_pair(*pair)
    cam_s, views = stereo.rectify_stereo_cameras(*pair)
    assert_same(cam, cam_s)
    for img, mask, maps, (iR, K) in zip(imgs, masks, (maps0, maps1), views):
        out_img, out_mask, fused = native.rectify_view(img, mask, iR, K,
                                                       pair[-1])
        assert fused == (kind != "fallback")
        want_img, want_mask = _composed(img, mask, maps)
        assert_same((want_img, want_mask), (out_img, out_mask))
    if kind == "border":
        mx, my = maps1   # every tap off the source: zero border
        off = (mx < -1) | (mx >= mx.shape[1]) | (my < -1) | \
            (my >= mx.shape[0])
        assert off.mean() > 0.2
        assert (out_mask[off] == 0).all() and (out_img[off] == 0).all()


def test_rectified_cache_round_trip_both_ways(tree, tmp_path):
    """The v2 cache (JPEG images, PNG masks) that either package writes
    decodes to the same sample in the other, and its first build returns
    the decoded round trip, as later hits do."""
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    jc, tc = _cfgs(root, use_processed_data=True)
    cache = root / "rectified_local" / "train"
    for writer, reader in ((StereoHumanDataset(tc, "train"),
                            JDataset(jc, "train")),
                           (JDataset(jc, "train"),
                            StereoHumanDataset(tc, "train"))):
        shutil.rmtree(cache)
        cache.mkdir()
        built = writer.rectified_stereo(writer.scans[0])
        assert (cache / f"{writer.scans[0]}.npz").exists()
        assert_same(built, reader.rectified_stereo(reader.scans[0]))
        assert_same(built, writer.rectified_stereo(writer.scans[0]))


def test_collate_and_eval_batches_match(tree):
    jc, tc = _cfgs(tree, use_processed_data=False)
    jds, tds = JDataset(jc, "train"), StereoHumanDataset(tc, "train")
    samples = [tds.get_sample(i, (2, 3), np.random.default_rng(i))
               for i in range(2)]
    j, t = jloader.collate(samples), loader.collate(samples)
    for view in ("lmain", "rmain"):
        for k in ("img", "mask", "intr", "ref_intr", "extr", "tf_x", "flow",
                  "valid"):
            assert_same(getattr(getattr(j, view), k),
                        getattr(getattr(t, view), k), f"{view}.{k}")
    for k in ("view", "proj", "cam_center", "tanfovx", "tanfovy"):
        assert_same(getattr(j.novel.camera, k), getattr(t.novel.camera, k), k)
    assert (j.novel.camera.height, j.novel.camera.width) == \
        (t.novel.camera.height, t.novel.camera.width)
    for k in ("img", "intr", "extr"):
        assert_same(getattr(j.novel, k), getattr(t.novel, k), k)

    # 1 val scan in batches of 2: the tail wraps with weight 0
    jv, tv = JDataset(jc, "val"), StereoHumanDataset(tc, "val")
    sweep_j = list(jloader.eval_batches(jv, 2, (3,)))
    sweep_t = list(loader.eval_batches(tv, 2, (3,)))
    assert len(sweep_j) == len(sweep_t) == 1
    (bj, wj), (bt, wt) = sweep_j[0], sweep_t[0]
    assert_same(wj, wt)
    assert wt.tolist() == [1.0, 0.0]
    assert_same(bj.lmain.img, bt.lmain.img)
    assert_same(bj.novel.img, bt.novel.img)


def _reference_batches(ds, n, seed):
    """The first n batches of a loader seeded `seed`, in task order: the
    JAX BatchLoader's own task draws (no workers), built one by one."""
    ref = jloader.BatchLoader(ds, 2, (2, 3, 4), seed=seed, num_threads=0)
    out = []
    for _ in range(n):
        idxs, s = ref._next_task()
        rng = np.random.default_rng(s)
        out.append(jloader.collate([ds.get_sample(int(i), (2, 3, 4), rng)
                                    for i in idxs]))
    ref.close()
    return out


@pytest.mark.parametrize("workers", ["threads", "processes"])
def test_loader_delivers_in_task_order(workers):
    """Batches come out in the order their tasks were drawn, though the
    workers finish them out of order (low indices are slow to load, so a
    later task often finishes first): twice the same sequence, equal to the
    JAX loader's task sequence built in order."""
    ds = DelayedDataset(SilhouetteDataset(32, 32, 6, seed=2),
                        [0.3, 0.25, 0.2, 0.15, 0.1, 0.05])
    kw = (dict(num_threads=2) if workers == "threads"
          else dict(num_procs=2))
    ref = _reference_batches(ds, 5, seed=11)
    for _ in range(2):
        it = loader.BatchLoader(ds, 2, (2, 3, 4), seed=11, **kw)
        try:
            got = [next(it) for _ in range(5)]
        finally:
            it.close()
        for b_ref, b in zip(ref, got):
            assert_same(b_ref.lmain.img, b.lmain.img)
            assert_same(b_ref.rmain.flow, b.rmain.flow)
            assert_same(b_ref.novel.camera.view, b.novel.camera.view)


def test_loader_raises_what_a_worker_raised():
    class Broken:
        scans = ["a", "b"]

        def __len__(self):
            return 2

        def get_sample(self, index, novel_ids, rng=None):
            raise ValueError("unreadable scan")

    it = loader.BatchLoader(Broken(), 2, None, num_threads=1)
    try:
        with pytest.raises(ValueError, match="unreadable scan"):
            next(it)
    finally:
        it.close()


def test_synth_memory_dataset_matches_files(tree):
    """load_view without files gives what the files hold, but for the
    JPEG round trip of the images."""
    jc, tc = _cfgs(tree / "val", use_hr_img=True)
    disk = JDataset(jc, "test")
    mem = SynthMemoryDataset(tc, synth_scans("val", 1), "test")
    assert mem.scans == disk.scans
    for vid, hr in ((0, False), (1, False), (3, True)):
        a = disk.load_view(mem.scans[0], vid, hr=hr)
        b = mem.load_view(mem.scans[0], vid, hr=hr)
        assert_same(a[1:], b[1:], f"view {vid}")
        assert b[0].shape == a[0].shape == ((2 if hr else 1) * RES,) * 2 + (3,)
        assert np.abs(a[0].astype(np.float32) - b[0]).mean() < 3.0


def _tie_free_points(rng, b, n, h, w):
    """Points that project near pixel centres, so both packages round them
    alike, with distinct inverse depths; some share a pixel."""
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * h, h / 2], [0, 0, 1]],
                 np.float32)
    E = np.eye(3, 4, dtype=np.float32)
    E[2, 3] = 2.0
    u = rng.integers(-2, w + 2, (b, n)) + rng.uniform(-0.3, 0.3, (b, n))
    v = rng.integers(-2, h + 2, (b, n)) + rng.uniform(-0.3, 0.3, (b, n))
    z = rng.permutation(b * n).reshape(b, n) * 1e-3 + 1.0
    xyz = np.stack([(u - K[0, 2]) * z / K[0, 0],
                    (v - K[1, 2]) * z / K[1, 1], z - 2.0], -1)
    rgb = rng.uniform(0, 1, (b, n, 3))
    valid = (rng.uniform(size=(b, n)) > 0.1).astype(np.float32)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(xyz), f32(rgb), valid, np.tile(K, (b, 1, 1)),
            np.tile(E, (b, 1, 1)))


def test_splat_points_exact_without_ties():
    rng = np.random.default_rng(8)
    h, w = 24, 32
    args = _tie_free_points(rng, 2, 3000, h, w)
    ref = np.asarray(jsplat_points(*args, h, w))
    out = splat_points(*(torch.tensor(a) for a in args), h, w)
    assert out.shape == (2, h, w, 3)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref.sum(-1) > 0).mean() > 0.5


def test_stage1_eval_preview_matches_jax():
    """The stage-1 eval step of a narrow f32 model: EPE metrics and the
    point-splat preview of the predicted geometry, within 1e-5."""
    over = dict(batch_size=2, stage="stage1",
                raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32]),
                dataset=dict(src_res=RES, use_hr_img=False))
    jcfg = jconfig.load_config(None, **over)
    tcfg = tconfig.load_config(None, **over)
    # synthetic ring-camera scans: the silhouette rig's novel camera is a
    # pure x shift of rectified sources, so every point would project onto
    # a half-integer row and its rounding would hang on the last bit
    ds = SynthMemoryDataset(DatasetConfig(data_root="", src_res=RES),
                            synth_scans("train", 2), "train")
    samples = [ds.get_sample(i, (3,), np.random.default_rng(i))
               for i in range(2)]
    jbatch = jloader.collate(samples)
    jmodel = jtrainer.make_model(jcfg, with_gs=False)
    params = jax.jit(lambda k: jmodel.init(k, jbatch, iters=3))(
        jax.random.PRNGKey(1))
    weight = np.array([1.0, 0.0], np.float32)
    jstep = jax.jit(jtrainer.make_eval_step(
        jmodel, jcfg, "stage1", jtrainer.make_raster_config(jcfg)))
    met_j, img_j = jstep(params, jbatch, jnp.asarray(weight))

    model = trainer.make_model(tcfg, with_gs=False)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    step = trainer.make_eval_step(model, tcfg, "stage1",
                                  trainer.make_raster_config(tcfg),
                                  device="cpu")
    met, img = step(loader.collate(samples), torch.tensor(weight))
    assert set(met) == set(met_j)
    for k, (num, den) in met_j.items():
        np.testing.assert_allclose(met[k][0].item(), float(num), rtol=1e-4,
                                   err_msg=k)
        assert met[k][1].item() == float(den)
    assert img.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-5,
                               rtol=0)
    assert (img.numpy().sum(-1) > 0).mean() > 0.1
