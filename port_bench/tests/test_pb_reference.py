"""The frozen plain reference against the port's CPU path at a small size:
the same inputs give the same rectified samples, network outputs, renders,
composite gradients and optimizer steps."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.reference import composite as ref_composite
from port_bench.reference import pipeline
from port_bench.traffic import frames, silhouette

ROOT = Path(__file__).resolve().parents[2]
RECIPE = json.loads((ROOT / "port_bench/configs/gps_stage2.json")
                    .read_text())["recipe"]
SMALL = dict(RECIPE, dataset=dict(RECIPE["dataset"], src_res=64),
             raster={"max_tiles_per_gaussian": 16, "max_per_tile": 256,
                     "fg_cap": 4096, "pair_budget": 32768})


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    names = frames.write_sequence(
        root, {"n_frames": 2, "res": 64, "arc_deg": 22.5, "step_deg": 45.0,
               "jpeg_quality": 95}, 2 ** 33 + 1, "cpu")
    return root, names


def _port_dataset(root):
    from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                    StereoHumanDataset)
    return StereoHumanDataset(DatasetConfig(
        data_root=str(root), src_res=64, use_hr_img=True,
        use_processed_data=False), "test")


def _models(recipe, with_gs):
    from gps_gaussian_tpu_torch.train.config import load_config
    from gps_gaussian_tpu_torch.train.trainer import make_model
    from port_bench.drivers.train import seeded_weights

    port = make_model(load_config(None, **recipe), with_gs=with_gs)
    seeded_weights(port, 7, "cpu")
    ref = pipeline.build_model(recipe, with_gs)
    ref.load_state_dict(port.state_dict())
    return port, ref


def test_rectified_sample_equals_the_port_dataset(frame_dir):
    root, names = frame_dir
    port = _port_dataset(root).get_test_sample(1)
    ref = pipeline.test_sample(root, names[1])
    for v in ("lmain", "rmain"):
        for k in ("img", "mask", "intr", "ref_intr", "extr", "tf_x"):
            np.testing.assert_array_equal(port[v][k], ref[v][k])
    for k in ("intr_ori", "extr_ori"):
        for a, b in zip(port[k], ref[k]):
            np.testing.assert_array_equal(a, b)


def test_gaussians_and_view_equal_the_port_renderer(frame_dir):
    from gps_gaussian_tpu_torch.data.loader import collate
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
    from gps_gaussian_tpu_torch.train.config import load_config

    from port_bench import judge

    root, names = frame_dir
    port_model, ref_model = _models(SMALL, True)
    cfg = load_config(None, **SMALL)
    renderer = FreeviewRenderer(cfg, port_model.state_dict(), device="cpu")
    sample = _port_dataset(root).get_test_sample(0)
    g = renderer.gaussians(collate([sample]))
    cam = renderer.novel_camera_at(sample, 0.5, 128, 128)
    img, aux = renderer.render(g, cam)

    rs = pipeline.test_sample(root, names[0])
    rg = pipeline.frame_gaussians(ref_model.eval(),
                                     pipeline.stereo_batch(rs, "cpu"), 3,
                                     SMALL["raster"]["fg_cap"])
    rcam = pipeline.novel_camera(rs, 0.5, 128, 2.0, 0.01, 100.0, "cpu")
    rimg, rdrops = pipeline.render_view(rg, rcam, torch.zeros(3),
                                        pipeline.raster_config(SMALL))
    a, b = judge.gauss_dict(g), judge.gauss_dict(rg)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    np.testing.assert_allclose(img[0].clamp(0, 1).numpy(), rimg, rtol=0,
                               atol=1e-6)
    assert int(aux.num_dropped.sum() + aux.num_pair_dropped.sum()) == rdrops


def test_composite_walks_equal_the_port_plain_versions():
    from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
        composite_bwd_plain, composite_fwd_plain)

    g = torch.Generator().manual_seed(3)
    tiles_y, tiles_x, per = 3, 4, 24
    n = tiles_y * tiles_x
    count = torch.randint(0, per, (n,), generator=g).to(torch.int32)
    start = (torch.arange(n) * per).to(torch.int32)
    P = n * per
    props = torch.rand((9, P), generator=g)
    local = torch.arange(P) // per
    props[0] = (local % tiles_x) * 16 + props[0] * 16
    props[1] = (local // tiles_x) * 16 + props[1] * 16
    props[2] = 0.05 + props[2] * 0.2
    props[3] = (props[3] - 0.5) * 0.02
    props[4] = 0.05 + props[4] * 0.2
    props = props.contiguous()
    out = composite_fwd_plain(props, start, count, tiles_y, tiles_x)
    got, work = ref_composite.composite_fwd(props, start, count, tiles_y,
                                            tiles_x, return_work=True)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    _, walked = composite_fwd_plain(props, start, count, tiles_y, tiles_x,
                                    return_work=True)
    assert work[0] == int(walked)
    g_out = torch.rand(out.shape, generator=g)
    want = composite_bwd_plain(props, start, count, out, g_out, tiles_y,
                               tiles_x, return_work=True)
    grad = ref_composite.composite_bwd(props, start, count, out, g_out,
                                       tiles_y, tiles_x)
    torch.testing.assert_close(grad, want[0], rtol=0, atol=0)
    assert (work[1], work[2]) == (int(want[2]), int(want[3]))


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_train_steps_follow_the_port_step(stage):
    from gps_gaussian_tpu_torch.train.config import load_config
    from gps_gaussian_tpu_torch.train.state import create_state
    from gps_gaussian_tpu_torch.train.trainer import (make_raster_config,
                                                      make_train_step)

    from port_bench.drivers.train import program_batch

    recipe = dict(SMALL, stage=stage)
    port, ref = _models(recipe, stage == "stage2")
    start = {k: v.clone() for k, v in port.state_dict().items()}
    cfg = load_config(None, **recipe)
    state = create_state(cfg, port, "cpu")
    step = make_train_step(port, cfg, stage, make_raster_config(cfg), state,
                           device="cpu")
    pool = silhouette.make_pool({"pool": 2, "batch": 2, "res": 64,
                                 "novel_res": 128 if stage == "stage2" else 0,
                                 "fg_frac": 0.2}, 11, "cpu")
    losses = [float(step(program_batch(t))["loss"]) for t in pool]
    res = pipeline.train_steps(ref, [pipeline.train_batch(t, "cpu")
                                     for t in pool], recipe, stage)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
    for k, p in port.named_parameters():
        change = float(torch.linalg.vector_norm(p.detach() - start[k]))
        assert res["change_norms"][k] == pytest.approx(change, rel=1e-4,
                                                       abs=1e-9)
