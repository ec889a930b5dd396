"""The port's command-line tools, configs, exported weights and dataset
inference, on the CPU.

The four CLIs run end to end on a 64^2 synthetic tree with `--device cpu`;
JSON configs load to the JAX package's Config; the committed
`runs/synth256/stage2/torch/ckpt_1200.pt` equals the converted Orbax
checkpoint bit for bit; `infer_static` and `infer_sequence` on those
weights (f32, full stage-2 width) match the JAX renderer's images within
1e-4, as the serving slice's freeview test holds them.
"""

import dataclasses
import importlib
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.data.loader import collate as jcollate
from gps_gaussian_tpu.data.thuman import DatasetConfig as JDatasetConfig
from gps_gaussian_tpu.data.thuman import StereoHumanDataset as JDataset
from gps_gaussian_tpu.infer.freeview import FreeviewRenderer as JRenderer
from gps_gaussian_tpu.train import config as jconfig
from gps_gaussian_tpu.train.state import restore_params_partial as jrestore
from gps_gaussian_tpu.train.trainer import make_model as jmake_model

from gps_gaussian_tpu_torch.cli import (test_real_data, test_view_interp,
                                        train_stage1, train_stage2)
from gps_gaussian_tpu_torch.data import synth
from gps_gaussian_tpu_torch.data.thuman import (DatasetConfig,
                                                StereoHumanDataset)
from gps_gaussian_tpu_torch.infer.freeview import load_renderer
from gps_gaussian_tpu_torch.train import config as tconfig
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RES = 64
RUN = REPO / "runs" / "synth256" / "stage2"
TINY = dict(
    batch_size=2, num_steps=2,
    raft=dict(encoder_dims=[16, 24, 32], hidden_dims=[32, 32, 32],
              train_iters=1, val_iters=1),
    gsnet=dict(encoder_dims=[16, 24, 32], decoder_dims=[24, 32, 32],
               parm_head_dim=16),
    raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096, fg_cap=8192),
    dataset=dict(src_res=RES, use_hr_img=False, use_processed_data=True,
                 num_workers=0),
    record=dict(loss_freq=1, eval_freq=2))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    synth.generate_dataset(root, n_train=2, n_val=1, res=RES, hr=False)
    return root


def _asdict(cfg):
    """A config's fields: the port's without its RAFT-Stereo keys, which
    the JAX package lacks, where they hold GPS-Gaussian's values."""
    if isinstance(cfg, tconfig.Config):
        return tconfig.as_dict(cfg)
    return dataclasses.asdict(cfg)


def test_cli_train_and_infer_on_cpu(tree, tmp_path):
    """Stage 1, stage 2 warm-started from it, then both inference tools on
    the stage-2 checkpoint; each writes what its JAX counterpart does."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(TINY))
    common = ["--config", str(cfg_path), "--data_root", str(tree),
              "--device", "cpu"]
    s1 = train_stage1.main(common + ["--exp_dir", str(tmp_path / "s1"),
                                     "--eval_first"])
    assert (tmp_path / "s1" / "show" / "00000000.jpg").exists()
    s2 = train_stage2.main(common + ["--exp_dir", str(tmp_path / "s2"),
                                     "--stage1_ckpt",
                                     str(tmp_path / "s1" / "ckpt")])
    for tr, stage in ((s1, "stage1"), (s2, "stage2")):
        assert tr.state.step == 2 and tr.device.type == "cpu"
        assert (tr.exp_dir / "ckpt" / "ckpt_2.pt").exists()
        assert (tr.exp_dir / "show" / "00000002.jpg").exists()
        assert shutil.which("git") is None \
            or (tr.exp_dir / "provenance.txt").read_text().startswith("git")
        saved = tr.exp_dir / "cfg.json"
        assert tconfig.load_config(str(saved)) == tr.cfg
        assert _asdict(jconfig.load_config(str(saved))) == _asdict(tr.cfg)
        assert tr.cfg.stage == stage
    assert s1.last_preview.shape == (RES, RES, 3)
    assert s2.n_restored == len(s1.model.state_dict())

    infer = ["--config", str(cfg_path), "--test_data_root",
             str(tree / "train"), "--ckpt_path", str(tmp_path / "s2" / "ckpt"),
             "--device", "cpu"]
    test_view_interp.main(infer + ["--novel_view_nums", "2", "--out_dir",
                                   str(tmp_path / "interp")])
    test_real_data.main(infer + ["--out_dir", str(tmp_path / "seq")])
    assert sorted(p.name for p in (tmp_path / "interp").iterdir()) == [
        "0000_novel0.jpg", "0000_novel1.jpg", "0001_novel0.jpg",
        "0001_novel1.jpg"]
    assert sorted(p.name for p in (tmp_path / "seq").iterdir()) == [
        "0000_novel.jpg", "0001_novel.jpg"]


def test_new_entry_points_refuse_missing_gpu(tree, monkeypatch):
    from gps_gaussian_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.load_config(None, **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, exp_dir=str(tree / "never"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_renderer(cfg, str(RUN / "torch"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_real_data.main(["--config",
                             str(REPO / "configs" / "stage2.yaml"),
                             "--test_data_root", str(tree / "train"),
                             "--ckpt_path", str(RUN / "torch")])


@pytest.mark.parametrize("name", ["stage1", "stage2", "stage1_synth256",
                                  "stage2_synth256"])
def test_json_config_loads_like_jax(name, tmp_path):
    """A recipe saved as JSON reads back to the same Config here, and to the
    same fields in the JAX package (whose PyYAML reads JSON)."""
    yaml_cfg = tconfig.load_config(str(REPO / "configs" / f"{name}.yaml"))
    path = tmp_path / f"{name}.json"
    tconfig.save_config(yaml_cfg, str(path))
    assert tconfig.load_config(str(path)) == yaml_cfg
    assert _asdict(jconfig.load_config(str(path))) == _asdict(yaml_cfg) \
        == _asdict(jconfig.load_config(
            str(REPO / "configs" / f"{name}.yaml")))


def test_chip_smoke_overrides_equal_yaml():
    """chip_smoke.py writes the recipes out (the card has no PyYAML)."""
    chip_smoke = importlib.import_module("chip_smoke")
    for overrides, name in ((chip_smoke.STAGE1_OVERRIDES, "stage1"),
                            (chip_smoke.SYNTH256_OVERRIDES,
                             "stage2_synth256")):
        assert tconfig.load_config(None, **overrides) == tconfig.load_config(
            str(REPO / "configs" / f"{name}.yaml"))


@pytest.fixture(scope="module")
def trained(tree):
    """The committed stage-2 run: JAX params from Orbax, and a test-phase
    dataset on the tiny tree for both packages."""
    cfg = jconfig.load_config(None, dataset=dict(src_res=RES))
    batch = jcollate([JDataset(JDatasetConfig(
        data_root=str(tree / "train"), src_res=RES), "test")
        .get_test_sample(0)])
    model = jmake_model(cfg, with_gs=True)
    target = jax.eval_shape(
        lambda k: model.init(k, batch, iters=3, test_mode=True),
        jax.random.PRNGKey(0))
    params, n = jrestore(str(RUN), target)
    assert n == 246
    return params


def test_exported_checkpoint_equals_orbax(trained):
    saved = torch.load(RUN / "torch" / "ckpt_1200.pt", weights_only=True)
    assert saved["step"] == 1200
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, trained))
    assert set(saved["params"]) == set(ref)
    for name, t in ref.items():
        assert saved["params"][name].dtype == torch.float32
        assert torch.equal(saved["params"][name], t), name


def test_dataset_inference_matches_jax(tree, trained):
    """load_renderer on the exported file, then both sweeps, against the
    JAX renderer on the Orbax params: f32 convolutions, no fg_cap (both
    render every valid row)."""
    over = dict(raft=dict(mixed_precision=False),
                dataset=dict(src_res=RES, use_hr_img=False,
                             use_processed_data=False),
                raster=dict(max_tiles_per_gaussian=16, max_per_tile=4096,
                            fg_cap=None, pair_budget=None))
    kw = dict(data_root=str(tree / "train"), src_res=RES,
              use_processed_data=False)
    jr = JRenderer(jconfig.load_config(None, **over), trained,
                   JDataset(JDatasetConfig(**kw), "test"))
    tr = load_renderer(tconfig.load_config(None, **over), str(RUN / "torch"),
                       StereoHumanDataset(DatasetConfig(**kw), "test"),
                       device="cpu")
    ref = jr.infer_static(1, n_views=3)
    got = tr.infer_static(1, n_views=3)
    assert len(got) == 3 and got[0].shape == (RES, RES, 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert np.abs(got[0] - got[2]).mean() > 1e-4
    seq_ref = list(jr.infer_sequence(0.5))
    seq = list(tr.infer_sequence(0.5))
    assert [n for n, _ in seq] == [n for n, _ in seq_ref] == ["0000", "0001"]
    for (_, a), (_, b) in zip(seq, seq_ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
