"""The PyTorch port's package contract: it imports neither JAX nor the JAX
package, its entry points refuse a missing GPU instead of falling back,
its config overrides equal configs/stage2.yaml, and its CUDA kernels agree
with their plain versions (on a GPU only)."""

import ast
import dataclasses
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gps_gaussian_tpu_torch
from gps_gaussian_tpu_torch.train import config as tconfig

from thread_budget import thread_budget  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "gps_gaussian_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "gps_gaussian_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_source_imports_nothing_of_jax():
    offenders = []
    for path in sorted(list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]):
        for mod in _imported_roots(path):
            root = mod.split(".")[0]
            if root in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {mod}")
    assert not offenders, offenders
    checked = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"train/losses.py", "train/state.py", "train/trainer.py",
            "utils/profiling.py", "kernels/rasterizer/composite.py"} \
        <= checked


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    importing jax, flax, orbax or the JAX package raises."""
    mods = [m.name for m in pkgutil.walk_packages(
        gps_gaussian_tpu_torch.__path__, "gps_gaussian_tpu_torch.")]
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok', len(sys.modules))\n")
    assert {"gps_gaussian_tpu_torch.train.losses",
            "gps_gaussian_tpu_torch.train.state",
            "gps_gaussian_tpu_torch.utils.profiling"} <= set(mods)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_stage2_overrides_equal_yaml():
    """chip_smoke.py builds the stage-2 config without PyYAML; its
    overrides must give exactly configs/stage2.yaml."""
    chip_smoke = importlib.import_module("chip_smoke")
    from_yaml = tconfig.load_config(str(REPO / "configs" / "stage2.yaml"))
    assert tconfig.load_config(None, **chip_smoke.STAGE2_OVERRIDES) \
        == from_yaml
    assert from_yaml.raster.pair_budget == 6291456
    assert from_yaml.raft.mixed_precision


def test_port_config_matches_jax_config():
    from gps_gaussian_tpu.train.config import load_config as jax_load

    for path in ("stage1.yaml", "stage2.yaml"):
        path = str(REPO / "configs" / path)
        assert tconfig.as_dict(tconfig.load_config(path)) \
            == dataclasses.asdict(jax_load(path))


def test_entry_points_refuse_missing_gpu(monkeypatch):
    from gps_gaussian_tpu_torch.infer.freeview import FreeviewRenderer
    from gps_gaussian_tpu_torch.kernels.rasterizer import rasterize
    from gps_gaussian_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FreeviewRenderer(tconfig.load_config(None), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rasterize(None, None, (0.0, 0.0, 0.0))
    from gps_gaussian_tpu_torch.train.state import create_state
    from gps_gaussian_tpu_torch.train.trainer import (make_eval_step,
                                                      make_train_step)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(tconfig.load_config(None), torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(None, tconfig.load_config(None), "stage2", None,
                        None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(None, tconfig.load_config(None), "stage2", None)
    assert resolve_device("cpu").type == "cpu"


def test_composite_wrapper_checks_inputs():
    from gps_gaussian_tpu_torch.kernels.rasterizer.composite import \
        composite_fwd

    start = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="props"):
        composite_fwd(torch.zeros(8, 16), start, start, 2, 2)
    with pytest.raises(ValueError, match="count"):
        composite_fwd(torch.zeros(9, 16), start, start.long(), 2, 2)
    with pytest.raises(ValueError, match="whole samples"):
        composite_fwd(torch.zeros(9, 16), start, start, 3, 3)
    with pytest.raises(ValueError, match="props must be contiguous"):
        composite_fwd(torch.zeros(16, 9).t(), start, start, 2, 2)


def test_composite_bwd_wrapper_checks_inputs():
    from gps_gaussian_tpu_torch.kernels.rasterizer.composite import \
        composite_bwd

    start = torch.zeros(4, dtype=torch.int32)
    props = torch.zeros(9, 16)
    out = torch.zeros(4, 256, 4)
    with pytest.raises(ValueError, match="props"):
        composite_bwd(torch.zeros(8, 16), start, start, out, out, 2, 2)
    with pytest.raises(ValueError, match="g_out must be"):
        composite_bwd(props, start, start, out, torch.zeros(4, 256, 3), 2, 2)
    with pytest.raises(ValueError, match="out must be"):
        composite_bwd(props, start, start, out.double(), out, 2, 2)
    with pytest.raises(ValueError, match="g_out must be contiguous"):
        composite_bwd(props, start, start, out,
                      torch.zeros(4, 4, 256).permute(0, 2, 1), 2, 2)
    assert composite_bwd(props, start, start, out, out, 2,
                         2).abs().sum() == 0


@pytest.mark.cuda
def test_composite_bwd_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    from gps_gaussian_tpu_torch.kernels import build
    from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
        composite_bwd, composite_bwd_plain, composite_fwd)

    rng = np.random.default_rng(0)
    tiles_y, tiles_x, per = 3, 4, 300
    n = tiles_y * tiles_x * per
    props = np.stack([
        rng.uniform(0, 16 * tiles_x, n), rng.uniform(0, 16 * tiles_y, n),
        rng.uniform(0.01, 0.2, n), rng.uniform(-0.01, 0.01, n),
        rng.uniform(0.01, 0.2, n), rng.uniform(0.2, 1.2, n),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)])
    props = torch.tensor(props, dtype=torch.float32, device="cuda")
    start = torch.arange(0, n, per, dtype=torch.int32, device="cuda")
    count = torch.tensor(rng.integers(0, per, tiles_y * tiles_x),
                         dtype=torch.int32, device="cuda")
    out = composite_fwd(props, start, count, tiles_y, tiles_x)
    g_out = torch.tensor(rng.normal(size=tuple(out.shape)),
                         dtype=torch.float32, device="cuda")
    before = build.LAUNCHES.get("composite_bwd", 0)
    got = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    again = composite_bwd(props, start, count, out, g_out, tiles_y, tiles_x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["composite_bwd"] == before + 2
    assert torch.equal(got, again), "no atomics: the same bits every launch"
    ref = composite_bwd_plain(props, start, count, out, g_out, tiles_y,
                              tiles_x)
    # the two add a pair's 256 pixel terms in different orders: 1e-4 of
    # each row's largest gradient
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert bool((scale > 0).all())
    torch.testing.assert_close(got / scale, ref / scale, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_composite_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    from gps_gaussian_tpu_torch.kernels import build
    from gps_gaussian_tpu_torch.kernels.rasterizer.composite import (
        composite_fwd, composite_fwd_plain)

    rng = np.random.default_rng(0)
    tiles_y, tiles_x, per = 3, 4, 300
    n = tiles_y * tiles_x * per
    props = np.stack([
        rng.uniform(0, 16 * tiles_x, n), rng.uniform(0, 16 * tiles_y, n),
        rng.uniform(0.01, 0.2, n), rng.uniform(-0.01, 0.01, n),
        rng.uniform(0.01, 0.2, n), rng.uniform(0.2, 0.99, n),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)])
    props = torch.tensor(props, dtype=torch.float32, device="cuda")
    start = torch.arange(0, n, per, dtype=torch.int32, device="cuda")
    count = torch.tensor(rng.integers(0, per, tiles_y * tiles_x),
                         dtype=torch.int32, device="cuda")
    before = build.LAUNCHES.get("composite_fwd", 0)
    out = composite_fwd(props, start, count, tiles_y, tiles_x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["composite_fwd"] == before + 1
    ref = composite_fwd_plain(props, start, count, tiles_y, tiles_x)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
