"""Shared by the benchmark's own tests: the benchmark at a small size,
derived from the committed files, for driving whole runs on the CPU.

`small_bench` writes, under a temporary directory, each cell's workload
(every file under workloads/, listed in BENCHMARK.json or not yet),
traffic mix and configuration as committed with the sizes of SMALL laid
over them (64^2 sources, 128^2 views, three frames or batches of two), and
returns (BENCHMARK.json with the configurations pointing there, that
directory). Names, metrics, limits and bounds stay as committed.
"""

from __future__ import annotations

import copy
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_CONFIG = {"dataset": {"src_res": 64, "num_workers": 0},
                "raster": {"max_tiles_per_gaussian": 16, "max_per_tile": 256,
                           "fg_cap": 4096, "pair_budget": 32768}}
SMALL_TRAFFIC = {"frames": {"n_frames": 3, "res": 64, "n_views": 2},
                 "silhouette": {"pool": 3, "batch": 2, "res": 64,
                                "novel_res": 128}}
SMALL_WORKLOAD = {"profile_after": 1, "profile_frames": 1, "profile_steps": 1}


def _load(path) -> dict:
    return json.loads(Path(path).read_text())


def _write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def write_small(base: Path) -> dict:
    bench = _load(ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = _load(ROOT / c["file"])
        recipe = cfg["recipe"]
        for key, over in SMALL_CONFIG.items():
            if key in recipe:
                recipe[key] = dict(recipe[key], **over)
        c["file"] = str(base / "configs" / f"{c['name']}.json")
        _write(Path(c["file"]), cfg)
    listed = {w["name"] for w in bench["workloads"]}
    for f in sorted((BENCH / "workloads").glob("*.json")):
        # a cell whose files are here but which BENCHMARK.json does not list
        # yet is driven all the same
        if f.stem not in listed:
            wl = _load(f)
            bench["workloads"].append({k: wl[k] for k in
                                       ("name", "config", "traffic",
                                        "chips")})
    for w in bench["workloads"]:
        wl = dict(_load(BENCH / "workloads" / f"{w['name']}.json"),
                  **SMALL_WORKLOAD)
        _write(base / "workloads" / f"{w['name']}.json", wl)
        mix = _load(BENCH / "traffic" / f"{w['traffic']}.json")
        over = SMALL_TRAFFIC[mix["generator"]]
        if mix.get("novel_res", 1) == 0:
            over = dict(over, novel_res=0)
        if "n_views" not in mix:
            over = {k: v for k, v in over.items() if k != "n_views"}
        _write(base / "traffic" / f"{w['traffic']}.json", dict(mix, **over))
    return bench


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    base = tmp_path_factory.mktemp("small_bench")
    return copy.deepcopy(write_small(base)), base


def run_small(small, cell: str, seed: int, trace: int = 0,
              seconds: float = 0.5) -> dict:
    """One whole run of the small copy of `cell` on the CPU; returns the
    result line as a dict."""
    from port_bench import run

    bench, base = small
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", bench=copy.deepcopy(bench), base=base)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture
def cuda_device():
    """Skips a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")
