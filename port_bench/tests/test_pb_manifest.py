"""BENCHMARK.json and every file it names: they parse, their names and
units keep to the allowed characters, each cell finds its files by name,
and each per-layer metric moves an end-to-end metric its cells report."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_size():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    b = json.loads(text)
    assert set(b) == KEYS
    assert b["paths"] == ["port_bench"]
    assert 1 <= len(b["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in b["command"])
    for w in b["command"][1:]:
        if "/" in w:
            assert w.startswith("port_bench/") and ".." not in w
    for p in b["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p


def test_run_seconds_fit_the_check_with_24_cells():
    s = bench()["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_text(kind):
    entries = bench()[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.fullmatch(e[key]), e[key]


def test_configs_files_and_reduced():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert cfg["reduced"] == c["reduced"]
        for key in ("recipe", "stage", "precision", "control", "peak_flops",
                    "flops", "weights"):
            assert key in cfg


@pytest.mark.parametrize("name,yaml_file", [("gps_stage2", "stage2.yaml"),
                                            ("gps_stage1", "stage1.yaml")])
def test_config_recipe_is_the_repository_recipe(name, yaml_file):
    yaml = pytest.importorskip("yaml")
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    recipe = yaml.safe_load((ROOT / "configs" / yaml_file).read_text())
    assert cfg["recipe"] == recipe


def test_every_cell_file_is_a_cell_or_waits_for_one():
    """Cells under workloads/ that BENCHMARK.json does not list are ready
    for a later PR to add by an entry alone."""
    listed = {w["name"] for w in bench()["workloads"]}
    files = {f.stem for f in (BENCH / "workloads").glob("*.json")}
    assert listed <= files
    assert files - listed == {"serve-interp-5view"}


def test_workloads_find_their_files():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["config"] in configs
        assert NAME.fullmatch(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                        .read_text())
        for key in ("name", "config", "traffic", "chips"):
            assert wl[key] == w[key]
        assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())


def _reports(b, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_and_a_layer():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        mine = [m["name"] for m in b["end_to_end"]
                if _reports(b, m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(b, m, w["name"]) for m in b["per_layer"])


def test_bounds():
    for m in bench()["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] <= 0.25


def test_per_layer_moves_a_metric_each_of_its_cells_reports():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(b, e2e[m["moves"]], cell), (m["name"], cell)


def test_kernel_shares_are_named_as_rooflines():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel


def test_flop_counts_are_the_reference_count():
    from port_bench.tools.count_flops import count

    for name in ("gps_stage2", "gps_stage1"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        got = count(cfg)
        for key in ("serve_forward", "train_step_per_sample"):
            assert cfg["flops"][key] == got[key]
