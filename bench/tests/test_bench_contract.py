"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits on sizes, and every file a name points to."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["run_seconds"] == int(SPEC["run_seconds"])


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / word).is_file()


def test_every_name_unit_and_line():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in SPEC["per_layer"])


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and _reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = json.loads((BENCH / "cells" / f"{cell}.json").read_text())
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert spec["config"] == w["config"] and spec["chips"] == w["chips"]
    assert spec["why"] == w["why"]
    assert (BENCH / "modes" / f"{spec['mode']}.py").is_file()
    assert (BENCH / "configs" / f"{spec['config']}.json").is_file()
    assert spec["limits"]


def test_metric_readers_found_by_name():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_file_states_its_cuts(conf):
    entry = next(c for c in SPEC["configs"] if c["name"] == conf)
    assert entry["file"].startswith("bench/configs/")
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["arch"] == conf
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    for key, published in data["reduced"].items():
        assert data[key] != published
        assert not key.endswith(("_dim", "_rank")) and key not in (
            "d_model", "d_ff", "d_head", "ssm_state", "ssm_head_dim",
            "ssm_expand", "moe_top_k")
    for key in ("source", "assumed", "deployment", "param_dtype",
                "compute_dtype"):
        assert key in data


def test_file_names_are_names():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
