"""BENCHMARK.json against the contract's shape, and every cell found by
name: its configuration, traffic mix, generator, window loop and readers. A
cell added by files and entries alone is found without an edit."""

import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.bench()


def test_top_level_keys(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_config_and_cell_entries(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
        assert len(w["why"]) <= 200


def test_metric_entries(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.bench()
                                  ["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.chips == 1
    assert c.generator_path.is_file() and c.loop_path.is_file()
    assert c.per_layer and all(p.is_file() for p in c.reader_paths.values())
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2


def test_cell_added_by_files_only(tmp_path):
    """A new configuration, traffic mix, generator, reader and cell, as a
    later change would add them, resolve and load with no edit."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.bench()
    cfg = json.loads((here / "configs" / "va512-s8.json").read_text())
    cfg["deployment"]["variants"] = 1024
    (here / "configs" / "va1024-s8.json").write_text(json.dumps(cfg))
    (here / "traffic" / "flat.py").write_text(
        "class Traffic:\n"
        "    def __init__(self, params, fleet, base, seed):\n"
        "        pass\n"
        "    def step(self, loads):\n"
        "        return []\n")
    (here / "traffic" / "flat.json").write_text(json.dumps(
        {"mode": "polled", "generator": "flat", "params": {
            "interval_s": 60}}))
    (here / "layers" / "new.metric.py").write_text(
        "def read(rec):\n    return rec.get('x')\n")
    b["configs"].append({"name": "va1024-s8", "source": "https://x.y",
                         "file": "benchmark/configs/va1024-s8.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "va1024-flat", "config": "va1024-s8",
                           "traffic": "flat", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "new.metric", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "cycle_ms",
                           "workloads": ["va1024-flat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.resolve("va1024-flat", root=tmp_path, here=here)
    assert c.config["deployment"]["variants"] == 1024
    assert c.generator_path == here / "traffic" / "flat.py"
    reader = spec.load_module(c.reader_paths["new.metric"], "new_metric")
    assert reader.read({"x": 2.5}) == 2.5
    assert reader.read({}) is None
