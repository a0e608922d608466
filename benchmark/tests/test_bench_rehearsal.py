"""A CPU rehearsal of every cell at a tiny size, through the harness's
function (the CLI refuses without a card): the run's result carries
exactly the contract's keys, its checks last, and comes out correct, so
the reference agrees with the program run on the CPU."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import spec
from benchmark.run import run_cell
from conftest import ROOT, TINY

CELLS = [w["name"] for w in spec.bench()["workloads"]]
HEAD = ["correct", "attempted", "failed", "metrics", "device"]


def _short(cell: str) -> dict:
    return {"rate_per_s": 3.0} if "push" in cell else None


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal(cell, trace):
    res, lines = run_cell(cell, 2**31 + 7, 2.0, bool(trace), device="cpu",
                          t_start=time.perf_counter(), deployment=TINY,
                          traffic=_short(cell))
    keys = list(json.loads(json.dumps(res)))
    assert keys == HEAD + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    c = spec.resolve(cell)
    want = ({m["name"] for m in c.per_layer} if trace
            else {m["name"] for m in c.end_to_end})
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    assert res["checks"]["lane_rate_gap"]["value"] < 1e-5
    assert all(ln.startswith("check ") for ln in lines[-len(res["checks"]):])


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    cannot run a cell: the program is not there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.run import run_cell;"
            f"run_cell({CELLS[0]!r}, 1, 1.0, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "workload_variant_autoscaler_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_cli_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
