"""What the benchmark loads: in a fresh process, after the harness, the
window loops, every layer reader, the reference and the program modules a
run uses are imported, no module whose top-level name is jax, jaxlib,
flax or the JAX package is loaded; the reference alone loads nothing of
the program either."""

import json
import subprocess
import sys

from conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "workload_variant_autoscaler_tpu"}
PORT = "workload_variant_autoscaler_tpu_torch"

HARNESS = f"""
import glob, json, os, sys
sys.path.insert(0, {ROOT!r})
import benchmark.run, benchmark.harness, benchmark.build, benchmark.control
import benchmark.loops.polled, benchmark.loops.push, benchmark.trace
import benchmark.roofline, benchmark.sweep_push
import benchmark.traffic.rescale, benchmark.traffic.poisson_push
from benchmark import spec
for p in glob.glob(os.path.join({ROOT!r}, "benchmark", "layers", "*.py")):
    spec.load_module(spec.Path(p), "layer_" + os.path.basename(p)[:-3].replace(".", "_"))
from benchmark.build import modules
modules()
import {PORT}.stream, {PORT}.ops.fused, {PORT}.controller.translate
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import benchmark.reference.decide, benchmark.reference.sizing, benchmark.fleet
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _top_level(HARNESS)
    assert PORT in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (JAX_SIDE | {PORT}), loaded & (JAX_SIDE | {PORT})


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark.run import FORBIDDEN

    assert PORT.split(".")[0] not in FORBIDDEN
    assert "workload_variant_autoscaler_tpu" in FORBIDDEN
