"""The port's reconcile cycle against the JAX package's under scripted
dependency faults.

Same harness as tests/test_torch_reconciler.py (every cycle held equal
for every VA: published status and conditions, the solution each VA was
published from, the decision series, the DecisionRecords, the
ReconcileResult), on the 256-VA, 2-profile fleet in float64, with a
seeded `FaultPlan` of each package's own `faults/` types attached to
the kube and wrapped around Prometheus (`FaultyPromAPI`), advanced one
cycle per reconcile: a Prometheus timeout window (the stale-cache rung
and the breaker), one model's series dropping out of the grouped fleet
queries (the per-variant repair path), a failing Deployment LIST (the
per-variant GET fallback), and a drained node pool in limited mode (the
capacity shrinking under the greedy).
"""

import pytest
import torch

from reconcile_cluster import Cluster
from test_torch_reconciler import CYCLES, drive


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


CASES = {
    "prom-timeout-window": Cluster(faults=(
        dict(kind="prom-timeout", after_cycle=3, until_cycle=5),)),
    "prom-label-drop-one-model": Cluster(faults=(
        dict(kind="prom-label-drop", after_cycle=2, until_cycle=5,
             labels={"model_name": "m3"}),)),
    "deployment-list-error": Cluster(faults=(
        dict(kind="kube-error", match="list:Deployment", after_cycle=2,
             until_cycle=4),)),
    "node-pool-drain-limited": Cluster(
        nodes=(("v5e", 384), ("v5e", 256)),
        faults=(dict(kind="node-pool-drain", match="node-v5e-1:",
                     after_cycle=3, until_cycle=5),)),
}


def _stale(p, results):
    assert any(set(r.degraded.values()) == {"stale-cache"}
               and len(r.degraded) == len(r.processed) for r in results)


def _repaired(p, results):
    modes = {rec.inputs.collection_mode
             for rec in p.rec.decisions.records() if rec.cycle == 2}
    assert modes == {"fleet", "per-variant-repair"}


def _listed(p, results):
    assert all(len(r.processed) == BASE_VARIANTS for r in results)


def _drained(p, results):
    trips = [t for t in p.plan.trips if t[1] == "node-pool-drain"]
    assert {t[0] for t in trips} == {3, 4}


BASE_VARIANTS = Cluster().variants
CHECKS = {"prom-timeout-window": _stale,
          "prom-label-drop-one-model": _repaired,
          "deployment-list-error": _listed,
          "node-pool-drain-limited": _drained}


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_cycles_equal_reference_float64(case, monkeypatch):
    _j, p, results = drive(CASES[case], monkeypatch)
    assert p.rec.state.cycle_index == CYCLES
    CHECKS[case](p, results)
