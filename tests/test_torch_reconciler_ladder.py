"""The port's reconcile cycle against the JAX package's: the engine
variants, the degradation ladder and the scoped cycle.

Same harness as tests/test_torch_reconciler.py (every cycle held equal
for every VA: published status and conditions, the solution each VA was
published from, the decision series, the DecisionRecords, the
ReconcileResult), on the 256-VA, 2-profile fleet, float64, for: the
hierarchical engine forced on at a small fleet (64 VAs); a Prometheus error
reaching the stale-cache tier and the HOLD rung; the scale-down
stabilization window under falling load; Deployments that go missing;
and `reconcile(scope=...)` micro-cycles, with and without streamed
loads.
"""

import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import Cluster
from test_torch_reconciler import BASE, CYCLES, drive


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def _failing(cycle, j, p, load):
    """One group fails from the first cycle (no cache: HOLD), another
    on cycles 3-4 (served from the stale cache)."""
    keys = sorted(load)
    failing = ((keys[0],) if cycle <= 2 else ()) \
        + ((keys[1],) if cycle in (3, 4) else ())
    rc.set_loads(j, load, failing)
    rc.set_loads(p, load, failing)


def _missing_deployment(cycle, j, p, load):
    """Before cycle 2 one Deployment vanishes and leaves its VA behind
    (orphaned), another is deleted and takes its VA with it (owner
    reference garbage collection)."""
    if cycle == 2:
        for b in (j, p):
            name, ns = rc.va_key(5, BASE)
            del b.kube.deployments[(ns, name)]
            b.kube.delete_deployment(*rc.va_key(77, BASE))


def _scoped(cycle, j, p, load):
    """Cycles 3 and 5 are scoped micro-cycles over 24 variants; on cycle
    5 two of them get a streamed load."""
    if cycle not in (3, 5):
        return None
    keys = [":".join(rc.va_key(i, BASE)) for i in range(0, 96, 4)]
    if cycle == 3:
        return keys, None, None
    streamed = {}
    for pkg, b in (("j", j), ("p", p)):
        CollectedLoad = b.mods["col"].CollectedLoad
        streamed[pkg] = {k: CollectedLoad(
            arrival_rate_rpm=600.0 + 60.0 * n, avg_input_tokens=256.0,
            avg_output_tokens=128.0, avg_ttft_ms=90.0, avg_itl_ms=12.0)
            for n, k in enumerate(keys[:2])}
    return keys, streamed["j"], streamed["p"]


CASES = {
    "hier-on-small-fleet": dict(c=Cluster(
        variants=64, models=16, percentile=0.95,
        operator=(("WVA_HIER_SOLVE", "on"),
                  ("WVA_HIER_SHARD_VARIANTS", "16")))),
    "prometheus-error-stale-cache": dict(c=BASE, before=_failing),
    "scale-down-stabilization": dict(c=Cluster(
        operator=(("WVA_SCALE_DOWN_STABILIZATION", "150s"),)),
        downward=True),
    "missing-deployment": dict(c=BASE, before=_missing_deployment),
    "scoped-cycles": dict(c=BASE, before=_scoped),
}


def _shards(p, results):
    """The forced hierarchical engine split the fleet into shards."""
    engine = p.rec._solve_engine_obj
    assert type(engine).__name__ == "HierarchicalSolveEngine"
    assert engine.last_partition.n_shards > 1


def _held_and_stale(p, results):
    assert any(r.degraded for r in results)


def _clamped(p, results):
    """The window held some scale-downs (a stabilization clamp)."""
    assert any(c.name == "stabilization-window" and c.after > c.before
               for rec in p.rec.decisions.records() for c in rec.clamps)


def _skipped_missing(p, results):
    assert results[-1].skipped == {
        ":".join(rc.va_key(5, BASE)): "deployment not found"}


def _scoped_ran(p, results):
    assert len(results[2].processed) == 24
    assert len(results[3].processed) == BASE.variants


CHECKS = {"hier-on-small-fleet": _shards,
          "prometheus-error-stale-cache": _held_and_stale,
          "scale-down-stabilization": _clamped,
          "missing-deployment": _skipped_missing,
          "scoped-cycles": _scoped_ran}


@pytest.mark.parametrize("case", list(CASES))
def test_ladder_cycles_equal_reference_float64(case, monkeypatch):
    spec = CASES[case]
    _j, p, results = drive(spec["c"], monkeypatch, before=spec.get("before"),
                           downward=spec.get("downward", False))
    assert p.rec.state.cycle_index == CYCLES
    CHECKS[case](p, results)


def test_prometheus_error_reaches_the_ladder(monkeypatch):
    """The failing groups' variants sit on the HOLD rung without a cache
    and on the stale-cache rung with one, in both packages (the parity
    above holds them equal; this pins that the rungs are reached)."""
    seen = {"hold": 0, "stale-cache": 0}
    _j, p, _results = drive(BASE, monkeypatch, before=_failing, cycles=4)
    for rec in p.rec.decisions.records():
        if rec.inputs.degradation in seen:
            seen[rec.inputs.degradation] += 1
    assert seen["hold"] > 0 and seen["stale-cache"] > 0
