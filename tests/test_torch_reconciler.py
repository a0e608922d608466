"""The port's reconcile cycle against the JAX package's, on one cluster.

`controller/reconciler.py` `Reconciler.reconcile()` of the port and of
the JAX package run side by side on the same cluster (tests/
reconcile_cluster.py builds it through either package's modules), the
same injected clock and the same loads, changing from cycle to cycle.
After every cycle, for every VA:

- the published status: desired (accelerator, replicas), the current
  allocation's max batch, the conditions (type, status, reason);
- the solution each VA was published from (accelerator, replicas,
  batch exact; cost, ITL, TTFT within rel 1e-9 in float64);
- the emitter's samples of the decision series (counts exact, power
  within rel 1e-9 in float64);
- the cycle's DecisionRecords (every field but the random trace id);
- `ReconcileResult.processed`, `.skipped`, `.degraded`, `.error`.

The JAX side runs its batched XLA backend in float64 (the test conftest
enables x64; WVA_NATIVE_KERNEL=false pins the backend a CPU-only host
would otherwise auto-select). The port runs `device="cpu"` (its
"batched" backend) in float64, and in float32 for the decisions alone.
"""

import copy
import math

import numpy as np
import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster

RTOL = 1e-9
CYCLES = 6


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def spy_solutions(monkeypatch, pkg: str) -> dict:
    """Record, per VA key, the solution entry each publish was made from
    (the published batch and the float telemetry live there)."""
    import importlib

    translate = importlib.import_module(pkg + ".controller.translate")
    seen: dict = {}
    orig = translate.create_optimized_alloc

    def spy(name, namespace, solution, now=None):
        alloc = orig(name, namespace, solution, now=now)
        data = solution.allocations[f"{name}:{namespace}"]
        seen[(name, namespace)] = (data.accelerator, data.num_replicas,
                                   data.max_batch, data.cost,
                                   data.itl_average, data.ttft_average)
        return alloc

    monkeypatch.setattr(translate, "create_optimized_alloc", spy)
    return seen


def close(a: float, b: float) -> bool:
    return a == b or math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0)


def assert_same_cycle(c: Cluster, j, p, rj, rp, sol_j, sol_p, cycle: int,
                      floats: bool) -> None:
    assert rp.processed == rj.processed
    assert rp.skipped == rj.skipped
    assert rp.degraded == rj.degraded
    assert rp.error == rj.error
    assert rp.requeue_after == rj.requeue_after
    assert rc.published(p, c) == rc.published(j, c)
    assert sol_p.keys() == sol_j.keys()
    for key, a in sol_j.items():
        b = sol_p[key]
        assert b[:3] == a[:3], key
        if floats:
            assert all(close(x, y) for x, y in zip(a[3:], b[3:])), (key, a, b)
    sj, sp = rc.samples(j.emitter), rc.samples(p.emitter)
    assert sp.keys() == sj.keys()
    for key, v in sj.items():
        if key[0] == "inferno_variant_power_watts":
            if floats:
                assert close(v, sp[key]), key
        else:
            assert sp[key] == v, key
    dj, dp = rc.decision_records(j, cycle), rc.decision_records(p, cycle)
    assert dp.keys() == dj.keys()
    for key, a in dj.items():
        assert dp[key] == a, key


def drive(c: Cluster, monkeypatch, dtype=torch.float64, cycles=CYCLES,
          before=None, share=0.1, downward=False):
    """Run both reconcilers for `cycles` cycles, 60 s apart, with about
    `share` of the load groups changing after each; `before(cycle, j,
    p, load)` may alter the cluster before a cycle (and return a scope
    for a scoped cycle). Returns both builds and the port's results."""
    clock = rc.Clock()
    load = rc.loads(c)
    sol_j = spy_solutions(monkeypatch, JAX)
    sol_p = spy_solutions(monkeypatch, PORT)
    j = rc.build(JAX, c, clock, copy.deepcopy(load))
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=dtype)
    rng = np.random.default_rng(c.seed + 7)
    results = []
    for cycle in range(1, cycles + 1):
        scope = before(cycle, j, p, load) if before is not None else None
        for b in (j, p):
            if b.plan is not None:
                b.plan.begin_cycle()
        sol_j.clear()
        sol_p.clear()
        if scope is None:
            rj, rp = j.rec.reconcile(), p.rec.reconcile()
        else:
            rj = j.rec.reconcile(scope=scope[0], stream_loads=scope[1])
            rp = p.rec.reconcile(scope=scope[0], stream_loads=scope[2])
        assert_same_cycle(c, j, p, rj, rp, sol_j, sol_p,
                          j.rec.state.cycle_index,
                          floats=dtype == torch.float64)
        results.append(rp)
        clock.advance(60.0)
        rc.churn(load, share, rng)
        if downward:
            for v in load.values():
                v["rps"] *= 0.7
        rc.set_loads(j, load)
        rc.set_loads(p, load)
    return j, p, results


BASE = Cluster()


CASES = {
    "mean": dict(c=BASE),
    "p95-class": dict(c=Cluster(percentile=0.95)),
    # about 60% of the chips the unlimited solution takes
    "limited-nodes": dict(c=Cluster(nodes=(("v5e", 384), ("v5e", 256)))),
    "incremental-off": dict(c=Cluster(
        operator=(("WVA_INCREMENTAL_SOLVE", "off"),))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reconcile_equals_reference_float64(case, monkeypatch):
    spec = CASES[case]
    _j, p, _results = drive(spec["c"], monkeypatch)
    # every case must have published something and sized on the port
    assert p.rec.state.cycle_index == CYCLES
    assert any(k[0] == "inferno_desired_replicas"
               for k in rc.samples(p.emitter))


@pytest.mark.parametrize("case", ["mean", "p95-class", "limited-nodes"])
def test_reconcile_decisions_equal_reference_float32(case, monkeypatch):
    spec = CASES[case]
    drive(spec["c"], monkeypatch, dtype=torch.float32, cycles=3)


def test_cycle_trace_holds_the_solver_span(monkeypatch):
    """The port's optimize stage carries the `solver.solve` span with the
    JAX trace's attributes (unlimited, warm, servers)."""
    j, p, _results = drive(BASE, monkeypatch, cycles=2)

    def solver_spans(b):
        out = []
        for trace in b.rec.tracer.traces():
            for sp in trace.spans:
                if sp.name == "solver.solve":
                    attrs = dict(sp.attributes)
                    attrs.pop("solution_time_msec")
                    parent = next(x for x in trace.spans
                                  if x.span_id == sp.parent_id)
                    out.append((parent.name, attrs))
        return out

    assert solver_spans(p) == solver_spans(j)
    assert solver_spans(p) and all(parent == "stage:optimize"
                                   for parent, _ in solver_spans(p))


def test_reconciler_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = rc.modules(PORT)
    ctl = b["ctl"]
    with pytest.raises(RuntimeError, match="cuda"):
        ctl.Reconciler(kube=ctl.InMemoryKube(),
                       prom=b["col"].FakePromAPI())


def test_cycle_builds_its_system_on_the_reconcilers_device(monkeypatch):
    """`device`/`dtype` reach the System every cycle builds and, through
    it, the engine's arena packs."""
    from workload_variant_autoscaler_tpu_torch.models import system as msys

    made = []
    orig = msys.System.__init__

    def init(self, device=None, dtype=None):
        orig(self, device=device, dtype=dtype)
        made.append((self.device, self.dtype))

    monkeypatch.setattr(msys.System, "__init__", init)
    c = Cluster(variants=16, models=4)
    clock = rc.Clock()
    p = rc.build(PORT, c, clock, rc.loads(c), device="cpu",
                 dtype=torch.float64)
    p.rec.reconcile()
    assert made == [(torch.device("cpu"), torch.float64)]


def test_stream_core_is_not_ported_yet():
    b = rc.modules(PORT)
    ctl = b["ctl"]
    rec = ctl.Reconciler(kube=ctl.InMemoryKube(),
                         prom=b["col"].FakePromAPI(), device="cpu")
    with pytest.raises(NotImplementedError, match="WVA_STREAM=off"):
        rec.ensure_stream_core()


def test_run_forever_polls_with_the_stream_off(monkeypatch):
    """`run_forever` with WVA_STREAM=off runs the polled loop: a cycle,
    then the requeue wait, until `stop` is set; with the stream on (the
    default) it asks for the streaming core, which is not ported yet."""
    import threading

    c = Cluster(variants=8, models=4)
    p = rc.build(PORT, c, rc.Clock(), rc.loads(c), device="cpu",
                 dtype=torch.float64)
    stop = threading.Event()
    results = []
    orig = p.rec.reconcile

    def reconcile():
        results.append(orig())
        stop.set()
        return results[-1]

    monkeypatch.setattr(p.rec, "reconcile", reconcile)
    monkeypatch.setenv("WVA_STREAM", "off")
    p.rec.run_forever(stop, watch=False)
    assert len(results) == 1 and len(results[0].processed) == c.variants
    monkeypatch.delenv("WVA_STREAM")
    with pytest.raises(NotImplementedError):
        p.rec.run_forever(threading.Event(), watch=False)
