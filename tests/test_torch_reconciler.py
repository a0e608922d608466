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


def test_ensure_stream_core_shares_the_reconcilers_state():
    """`ensure_stream_core` attaches one `StreamCore` (the port's own
    class), built over the reconciler's `StreamState`, and hands back
    the same core on every call."""
    from workload_variant_autoscaler_tpu_torch.stream import StreamCore

    b = rc.modules(PORT)
    ctl = b["ctl"]
    rec = ctl.Reconciler(kube=ctl.InMemoryKube(),
                         prom=b["col"].FakePromAPI(), device="cpu")
    core = rec.ensure_stream_core()
    assert isinstance(core, StreamCore)
    assert core.state is rec.state and core.rec is rec
    assert rec.stream_core is core and rec.ensure_stream_core() is core


def test_run_forever_polls_with_the_stream_off(monkeypatch):
    """`run_forever` with WVA_STREAM=off runs the polled loop: a cycle,
    then the requeue wait, until `stop` is set; no streaming core is
    attached."""
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
    assert p.rec.stream_core is None


def test_run_forever_with_the_stream_on_runs_micro_cycles(monkeypatch):
    """With WVA_STREAM on (the default) `run_forever` hands the loop to
    the streaming core: the backstop full pass first, then a pushed
    load change of one model drives a scoped micro-cycle over exactly
    that model's VAs."""
    import threading
    import time

    from workload_variant_autoscaler_tpu_torch.collector import CollectedLoad

    monkeypatch.delenv("WVA_STREAM", raising=False)
    c = Cluster(variants=8, models=4, namespaces=1)
    p = rc.build(PORT, c, rc.Clock(), rc.loads(c), device="cpu",
                 dtype=torch.float64)
    calls = []
    orig = p.rec.reconcile

    def reconcile(**kw):
        res = orig(**kw)
        calls.append((kw.get("scope") is not None, sorted(res.processed)))
        return res

    monkeypatch.setattr(p.rec, "reconcile", reconcile)
    # the consumer paces itself on the reconciler's monotonic clock: a
    # real one here, so the debounce window closes
    p.rec.monotonic = time.monotonic
    stop = threading.Event()
    t = threading.Thread(target=p.rec.run_forever, args=(stop, False),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
        assert calls and calls[0] == (False, sorted(
            "{}:{}".format(*rc.va_key(i, c)) for i in range(c.variants)))
        core = p.rec.stream_core
        assert core is not None
        assert core.observe_load("m1", "ns0", CollectedLoad(
            arrival_rate_rpm=9600.0, avg_input_tokens=128.0,
            avg_output_tokens=128.0, avg_ttft_ms=200.0, avg_itl_ms=12.0))
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        p.rec.kick()
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert calls[1] == (True, sorted(
        "{}:{}".format(*rc.va_key(i, c)) for i in range(c.variants)
        if rc.model_of(i, c) == "m1"))
    assert core.failures == {"cycle": 0, "consumer": 0,
                             "checkpoint_save": 0}


# -- the flight recorder on the host clock -------------------------------------


def port_cycle(c: Cluster, monkeypatch=None, during=None):
    """One port cycle on the injected clock, which stands still while the
    cycle runs; `during()` runs inside the analyze stage, from the first
    sizing group's pack. Returns the build and the cycle's trace."""
    from workload_variant_autoscaler_tpu_torch.models import system as msys

    if during is not None:
        orig = msys.System._group_rows

        def rows(self, *a, **kw):
            during()
            return orig(self, *a, **kw)

        monkeypatch.setattr(msys.System, "_group_rows", rows)
    p = rc.build(PORT, c, rc.Clock(), rc.loads(c), device="cpu",
                 dtype=torch.float64)
    p.rec.reconcile()
    return p, p.rec.tracer.traces(1)[0]


def parent_name(trace, sp) -> str:
    return next(x.name for x in trace.spans if x.span_id == sp.parent_id)


def test_spans_on_an_injected_clock_last_host_time():
    """`now` stands still through the cycle; the spans still time the
    host's work, on the clock the stage marks read."""
    p, trace = port_cycle(Cluster(variants=16, models=4))
    assert trace.root.duration_ms > 0.0
    stages = [sp for sp in trace.spans if sp.name.startswith("stage:")]
    assert len(stages) == 5
    for sp in stages:
        mark = p.emitter.value("inferno_reconcile_stage_duration_msec",
                               stage=sp.name.removeprefix("stage:"))
        assert abs(sp.duration_ms - mark) <= 1.0, sp.name


def test_sizing_groups_open_pack_and_decide_spans(monkeypatch):
    """Each sizing group (here a mean and a p95 group) opens one
    `system.pack` and one `system.decide` under stage:analyze, and the
    ledger has a bucket for each."""
    from workload_variant_autoscaler_tpu_torch.models import system as msys

    groups = []
    orig = msys.System._size_group_fused

    def spy(self, pairs, *a, **kw):
        groups.append(len(pairs))
        return orig(self, pairs, *a, **kw)

    monkeypatch.setattr(msys.System, "_size_group_fused", spy)
    c = Cluster(variants=16, models=4, percentile=0.95)
    p, trace = port_cycle(c)
    assert len(groups) == 2
    for name in ("system.pack", "system.decide"):
        spans = trace.find_spans(name)
        assert len(spans) == len(groups), name
        assert {parent_name(trace, sp) for sp in spans} == {"stage:analyze"}
        assert all(sp.duration_ms > 0.0 for sp in spans)
    assert sorted(sp.attributes["lanes"]
                  for sp in trace.find_spans("system.pack")) == sorted(groups)
    buckets = p.rec.profiler.records(1)[0].buckets
    assert buckets["system.pack"] > 0.0 and buckets["system.decide"] > 0.0


def test_gc_in_a_cycle_is_a_gc_span(monkeypatch):
    """A gen-2 collection inside a traced cycle: a finished `gc` span
    under the span it interrupted, a `gc` bucket in the ledger, and
    inferno_gc_pause_seconds_total{generation="2"} up by its length."""
    import gc

    p, trace = port_cycle(Cluster(variants=16, models=4), monkeypatch,
                          during=gc.collect)
    spans = trace.find_spans("gc")
    assert spans and {parent_name(trace, sp) for sp in spans} \
        == {"system.pack"}
    paused = sum(sp.duration_ms for sp in spans)
    assert paused > 0.0
    assert p.rec.profiler.records(1)[0].buckets["gc"] \
        == pytest.approx(paused, rel=1e-9)
    assert p.emitter.value("inferno_gc_pause_seconds_total",
                           generation="2") * 1e3 >= paused


def test_gc_hook_installed_once_per_process():
    import gc

    from workload_variant_autoscaler_tpu_torch.obs import GC_AUDIT

    b = rc.modules(PORT)
    ctl = b["ctl"]
    for _ in range(3):
        ctl.Reconciler(kube=ctl.InMemoryKube(),
                       prom=b["col"].FakePromAPI(), device="cpu")
    assert GC_AUDIT.installed
    assert sum(cb == GC_AUDIT.hook for cb in gc.callbacks) == 1


def test_gc_hook_takes_no_lock():
    """A collection set off while its thread holds the tracer's lock,
    the emitter's and the GC counter's: the hook takes none of them, so
    gc.collect() returns."""
    import gc
    import threading

    b = rc.modules(PORT)
    ctl = b["ctl"]
    rec = ctl.Reconciler(kube=ctl.InMemoryKube(),
                         prom=b["col"].FakePromAPI(), device="cpu")
    counter = rec.emitter.gc_pause_seconds
    child = counter.labels(generation="2")
    locks = (rec.tracer._lock, rec.emitter._lock, counter._lock,
             child._value._lock)
    done = threading.Event()

    def collect():
        root = rec.tracer.begin("reconcile")
        for lock in locks:
            lock.acquire()
        try:
            gc.collect()
            done.set()
        finally:
            for lock in reversed(locks):
                lock.release()
            root.finish()

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive() and done.is_set()
