"""The 4096-VA fleet's churn cell through the hierarchical engine, held
against the benchmark's plain reference on the CPU.

The cell (`va4096-s2` x `churn2`) is run as `BENCHMARK.json` and the
files under `benchmark/` give it, but for its fleet, which is cut
to 64 VAs over 8 models and 8 namespaces, and the engine's floor and
shard size (`WVA_HIER_MIN_VARIANTS` 32, `WVA_HIER_SHARD_VARIANTS` 16)
are cut with it, so that every cycle takes the two-level path over 4
super-shards as the 4096-VA fleet does at the defaults. The harness's judge
(`benchmark/loops/polled.py judge`) holds every VA of every window cycle
to the float64 reference (`benchmark/reference/`), which knows nothing
of shards or of cached lanes. A planted fault that drops one solved
shard's lanes, so that they keep the decisions cached for them, reads
as not correct.
"""

import os
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.run import run_cell

CELL = "va4096-churn"
SMALL = {"variants": 64, "models": 8, "namespaces": 8}
ENGINE_ENV = {"WVA_HIER_MIN_VARIANTS": "32", "WVA_HIER_SHARD_VARIANTS": "16"}
RECONCILER = "workload_variant_autoscaler_tpu_torch.controller.reconciler"
GAUGES = ("inferno_hier_shards", "inferno_hier_shards_solved")


@pytest.fixture(autouse=True)
def cell_env():
    """The engine's knobs for the small fleet; the environment as it was
    afterwards (`harness.apply_env` writes the cell's settings into
    os.environ)."""
    saved = dict(os.environ)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    os.environ.update(ENGINE_ENV)
    yield
    torch.set_num_threads(threads)
    os.environ.clear()
    os.environ.update(saved)


def with_dtype(monkeypatch, dtype: str) -> None:
    """Run the cell's controller in `dtype` (its file states float32)."""
    resolve = spec.resolve

    def resolve_(name, *a, **kw):
        cell = resolve(name, *a, **kw)
        cell.config["controller"]["dtype"] = dtype
        return cell

    monkeypatch.setattr(spec, "resolve", resolve_)


def watch_cycles(monkeypatch) -> list:
    """After each of the Reconciler's cycles, its hierarchical gauges and
    the lanes it solved, read from its emitter."""
    seen: list = []
    watch = harness.Probes.watch

    def watch_(probes, rec):
        watch(probes, rec)
        inner = rec.reconcile

        def reconcile(*a, **kw):
            try:
                return inner(*a, **kw)
            finally:
                row = {}
                for metric in rec.emitter.registry.collect():
                    for s in metric.samples:
                        if s.name in GAUGES:
                            row[s.name] = s.value
                        elif s.name == "inferno_solve_lanes" \
                                and s.labels.get("state") == "solved":
                            row["lanes_solved"] = s.value
                seen.append(row)

        rec.reconcile = reconcile

    monkeypatch.setattr(harness.Probes, "watch", watch_)
    return seen


def run(faults=None):
    return run_cell(CELL, 2**31 + 19, 2.0, False, device="cpu",
                    t_start=time.perf_counter(), deployment=SMALL,
                    faults=faults)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hierarchical_cycles_match_the_reference(dtype, monkeypatch):
    with_dtype(monkeypatch, dtype)
    seen = watch_cycles(monkeypatch)
    res, lines = run()
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] >= 1, lines
    window = seen[-res["attempted"]:]
    assert all(row["inferno_hier_shards"] == 4 for row in seen), seen
    assert all(0 < row["inferno_hier_shards_solved"] <= 4
               for row in window), window
    lanes = [row["lanes_solved"] for row in window]
    assert sum(lanes) / len(lanes) < SMALL["variants"], lanes


def drop_a_solved_shard(engine_cls):
    """The hierarchical engine with its first solved shard of each cycle
    left out of the solve, once every lane of that shard has a cached
    decision: the shard's changed lanes keep the decisions cached for
    them, as if `by_shard` had lost the shard."""

    class Dropping(engine_cls):
        def _calculate_hier(self, system, **kw):
            engine, real, dropped = self, system.calculate, []

            def calculate(*a, only=None, **k):
                if only and not dropped \
                        and all(n in engine._alloc_cache for n in only):
                    dropped.append(only)
                    for name in only:
                        engine._restore(system, system.servers[name],
                                        engine._alloc_cache[name])
                    return real(*a, only=set(), **k)
                return real(*a, only=only, **k)

            system.calculate = calculate
            try:
                return super()._calculate_hier(system, **kw)
            finally:
                del system.calculate

    return Dropping


def test_a_dropped_shard_is_not_correct():
    res, lines = run(faults={(RECONCILER, "HierarchicalSolveEngine"):
                             drop_a_solved_shard})
    assert res["correct"] is False, lines
    assert res["checks"]["decisions_outside"]["value"] > 0, lines
