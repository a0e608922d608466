"""The port's publish stage writes each VA's status on the cycle's own
object: the copy from this cycle's LIST, or in a scoped micro-cycle the
streaming snapshot's working copy. No GET precedes a status write.

On a small cluster (tests/reconcile_cluster.py) with the port's
`InMemoryKube` wrapped to count verbs: a full pass and a micro-cycle
send no per-VA GET and one status write per published VA (and the full
pass after them no LIST: tests/test_torch_va_cache.py), and publish
what the JAX package's `Reconciler` publishes, field by field; a status
write that meets a stale resourceVersion is retried with the cycle's
status and counted on `inferno_status_write_conflicts_total`; the
scaling-decision counter counts each published change once, through
the HOLD and stale-cache paths, as the JAX package's does; and the
streaming snapshot holds the written objects at the stored
resourceVersion.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster
from test_torch_reconciler import drive

SMALL = Cluster(variants=16, models=4, namespaces=2)
CONFLICTS = "inferno_status_write_conflicts_total"
SCALING = "inferno_replica_scaling_total"


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def count_verbs(kube) -> dict:
    """Wrap the VA verbs of `kube` in place; returns the live counts."""
    counts: dict = {}
    for verb in ("list_variant_autoscalings", "get_variant_autoscaling",
                 "update_variant_autoscaling_status"):
        orig = getattr(kube, verb)

        def counted(*a, _orig=orig, _verb=verb, **kw):
            counts[_verb] = counts.get(_verb, 0) + 1
            return _orig(*a, **kw)

        setattr(kube, verb, counted)
    return counts


def statuses(b, c: Cluster) -> dict:
    """(name, namespace) -> the stored status as plain data: current and
    desired allocation, actuation, conditions (every field)."""
    out = {}
    for i in range(c.variants):
        name, ns = rc.va_key(i, c)
        va = b.kube.vas[(ns, name)]
        out[(name, ns)] = dataclasses.asdict(va.status)
    return out


def pair(c: Cluster, clock: rc.Clock, load: dict):
    j = rc.build(JAX, c, clock, copy.deepcopy(load))
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=torch.float64)
    return j, p


def scoped_keys(c: Cluster, model: str) -> list:
    return [":".join(rc.va_key(i, c)) for i in range(c.variants)
            if rc.model_of(i, c) == model]


def conflicts(b) -> float:
    return b.emitter.value(CONFLICTS) or 0.0


def test_full_pass_and_micro_cycle_send_no_per_va_get():
    c = SMALL
    clock = rc.Clock()
    load = rc.loads(c)
    j, p = pair(c, clock, load)
    counts = count_verbs(p.kube)
    j.rec.reconcile()
    res = p.rec.reconcile()
    assert len(res.processed) == c.variants
    assert counts == {"list_variant_autoscalings": 1,
                      "update_variant_autoscaling_status": c.variants}
    assert statuses(p, c) == statuses(j, c)

    clock.advance(60.0)
    rc.churn(load, 1.0, np.random.default_rng(3))
    rc.set_loads(j, load)
    rc.set_loads(p, load)
    counts.clear()
    keys = scoped_keys(c, "m1")
    j.rec.reconcile(scope=keys)
    res = p.rec.reconcile(scope=keys)
    assert sorted(res.processed) == sorted(keys)
    assert counts == {"update_variant_autoscaling_status": len(keys)}
    assert statuses(p, c) == statuses(j, c)

    # the next full pass reads the VAs from the cache the watch events
    # keep: the micro-cycle's own writes cost it no LIST and no GET
    clock.advance(60.0)
    rc.churn(load, 1.0, np.random.default_rng(4))
    rc.set_loads(j, load)
    rc.set_loads(p, load)
    counts.clear()
    j.rec.reconcile()
    res = p.rec.reconcile()
    assert len(res.processed) == c.variants
    assert counts == {"update_variant_autoscaling_status": c.variants}
    assert statuses(p, c) == statuses(j, c)
    assert conflicts(p) == 0.0


def test_stale_copy_is_retried_with_the_cycles_status():
    """An outside writer updates one VA between the cycle's LIST and its
    status write (the wrapper writes the stored object back, bumping its
    resourceVersion, before the first status write for it). The write
    is refused, retried on the refreshed resourceVersion, and lands the
    status a cycle without the writer publishes."""
    c = SMALL
    clock = rc.Clock()
    load = rc.loads(c)
    clean, p = (rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                         dtype=torch.float64) for _ in range(2))
    target = rc.va_key(5, c)
    written = []
    orig = p.kube.update_variant_autoscaling_status

    def update(va):
        if (va.name, va.namespace) == target and not written:
            other = p.kube.get_variant_autoscaling(*target)
            p.kube.put_variant_autoscaling(other)
            written.append(other.metadata.resource_version)
        return orig(va)

    p.kube.update_variant_autoscaling_status = update
    clean.rec.reconcile()
    p.rec.reconcile()
    assert written and conflicts(p) == 1.0
    assert statuses(p, c) == statuses(clean, c)
    name, ns = target
    stored = p.kube.vas[(ns, name)]
    assert int(stored.metadata.resource_version) > int(written[0])
    assert p.rec.state.snapshot.vas[f"{name}:{ns}"].metadata \
        .resource_version == stored.metadata.resource_version

    clock.advance(60.0)
    rc.churn(load, 1.0, np.random.default_rng(5))
    for b in (clean, p):
        rc.set_loads(b, load)
        b.rec.reconcile()
    assert conflicts(p) == 1.0
    assert statuses(p, c) == statuses(clean, c)


def _hold_then_stale(cycle, j, p, load):
    """Cycle 1: one group fails with no cache (its VAs HOLD); cycle 3:
    another group fails and is sized on the stale cache."""
    keys = sorted(load)
    failing = ((keys[0],) if cycle == 1 else ()) \
        + ((keys[1],) if cycle == 3 else ())
    rc.set_loads(j, load, failing)
    rc.set_loads(p, load, failing)


def test_scaling_counter_counts_each_published_change_once(monkeypatch):
    """Four cycles with every group's load changing: the scaling-decision
    counter and the DecisionRecords equal the JAX package's (drive()
    holds them equal every cycle), and each VA's count is the number of
    changes of its stored desired replicas, the HOLD and stale-cache
    cycles included."""
    c = SMALL
    history: dict = {}

    def before(cycle, j, p, load):
        _hold_then_stale(cycle, j, p, load)
        for key, st in statuses(p, c).items():
            history.setdefault(key, []).append(
                st["desired_optimized_alloc"]["num_replicas"])

    _j, p, results = drive(c, monkeypatch, cycles=4, before=before,
                           share=1.0)
    assert results[0].degraded and set(results[0].degraded.values()) \
        == {"hold"}
    assert "stale-cache" in set(results[2].degraded.values())
    for key, st in statuses(p, c).items():
        history[key].append(st["desired_optimized_alloc"]["num_replicas"])
    counted = {}
    for (series, labels), v in rc.samples(p.emitter, (SCALING,)).items():
        lab = dict(labels)
        key = (lab["variant_name"], lab["namespace"])
        counted[key] = counted.get(key, 0) + v
    changes = {key: sum(a != b for a, b in zip(h, h[1:]))
               for key, h in history.items()}
    assert sum(changes.values()) > c.variants
    assert {k: v for k, v in counted.items() if v} \
        == {k: v for k, v in changes.items() if v}


def test_snapshot_holds_the_written_objects():
    """After a full pass the streaming snapshot's VAs are the objects the
    cycle wrote, at the stored resourceVersion and status; the next
    micro-cycle publishes with no GET and no conflict."""
    c = SMALL
    clock = rc.Clock()
    load = rc.loads(c)
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=torch.float64)
    p.rec.reconcile()
    snap = p.rec.state.snapshot
    assert len(snap.vas) == c.variants
    for key, va in snap.vas.items():
        stored = p.kube.vas[(va.namespace, va.name)]
        assert va.metadata.resource_version \
            == stored.metadata.resource_version
        assert va.status == stored.status, key
        assert p.rec._cycle_condition_vas[key] is va

    counts = count_verbs(p.kube)
    clock.advance(60.0)
    keys = scoped_keys(c, "m2")
    res = p.rec.reconcile(scope=keys)
    assert sorted(res.processed) == sorted(keys)
    assert counts == {"update_variant_autoscaling_status": len(keys)}
    assert conflicts(p) == 0.0
    for key in keys:
        va = snap.vas[key]
        assert va.metadata.resource_version \
            == p.kube.vas[(va.namespace, va.name)].metadata.resource_version
