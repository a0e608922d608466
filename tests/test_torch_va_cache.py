"""The port's full pass reads its VariantAutoscalings from the cache the
watch events keep current (controller/va_cache.py), where the JAX
package LISTs the fleet every pass.

On a small cluster (tests/reconcile_cluster.py), both reconcilers run
three full passes 60 s apart with every group's load changing
(tests/test_torch_reconciler.py `drive`, which holds every cycle's
published statuses, solutions, series and DecisionRecords equal), with
one change made through the API between the first and the second pass.
The port's `InMemoryKube` counts its VA verbs: after the first pass a
full pass sends no LIST, and one GET for each VA a foreign write, an
addition or a deletion touched; a watch-drop window, a status write that
failed and a client with no watch source fall back to what the JAX
package does. WVA_FLEET_COLLECTION=off sends the JAX package down its
per-variant path; the port has one path, reads no such knob and sends
what it sends by default. Besides: the own-write filter under
the publish fan-out, the resourceVersion echo test that serves RestKube's
asynchronous events, RestKube's gap reports, and two full passes through
RestKube's VA verbs whose second sends only its status writes.
"""

import copy
import importlib
import sys
import threading
import time

import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import PORT, Cluster
from test_torch_publish import count_verbs
from test_torch_reconciler import drive

SMALL = dict(variants=16, models=4, namespaces=2)
TARGET = 5
LIST, GET = "list_variant_autoscalings", "get_variant_autoscaling"
READS = "inferno_va_reads_total"
REFETCHES = "inferno_va_refetches_total"


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    monkeypatch.delenv("WVA_FLEET_COLLECTION", raising=False)
    torch.set_num_threads(1)


def _rewrite(j, p, c, edit) -> None:
    """A foreign writer's GET, edit and PUT of VA TARGET, on both."""
    for b in (j, p):
        va = b.kube.get_variant_autoscaling(*rc.va_key(TARGET, c))
        edit(va, b.mods["ctl"].crd)
        b.kube.put_variant_autoscaling(va)


def spec_write(j, p, c) -> None:
    def edit(va, crd):
        other = ("freemium" if va.spec.slo_class_ref.key == "premium"
                 else "premium")
        va.spec.slo_class_ref = crd.ConfigMapKeyRef(
            name=va.spec.slo_class_ref.name, key=other)
    _rewrite(j, p, c, edit)


def label_write(j, p, c) -> None:
    def edit(va, crd):
        va.metadata.labels[crd.ACCELERATOR_LABEL] = \
            rc.SHAPES[(TARGET + 1) % c.profiles][0]
    _rewrite(j, p, c, edit)


def add_va(j, p, c) -> None:
    for b in (j, p):
        ctl = b.mods["ctl"]
        src = b.kube.get_variant_autoscaling(*rc.va_key(TARGET, c))
        name, ns = "v-added", src.namespace
        b.kube.put_deployment(ctl.Deployment(
            name=name, namespace=ns, spec_replicas=2, status_replicas=2))
        b.kube.put_variant_autoscaling(ctl.crd.VariantAutoscaling(
            metadata=ctl.crd.ObjectMeta(
                name=name, namespace=ns,
                labels=dict(src.metadata.labels)),
            spec=copy.deepcopy(src.spec)))


def delete_va(j, p, c) -> None:
    # the first pass made TARGET's Deployment its owner: the VA goes too
    for b in (j, p):
        b.kube.delete_deployment(*rc.va_key(TARGET, c))


def fail_write(j, p, c) -> None:
    """VA TARGET's status write in the second pass is refused (422)."""
    target = rc.va_key(TARGET, c)
    for b in (j, p):
        orig = b.kube.update_variant_autoscaling_status
        invalid = b.mods["kube"].InvalidError

        def update(va, _orig=orig, _invalid=invalid, _b=b):
            if (va.name, va.namespace) == target:
                _b.kube.update_variant_autoscaling_status = _orig
                raise _invalid("admission refused")
            return _orig(va)

        b.kube.update_variant_autoscaling_status = update


class NoWatch:
    """A client with every verb of `kube` and no watch source."""

    def __init__(self, kube):
        self._kube = kube

    def __getattr__(self, name):
        if name in ("add_watch_listener", "add_gap_listener"):
            raise AttributeError(name)
        return getattr(self._kube, name)


def no_watch_source(j, p, c) -> None:
    cache_mod = importlib.import_module(PORT + ".controller.va_cache")
    p.rec.va_cache = cache_mod.VACache()
    assert not p.rec.va_cache.attach(NoWatch(p.kube))


N = SMALL["variants"]
# case: (cluster extras, change, the pass it precedes, the port's
# (LISTs, GETs) in passes 1-3, full passes read from the cache)
CASES = {
    "shift": ({}, None, 2, [(1, 0), (0, 0), (0, 0)], 2),
    "spec-write": ({}, spec_write, 2, [(1, 0), (0, 1), (0, 0)], 2),
    "label-write": ({}, label_write, 2, [(1, 0), (0, 1), (0, 0)], 2),
    "added": ({}, add_va, 2, [(1, 0), (0, 1), (0, 0)], 2),
    "deleted": ({}, delete_va, 2, [(1, 0), (0, 1), (0, 0)], 2),
    # the window swallows the first pass's events and the foreign write
    "watch-drop": ({"faults": (dict(kind="watch-drop", after_cycle=1,
                                    until_cycle=2),)},
                   spec_write, 2, [(1, 0), (1, 0), (0, 0)], 1),
    "failed-write": ({}, fail_write, 2, [(1, 0), (0, 0), (0, 1)], 2),
    # the JAX package's per-variant path; the port's one path
    "fleet-collection-off": (
        {"operator": (("WVA_FLEET_COLLECTION", "off"),)}, None, 2,
        [(1, 0), (0, 0), (0, 0)], 2),
    "no-watch-source": ({}, no_watch_source, 1,
                        [(1, 0), (1, 0), (1, 0)], 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_pass_reads_the_cache_and_publishes_as_the_reference(
        case, monkeypatch):
    extra, make_change, at, want, from_cache = CASES[case]
    c = Cluster(**SMALL, **extra)
    counts: list = []
    if case == "fleet-collection-off":
        # each records the path it collected on: the records are held
        # equal without it
        records = rc.decision_records

        def without_mode(b, cycle):
            out = records(b, cycle)
            for d in out.values():
                mode = d["inputs"].pop("collection_mode")
                assert mode == ("fleet" if b.pkg == PORT else "legacy")
            return out

        monkeypatch.setattr(rc, "decision_records", without_mode)

    def before(cycle, j, p, _load):
        if cycle == 1:
            # the port's VA verbs inside each reconcile
            live = count_verbs(p.kube)
            reconcile = p.rec.reconcile

            def counted(**kw):
                live.clear()
                try:
                    return reconcile(**kw)
                finally:
                    counts.append(dict(live))

            p.rec.reconcile = counted
        if make_change is not None and cycle == at:
            make_change(j, p, c)

    _j, p, results = drive(c, monkeypatch, cycles=3, before=before,
                           share=1.0)
    got = [(n.get(LIST, 0), n.get(GET, 0)) for n in counts]
    assert got == want
    for k, (n, res) in enumerate(zip(counts, results)):
        # one status write a processed VA; the refused one never reached
        # the counting wrapper
        refused = case == "failed-write" and k == 1
        assert n.get("update_variant_autoscaling_status", 0) \
            == len(res.processed) - refused
    if case == "added":
        assert "v-added:ns1" in results[1].processed
    if case == "deleted":
        assert ":".join(rc.va_key(TARGET, c)) not in results[1].processed
    assert (p.emitter.value(READS, source="cache") or 0) == from_cache
    assert (p.emitter.value(READS, source="list") or 0) == 3 - from_cache
    assert (p.emitter.value(REFETCHES) or 0) \
        == sum(g for _l, g in got if from_cache)


def test_own_writes_under_the_fanout_are_not_foreign():
    """Eight publish workers write every VA's status through
    `Reconciler._update_status` while another thread rewrites a third
    of the VAs, under a short switch interval: the next full pass
    re-reads exactly the VAs the other thread wrote."""
    c = Cluster(**SMALL)
    clock = rc.Clock()
    p = rc.build(PORT, c, clock, rc.loads(c), device="cpu",
                 dtype=torch.float64)
    p.rec.reconcile()
    vas = list(p.rec.state.snapshot.vas.values())
    foreign = [rc.va_key(i, c) for i in range(0, c.variants, 3)]
    fanout = importlib.import_module(PORT + ".utils.concurrency").fanout

    def other_writer():
        for name, ns in foreign:
            p.kube.put_variant_autoscaling(
                p.kube.get_variant_autoscaling(name, ns))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=other_writer)
        t.start()
        outcomes = fanout([lambda va=va: p.rec._update_status(va)
                           for va in vas], workers=8, label="apply")
        t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert all(err is None for _res, err in outcomes)
    got = []
    orig = p.kube.get_variant_autoscaling

    def get(name, ns):
        got.append((name, ns))
        return orig(name, ns)

    p.kube.get_variant_autoscaling = get
    clock.advance(60.0)
    p.rec.reconcile()
    assert sorted(got) == sorted(foreign)
    assert p.emitter.value(READS, source="cache") == 1.0


def _va(crd, name: str, rv: str):
    return crd.VariantAutoscaling(metadata=crd.ObjectMeta(
        name=name, namespace="ns", resource_version=rv))


def test_resource_version_tells_own_echoes_from_foreign_events():
    """Events that carry a resourceVersion (RestKube's watch): one equal
    to the cached object's is the echo of the controller's own write and
    costs no GET; another one, a deletion, or a key a conflict marked
    is re-read. Before the watch is pinned, and after it reports a gap,
    the cache serves no pass."""
    kube = importlib.import_module(PORT + ".controller.kube")
    crd = importlib.import_module(PORT + ".controller.crd")
    VACache = importlib.import_module(PORT + ".controller.va_cache").VACache
    cache = VACache()
    fleet = [_va(crd, n, "5") for n in "abcd"]
    cache.prime(fleet, cache.begin_list())
    assert cache.read(lambda key: None) is None      # not live yet
    cache.on_gap(True)                               # the watch is pinned
    cache.prime(fleet, cache.begin_list())
    cache.mark_dirty(fleet[3])          # d: a conflict met its write
    for etype, kind, name, rv in (
            ("MODIFIED", "VariantAutoscaling", "a", "5"),
            ("MODIFIED", "VariantAutoscaling", "b", "6"),
            ("DELETED", "VariantAutoscaling", "c", "5"),
            ("MODIFIED", "VariantAutoscaling", "d", "5"),
            ("MODIFIED", "ConfigMap", "a", "9")):
        cache.on_event(kube.WatchEvent(etype, kind, name, "ns", rv))
    gets = []

    def get(key):
        gets.append(key)
        if key[1] == "c":
            raise kube.NotFoundError("gone")
        return _va(crd, key[1], "7")

    out = cache.read(get)
    assert sorted(gets) == [("ns", "b"), ("ns", "c"), ("ns", "d")]
    assert [(va.name, va.metadata.resource_version) for va in out] \
        == [("a", "5"), ("b", "7"), ("d", "7")]
    assert out[0] is fleet[0]
    gets.clear()
    assert cache.read(get) == out and gets == []
    cache.on_gap(False)                              # the stream is lost
    assert cache.read(get) is None
    cache.on_gap(True)                               # re-pinned
    assert cache.read(get) is None                   # primed before the gap


def test_restkube_watch_reports_gaps_and_versions():
    """RestKube's VA watch carries each frame's resourceVersion on the
    event and reports a pin after every LIST, a gap when an ERROR frame
    forces a re-list, and the end of the loop."""
    from test_watch import WatchAPIServer, _va_event

    kube = importlib.import_module(PORT + ".controller.kube")
    server = WatchAPIServer(list_rv="5", watch_scripts=[
        [_va_event("ADDED", "a", "6"),
         {"type": "ERROR", "object": {"kind": "Status", "code": 410}}],
        [_va_event("MODIFIED", "a", "9")],
    ])
    try:
        client = kube.RestKube(base_url=server.url)
        events, gaps = [], []
        stop = threading.Event()

        def on_event(e):
            events.append(e)
            if len(events) == 2:
                stop.set()

        t = threading.Thread(
            target=client.watch_variant_autoscalings,
            args=(on_event, stop),
            kwargs={"timeout_seconds": 5, "on_gap": gaps.append},
            daemon=True)
        t.start()
        deadline = time.monotonic() + 15.0
        while not stop.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        stop.set()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert [(e.type, e.name, e.resource_version) for e in events] \
            == [("ADDED", "a", "6"), ("MODIFIED", "a", "9")]
        assert gaps == [True, False, True, False]
        assert server.list_count == 2
    finally:
        server.stop()


class WireVAs:
    """The cluster's `InMemoryKube`, with the VariantAutoscaling verbs
    spoken through RestKube's own code over a stand-in for the wire: each
    request is answered from the store as JSON, as an API server answers,
    and each write queues the watch event it raises, carrying the
    object's new resourceVersion, as RestKube's watch loop delivers it.
    No watch listener: the events arrive asynchronously, when the test
    hands them to the cache."""

    def __init__(self, mem, kube_mod):
        self._mem = mem
        self._kube_mod = kube_mod
        self.requests: list[tuple[str, str]] = []
        self.events: list = []
        rest = kube_mod.RestKube
        for verb in ("list_variant_autoscalings", "get_variant_autoscaling",
                     "update_variant_autoscaling_status",
                     "patch_owner_reference"):
            setattr(self, verb, getattr(rest, verb).__get__(self))

    def __getattr__(self, name):
        if name in ("add_watch_listener", "add_gap_listener"):
            raise AttributeError(name)
        return getattr(self._mem, name)

    def _request(self, method, path, body=None, content_type=None):
        km, mem = self._kube_mod, self._mem
        crd = importlib.import_module(PORT + ".controller.crd")
        self.requests.append((method, path))
        parts = path.split("/")
        if method == "GET" and "namespaces" not in parts:
            return {"items": [crd.va_to_dict(va)
                              for va in mem.list_variant_autoscalings()]}
        ns, name = parts[parts.index("namespaces") + 1], parts[-1]
        if method == "PUT":           # .../{name}/status
            name = parts[-2]
            mem.update_variant_autoscaling_status(crd.va_from_dict(body))
        elif method == "PATCH":
            ref = body["metadata"]["ownerReferences"][0]
            mem.patch_owner_reference(
                mem.get_variant_autoscaling(name, ns),
                km.Deployment(name=ref["name"], namespace=ns,
                              uid=ref["uid"]))
        stored = mem.get_variant_autoscaling(name, ns)
        if method != "GET":
            self.events.append(km.WatchEvent(
                "MODIFIED", "VariantAutoscaling", name, ns,
                stored.metadata.resource_version))
        return crd.va_to_dict(stored)


def test_restkube_second_full_pass_sends_no_patch_and_no_get():
    """Over RestKube, the first full pass LISTs, PATCHes each VA's
    ownerReference and writes each status; the watch echoes of those
    writes carry the versions the cached objects hold. The second pass
    then reads the cache, finds every VA owned already, and sends only
    its status writes: no LIST, no GET, no PATCH."""
    c = Cluster(**SMALL)
    clock = rc.Clock()
    p = rc.build(PORT, c, clock, rc.loads(c), device="cpu",
                 dtype=torch.float64)
    kube_mod = importlib.import_module(PORT + ".controller.kube")
    VACache = importlib.import_module(PORT + ".controller.va_cache").VACache
    wire = WireVAs(p.kube, kube_mod)
    p.rec.kube = wire
    cache = p.rec.va_cache = VACache()
    cache.on_gap(True)          # the VA watch's LIST has pinned the stream
    first = p.rec.reconcile()
    verbs = [m for m, _p in wire.requests]
    n = len(first.processed)
    assert n == c.variants
    assert (verbs.count("GET"), verbs.count("PATCH"), verbs.count("PUT")) \
        == (1, n, n)
    # the watch thread delivers the echoes after the writes returned
    t = threading.Thread(target=lambda: [cache.on_event(e)
                                         for e in wire.events])
    t.start()
    t.join(timeout=30.0)
    assert len(wire.events) == 2 * n
    wire.requests.clear()
    clock.advance(60.0)
    second = p.rec.reconcile()
    assert len(second.processed) == n
    assert [m for m, _p in wire.requests] == ["PUT"] * n
    assert p.emitter.value(READS, source="cache") == 1.0
    assert (p.emitter.value(REFETCHES) or 0) == 0
