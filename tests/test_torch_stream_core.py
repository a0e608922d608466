"""The port's streaming core against the JAX package's, on one cluster.

Each case builds one cluster (tests/reconcile_cluster.py) through both
packages and attaches each package's own `StreamCore` to its
reconciler, on one injected clock. Load changes arrive as the same
snappy-compressed remote-write bytes, posted through each package's
`remote_write_middleware`, and `process_once` drains them
synchronously (nothing sleeps on wall time). After every step, for
every VA:

- the cycles' `ReconcileResult`s (processed, skipped, degraded, error,
  requeue);
- the published status: desired (accelerator, replicas), the current
  max batch, the conditions;
- the solution each VA was published from (accelerator, replicas and
  batch exact; cost, ITL, TTFT within rel 1e-9 in float64);
- the emitter's decision series and every `inferno_stream_*` sample
  (power within rel 1e-9 in float64);
- the new cycles' DecisionRecords (collection mode included);
- the door's answers (status, the X-Ingested/Shed-Groups headers) and
  the core's queue depth and failure counts.

The JAX side runs with WVA_NATIVE_KERNEL=false (its batched XLA
backend in float64); the port runs `device="cpu"` in float64, and in
float32 for the decisions alone.
"""

import copy
import io
import shutil
import threading

import numpy as np
import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster
from test_torch_reconciler import close, spy_solutions

from workload_variant_autoscaler_tpu import stream as js
from workload_variant_autoscaler_tpu_torch import stream as ps

STREAM_PKG = {JAX: js, PORT: ps}


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def post(app, body: bytes, path="/api/v1/write", method="POST",
         encoding="snappy"):
    """One WSGI request through a door: (status, headers, payload)."""
    status, headers = [], {}

    def start(st, hdrs):
        status.append(st)
        headers.update(dict(hdrs))

    environ = {"PATH_INFO": path, "REQUEST_METHOD": method,
               "CONTENT_LENGTH": str(len(body)),
               "HTTP_CONTENT_ENCODING": encoding,
               "wsgi.input": io.BytesIO(body)}
    payload = b"".join(app(environ, start))
    return (status[0] if status else ""), headers, payload


def write_body(load: dict, keys, ts_ms: float, fields=None) -> bytes:
    """The recording-rule series of `keys`' loads as one remote-write
    request (the port's encoder; tests/test_torch_stream.py holds it
    equal to the JAX package's)."""
    series = []
    for model, ns in keys:
        v = load[(model, ns)]
        values = {"wva:stream:arrival_rpm": v["rps"] * 60.0,
                  "wva:stream:avg_input_tokens": v["prompt"],
                  "wva:stream:avg_output_tokens": v["gen"],
                  "wva:stream:avg_ttft_ms": v["ttft"] * 1000.0,
                  "wva:stream:avg_itl_ms": v["itl"] * 1000.0}
        for name, value in values.items():
            if fields is None or name in fields:
                series.append(({"__name__": name, "model_name": model,
                                "namespace": ns}, [(value, int(ts_ms))]))
    return ps.snappy_compress(ps.encode_write_request(series))


# the port's own stream series, which the JAX package does not have
PORT_ONLY_STREAM = ("inferno_stream_queue_wait_seconds",
                    "inferno_stream_door_seconds")


def stream_samples(emitter) -> dict:
    """The decision series, the degradation rung and every
    `inferno_stream_*` sample (not the `_created` wall-clock stamps, nor
    the port's own PORT_ONLY_STREAM series)."""
    out = {}
    for metric in emitter.registry.collect():
        for s in metric.samples:
            if s.name.endswith("_created") \
                    or s.name.startswith(PORT_ONLY_STREAM):
                continue
            if s.name.startswith("inferno_stream") \
                    or s.name in rc.DECISION_SERIES \
                    or s.name == "inferno_cycle_degradation_state":
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


class Pair:
    """One cluster through both packages, each reconciler with its own
    package's StreamCore on the shared injected clock."""

    def __init__(self, c: Cluster, monkeypatch, dtype=torch.float64,
                 debounce_s=None, baseline=True):
        self.c = c
        self.floats = dtype == torch.float64
        self.clock = rc.Clock()
        self.load = rc.loads(c)
        self.sol = {JAX: spy_solutions(monkeypatch, JAX),
                    PORT: spy_solutions(monkeypatch, PORT)}
        self.b = {JAX: rc.build(JAX, c, self.clock,
                                copy.deepcopy(self.load)),
                  PORT: rc.build(PORT, c, self.clock,
                                 copy.deepcopy(self.load), device="cpu",
                                 dtype=dtype)}
        self.core = {}
        self.door = {}
        for pkg, b in self.b.items():
            self.attach(pkg, debounce_s)
        self.seen = {pkg: b.rec.state.cycle_index
                     for pkg, b in self.b.items()}
        self.rng = np.random.default_rng(c.seed + 11)
        if baseline:
            results = self.process()
            assert len(results) == 1
            assert len(results[0].processed) == c.variants

    def attach(self, pkg, debounce_s=None):
        b = self.b[pkg]
        core = STREAM_PKG[pkg].StreamCore(b.rec, debounce_s=debounce_s,
                                          clock=self.clock.monotonic)
        b.rec.stream_core = core
        self.core[pkg] = core
        self.door[pkg] = STREAM_PKG[pkg].remote_write_middleware(core)(
            lambda _e, _s: [b"inner"])
        return core

    def set_operator(self, key: str, values: dict) -> None:
        """Put `key` into each package's operator ConfigMap, with that
        package's value (`values[pkg]`); packages left out get none."""
        for pkg, b in self.b.items():
            ctl = b.mods["ctl"]
            cm = b.kube.get_configmap(ctl.CONFIG_MAP_NAME,
                                      ctl.CONFIG_MAP_NAMESPACE)
            if pkg in values:
                cm.data[key] = values[pkg]
            b.kube.put_configmap(cm)

    @property
    def j(self):
        return self.b[JAX]

    @property
    def p(self):
        return self.b[PORT]

    def both(self, fn):
        """fn(pkg, build, core) on both packages; the two answers,
        which must be equal."""
        out = [fn(pkg, self.b[pkg], self.core[pkg]) for pkg in (JAX, PORT)]
        assert out[1] == out[0]
        return out[1]

    def push(self, body: bytes, **kw):
        """The same bytes through both doors."""
        return self.both(lambda pkg, _b, _c: post(self.door[pkg], body,
                                                  **kw)[:2])

    def change(self, n: int, factor=None) -> list:
        """Scale `n` load groups' arrival rates; Prometheus follows."""
        keys = sorted(self.load)
        picked = [keys[int(k)] for k in
                  self.rng.choice(len(keys), size=n, replace=False)]
        for k in picked:
            f = (float(self.rng.uniform(0.3, 1.8)) if factor is None
                 else factor)
            self.load[k]["rps"] *= f
        for b in self.b.values():
            rc.set_loads(b, self.load)
        return picked

    def push_changes(self, n: int, factor=None):
        keys = self.change(n, factor)
        return keys, self.push(write_body(self.load, keys,
                                          self.clock.now() * 1000.0))

    def process(self, advance: float = 0.0):
        """Advance the clock, drain both cores, compare everything."""
        self.clock.advance(advance)
        out = {}
        for pkg, b in self.b.items():
            self.sol[pkg].clear()
            out[pkg] = self.core[pkg].process_once()
        self.compare(out[JAX], out[PORT])
        return out[PORT]

    def compare(self, rj, rp) -> None:
        assert len(rp) == len(rj)
        for a, b in zip(rj, rp):
            assert (b.processed, b.skipped, b.degraded, b.error,
                    b.requeue_after) == (a.processed, a.skipped,
                                         a.degraded, a.error,
                                         a.requeue_after)
        assert rc.published(self.p, self.c) == rc.published(self.j, self.c)
        sj, sp = self.sol[JAX], self.sol[PORT]
        assert sp.keys() == sj.keys()
        for key, a in sj.items():
            assert sp[key][:3] == a[:3], key
            if self.floats:
                assert all(close(x, y) for x, y in
                           zip(a[3:], sp[key][3:])), key
        mj, mp = stream_samples(self.j.emitter), stream_samples(
            self.p.emitter)
        assert set(mp) ^ set(mj) == set()
        for key, v in mj.items():
            if key[0] == "inferno_variant_power_watts":
                if self.floats:
                    assert close(v, mp[key]), key
            else:
                assert mp[key] == v, key
        ij, ip = self.j.rec.state.cycle_index, self.p.rec.state.cycle_index
        assert ip == ij
        for cycle in range(self.seen[JAX] + 1, ij + 1):
            dj = rc.decision_records(self.j, cycle)
            dp = rc.decision_records(self.p, cycle)
            if not self.floats:
                dj, dp = decisions_only(dj), decisions_only(dp)
            assert dp == dj, cycle
        self.seen = {JAX: ij, PORT: ip}
        self.both(lambda _pkg, _b, core: (core.queue.pending(),
                                          core.queue.debounce_s))
        assert self.core[PORT].failures == {"cycle": 0, "consumer": 0,
                                            "checkpoint_save": 0}


def decisions_only(records: dict) -> dict:
    """The records' decisions: the float inputs and telemetry left out
    (float32 runs compare decisions alone)."""
    keep = ("cycle", "accelerator", "proposed_replicas", "clamps",
            "published_replicas", "outcome", "reason")
    return {k: ({f: d[f] for f in keep},
                d["inputs"]["collection_mode"], d["inputs"]["solve_mode"])
            for k, d in records.items()}


def va_keys(c: Cluster, groups) -> list:
    groups = set(groups)
    return sorted("{}:{}".format(*rc.va_key(i, c)) for i in range(c.variants)
                  if (rc.model_of(i, c), rc.va_key(i, c)[1]) in groups)


SMALL = Cluster(variants=64, namespaces=2, models=16, profiles=2, seed=5)
P95 = Cluster(variants=64, namespaces=2, models=16, profiles=2, seed=6,
              percentile=0.95)


# -- change detection and scoped cycles -------------------------------------


def test_change_detection(monkeypatch):
    """Re-pushes of the same load, and of a load inside the same epsilon
    bucket, flip nothing; a real step flips exactly its group; a group
    outside the fleet is dropped; a partial push of an unknown group is
    held until it is solvable."""
    pair = Pair(SMALL, monkeypatch)
    now_ms = pair.clock.now() * 1000.0
    key = sorted(pair.load)[3]
    same = write_body(pair.load, [key], now_ms)
    assert pair.push(same)[0].startswith("204")
    assert pair.process(1.0) == []
    pair.load[key]["rps"] *= 1.001                  # same bucket
    pair.push(write_body(pair.load, [key], now_ms + 1000.0))
    assert pair.process(1.0) == []
    pair.load[key]["rps"] *= 2.0                    # a real step
    pair.push(write_body(pair.load, [key], now_ms + 2000.0))
    results = pair.process(1.0)
    assert len(results) == 1 and results[0].processed == va_keys(
        SMALL, [key])
    ghost = {("ghost", "ns0"): dict(pair.load[key])}
    assert pair.push(write_body(ghost, list(ghost), now_ms + 3000.0,
                                fields=("wva:stream:arrival_rpm",)))
    pair.both(lambda _p, _b, core: core.queue.pending())
    assert pair.process(1.0) == []
    pair.push(write_body(ghost, list(ghost), now_ms + 4000.0))
    assert pair.process(1.0) == []


@pytest.mark.parametrize("cluster", [SMALL, P95], ids=["mean", "p95-class"])
def test_scoped_cycles(cluster, monkeypatch):
    """Rounds of two changed groups each: one scoped micro-cycle over
    exactly their VAs, merged into the wholesale series."""
    pair = Pair(cluster, monkeypatch)
    for _ in range(4):
        keys, (status, headers) = pair.push_changes(2)
        assert status.startswith("204")
        assert headers["X-Ingested-Groups"] == "2"
        results = pair.process(1.0)
        assert len(results) == 1
        assert results[0].processed == va_keys(cluster, keys)


def test_scoped_cycles_float32_decisions(monkeypatch):
    pair = Pair(P95, monkeypatch, dtype=torch.float32)
    for _ in range(3):
        keys, _ = pair.push_changes(3)
        results = pair.process(1.0)
        assert results[0].processed == va_keys(P95, keys)


# -- overload protection ----------------------------------------------------


def test_escalation_valve(monkeypatch):
    """A blown lag budget coalesces the backlog into one full pass on
    the stream-degraded rung; a saturated queue skips the window."""
    monkeypatch.setenv("WVA_STREAM_LAG_BUDGET_MS", "5000")
    pair = Pair(SMALL, monkeypatch, debounce_s=30.0)
    pair.push_changes(1)
    assert pair.process(1.0) == []                  # window open
    results = pair.process(5.5)                     # oldest age > budget
    assert len(results) == 1 and len(results[0].processed) == SMALL.variants
    assert pair.p.emitter.value("inferno_cycle_degradation_state") == 1.0
    monkeypatch.setenv("WVA_STREAM_MAX_QUEUE", "1")
    pair2 = Pair(SMALL, monkeypatch, debounce_s=30.0)
    pair2.push_changes(1)
    results = pair2.process(0.1)                    # depth == cap
    assert len(results) == 1 and len(results[0].processed) == SMALL.variants


def test_adaptive_debounce(monkeypatch):
    """Real drains of storm, storm+1, storm, storm-1, storm/2 and single
    events walk the window up the doubling ladder, hold it inside the
    hysteresis band and halve it back to the base."""
    monkeypatch.setenv("WVA_STREAM_STORM_EVENTS", "4")
    monkeypatch.setenv("WVA_STREAM_MAX_DEBOUNCE_MS", "100")
    pair = Pair(SMALL, monkeypatch, debounce_s=0.025)
    gauge = []
    for n in (4, 5, 4, 3, 2, 1, 1):
        pair.clock.advance(0.2)
        pair.push_changes(n)
        results = pair.process(0.2)
        assert len(results) == 1
        gauge.append(pair.p.emitter.value("inferno_stream_debounce_ms"))
    assert gauge == [50.0, 100.0, 100.0, 100.0, 50.0, 25.0, 25.0]


def test_limited_mode_storm(monkeypatch):
    """In limited mode an escalation after quiet runs one full pass at
    once; a storm of follow-ups inside the lag budget rides one pending
    backstop pass."""
    monkeypatch.setenv("WVA_STREAM_LAG_BUDGET_MS", "5000")
    c = Cluster(variants=64, namespaces=2, models=16, profiles=2, seed=7,
                nodes=(("v5e", 96), ("v5e", 64)))
    pair = Pair(c, monkeypatch, debounce_s=0.0)
    pair.push_changes(1)
    results = pair.process(1.0)
    assert len(results) == 1 and len(results[0].processed) == c.variants
    for _ in range(3):
        pair.push_changes(1)
        pair.process(0.0)
    results = pair.process(5.5)
    assert len(results) == 1 and len(results[0].processed) == c.variants
    assert pair.process(0.0) == []
    assert pair.p.emitter.value("inferno_stream_limited_total",
                                lane="coalesced") >= 1.0


def test_overload_shedding(monkeypatch):
    """An oversized body answers 413; a full store sheds the new group
    and requests a full pass; a full queue keeps the data and loses only
    the wake; a partly poisoned request answers 429 with its
    accounting."""
    monkeypatch.setenv("WVA_STREAM_MAX_BODY_BYTES", "2048")
    pair = Pair(SMALL, monkeypatch, debounce_s=0.0)
    assert pair.push(b"\x00" * 4096)[0].startswith("413")
    monkeypatch.delenv("WVA_STREAM_MAX_BODY_BYTES")
    monkeypatch.setenv("WVA_STREAM_MAX_GROUPS", str(len(pair.load)))
    ghost = {("ghost", "ns0"): dict(sorted(pair.load.values(),
                                           key=repr)[0])}
    status, headers = pair.push(write_body(
        ghost, list(ghost), pair.clock.now() * 1000.0))
    assert status.startswith("429") and headers["X-Shed-Groups"] == "1"
    results = pair.process(1.0)
    assert len(results) == 1 and len(results[0].processed) == SMALL.variants
    monkeypatch.delenv("WVA_STREAM_MAX_GROUPS")
    monkeypatch.setenv("WVA_STREAM_MAX_QUEUE", "1")
    pair.push_changes(3)
    results = pair.process(1.0)
    assert len(results) == 1 and len(results[0].processed) == SMALL.variants
    key = sorted(pair.load)[0]
    bad = copy.deepcopy(pair.load)
    bad[key]["rps"] = float("nan")
    status, headers = pair.push(write_body(
        bad, sorted(pair.load)[:2], pair.clock.now() * 1000.0))
    assert status.startswith("429")
    assert (headers["X-Ingested-Groups"], headers["X-Shed-Groups"]) == \
        ("1", "1")
    pair.process(1.0)


def test_quarantine(monkeypatch):
    """NaN, negative, far-future and out-of-order samples and a label
    bomb are quarantined with their reasons; persistent poison opens
    the source breaker (429 with Retry-After) until the cooldown
    elapses on the core's clock."""
    monkeypatch.setenv("WVA_STREAM_QUARANTINE_THRESHOLD", "3")
    pair = Pair(SMALL, monkeypatch)
    key = sorted(pair.load)[1]
    now_ms = pair.clock.now() * 1000.0
    labels = {"__name__": "wva:stream:arrival_rpm", "model_name": key[0],
              "namespace": key[1], **{f"bomb_{i}": "x" for i in range(70)}}
    status, headers = pair.push(ps.snappy_compress(ps.encode_write_request(
        [(labels, [(9600.0, int(now_ms))])])))
    assert status.startswith("429") and headers["X-Shed-Groups"] == "1"
    assert pair.p.emitter.value("inferno_stream_shed_total",
                                reason="quarantine-labels") == 1.0
    for rps, ts in ((-1.0, now_ms), (1.0, now_ms + 3_600_000.0),
                    (float("nan"), now_ms)):
        bad = copy.deepcopy(pair.load)
        bad[key]["rps"] = rps
        assert pair.push(write_body(bad, [key], ts))[0].startswith("429")
    status, headers = pair.push(write_body(pair.load, [key], now_ms))
    assert status.startswith("429") and headers.get("Retry-After") == "60"
    pair.both(lambda _p, _b, core: core.source_quarantined("remote-write"))
    pair.clock.advance(61.0)
    pair.both(lambda _p, _b, core: core.source_quarantined("remote-write"))
    pair.push_changes(1)
    pair.process(1.0)


def test_scrape_poller(monkeypatch):
    """`ScrapePoller.poll_once` feeds the same door from each package's
    Prometheus: a sweep that matches the store flips nothing, a demand
    step is found by the next sweep, and a failing Prometheus is
    metered per group."""
    pair = Pair(SMALL, monkeypatch)
    pollers = {pkg: STREAM_PKG[pkg].ScrapePoller(
        pair.core[pkg], threading.Event(), prom=pair.b[pkg].prom)
        for pkg in (JAX, PORT)}
    pair.both(lambda pkg, _b, _c: pollers[pkg].poll_once())
    assert pair.process(1.0) == []
    keys = pair.change(4, factor=2.0)
    pair.both(lambda pkg, _b, _c: pollers[pkg].poll_once())
    results = pair.process(1.0)
    assert len(results) == 1 and results[0].processed == va_keys(SMALL, keys)

    class BrokenProm:
        def query(self, *_a, **_k):
            raise TimeoutError("prometheus down")

    pair.both(lambda pkg, _b, core: STREAM_PKG[pkg].ScrapePoller(
        core, threading.Event(), prom=BrokenProm()).poll_once())
    pair.process(1.0)


def test_kick_storm(monkeypatch):
    """Watch kicks inside one debounce window coalesce into exactly one
    full pass."""
    pair = Pair(SMALL, monkeypatch, debounce_s=1.5)
    for _ in range(4):
        pair.both(lambda _p, b, _c: b.rec.kick())
        pair.clock.advance(0.25)
    assert pair.process(0.0) == []
    results = pair.process(1.0)
    assert len(results) == 1 and len(results[0].processed) == SMALL.variants
    assert pair.process(1.0) == []


def test_stream_off_runs_the_polled_loop(monkeypatch):
    """WVA_STREAM=off: `run_forever` runs the polled loop in both
    packages, attaches no core, and publishes equal decisions."""
    monkeypatch.setenv("WVA_STREAM", "off")
    pair = Pair(SMALL, monkeypatch, baseline=False)
    for pkg, b in pair.b.items():
        b.rec.stream_core = None
        stop = threading.Event()
        orig = b.rec.reconcile

        def once(orig=orig, stop=stop):
            res = orig()
            stop.set()
            return res

        monkeypatch.setattr(b.rec, "reconcile", once)
        pair.sol[pkg].clear()
        b.rec.run_forever(stop, watch=False)
        assert b.rec.stream_core is None
    pair.compare([], [])


def without_drift(published: dict) -> dict:
    """Published status without the PerfModelAccurate condition: the
    drift watchdog counts strikes per cycle a VA takes part in, and a
    polled loop runs every VA every cycle while the stream re-solves
    only the changed ones."""
    return {k: v[:3] + (tuple(x for x in v[3]
                              if x[0] != "PerfModelAccurate"),)
            for k, v in published.items()}


def test_streamed_equals_polled(monkeypatch):
    """The same load trajectory through streamed micro-cycles and
    through polled reconciles publishes equal decisions and conditions
    in each package (the drift verdict aside), and the port's streamed
    decisions equal the JAX package's."""
    pair = Pair(SMALL, monkeypatch)
    polled = Pair(SMALL, monkeypatch, baseline=False)
    for b in polled.b.values():
        b.rec.stream_core = None
        b.rec.reconcile()
    for _ in range(4):
        pair.push_changes(3)
        pair.process(1.0)
        polled.load = copy.deepcopy(pair.load)
        polled.clock.t = pair.clock.t
        for b in polled.b.values():
            rc.set_loads(b, polled.load)
            b.rec.reconcile()
        for pkg in (JAX, PORT):
            want = without_drift(rc.published(polled.b[pkg], SMALL))
            assert without_drift(rc.published(pair.b[pkg], SMALL)) == want
            desired = ("inferno_desired_replicas",)
            assert rc.samples(pair.b[pkg].emitter, desired) == \
                rc.samples(polled.b[pkg].emitter, desired)
    for rec in pair.p.rec.decisions.records(limit=10_000):
        assert rec.replay() == rec.published_replicas


# -- warm restart -----------------------------------------------------------


def restart(pair: Pair, pkg: str):
    """A fresh reconciler and core over the same cluster, as after a
    process crash."""
    mods = pair.b[pkg].mods
    b = pair.b[pkg]
    kw = ({} if pkg == JAX else dict(device="cpu", dtype=torch.float64))
    rec = mods["ctl"].Reconciler(
        kube=b.kube, prom=b.prom, emitter=mods["met"].MetricsEmitter(),
        now=pair.clock.now, sleep=lambda _s: None,
        monotonic=pair.clock.monotonic,
        decisions=mods["obs"].DecisionLog(capacity=8 * pair.c.variants + 64,
                                          now=pair.clock.now), **kw)
    b.rec, b.emitter = rec, rec.emitter
    return pair.attach(pkg)


def restart_from(pair: Pair, paths: dict, monkeypatch) -> None:
    """Restart both packages' controllers, each core restoring from its
    path (a fresh reconciler reads the knob from the environment); the
    restore is counted and nothing is left to solve."""
    for pkg, path in paths.items():
        monkeypatch.setenv("WVA_STREAM_CHECKPOINT", path)
        core = restart(pair, pkg)
        monkeypatch.delenv("WVA_STREAM_CHECKPOINT")
        assert pair.b[pkg].emitter.value("inferno_stream_checkpoint_total",
                                         event="restore") == 1.0
        assert core.process_once() == []
    pair.both(lambda _p, b, _c: (b.rec.state.cycle_index,
                                 len(b.rec.state.snapshot.vas)))
    pair.seen = {pkg: b.rec.state.cycle_index for pkg, b in pair.b.items()}


def test_checkpoint_and_warm_restart(monkeypatch, tmp_path):
    """Each core saves its checkpoint after every cycle; the two
    payloads are equal (floats within rel 1e-9). Restarted from them,
    both cores resume scoped at once, and the next micro-cycles are
    equal."""
    paths = {JAX: str(tmp_path / "jax.ckpt"),
             PORT: str(tmp_path / "port.ckpt")}
    pair = Pair(SMALL, monkeypatch, baseline=False)
    pair.set_operator("WVA_STREAM_CHECKPOINT", paths)
    pair.process()
    for _ in range(2):
        pair.push_changes(2)
        pair.process(1.0)
    pair.both(lambda pkg, b, _c: b.emitter.value(
        "inferno_stream_checkpoint_total", event="save"))
    payloads = [mod.load_checkpoint(paths[pkg])
                for pkg, mod in STREAM_PKG.items()]
    for p in payloads:
        p["cross_cycle"]["last_operator_cm"].pop("WVA_STREAM_CHECKPOINT")
        p["snapshot"]["operator_cm"].pop("WVA_STREAM_CHECKPOINT")
    assert_payloads_equal(*payloads)
    restart_from(pair, paths, monkeypatch)
    for _ in range(2):
        keys, _ = pair.push_changes(2)
        results = pair.process(1.0)
        assert len(results) == 1
        assert results[0].processed == va_keys(SMALL, keys)


def test_jax_checkpoint_restores_into_the_port(monkeypatch, tmp_path):
    """A checkpoint the JAX package's core wrote restores into the
    port's core (the JSON is one format), and the next micro-cycles
    equal the JAX core's after its own restart."""
    path = str(tmp_path / "jax.ckpt")
    pair = Pair(SMALL, monkeypatch, baseline=False)
    pair.set_operator("WVA_STREAM_CHECKPOINT",
                      {JAX: path, PORT: str(tmp_path / "port.ckpt")})
    pair.process()
    pair.push_changes(2)
    pair.process(1.0)
    copy_for_port = str(tmp_path / "for-port.ckpt")
    shutil.copy(path, copy_for_port)
    restart_from(pair, {JAX: path, PORT: copy_for_port}, monkeypatch)
    for _ in range(2):
        keys, _ = pair.push_changes(2)
        results = pair.process(1.0)
        assert len(results) == 1
        assert results[0].processed == va_keys(SMALL, keys)


def assert_payloads_equal(a, b, where="payload"):
    if isinstance(a, float) and isinstance(b, float):
        assert close(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_payloads_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_payloads_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_queue_wait_and_door_time_one_push():
    """One push, served 0.5 s after the door offered it (on the core's
    clock) by a micro-cycle that itself takes 0.25 s: one queue-wait
    sample for the one lag sample, the wait (0.5) at most the lag
    (0.75). The door times every request to its path, whatever its
    status, and no other path."""
    c = Cluster(variants=16, namespaces=2, models=8, profiles=2, seed=5)
    clock = rc.Clock()
    load = rc.loads(c)
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=torch.float64)
    core = ps.StreamCore(p.rec, clock=clock.monotonic)
    p.rec.stream_core = core
    door = ps.remote_write_middleware(core)(lambda _e, _s: [b"inner"])
    assert len(core.process_once()) == 1           # the first full pass
    orig = p.rec.reconcile

    def slow(**kw):
        clock.advance(0.25)
        return orig(**kw)

    p.rec.reconcile = slow
    key = sorted(load)[0]
    load[key]["rps"] *= 1.5
    rc.set_loads(p, load)
    status, _h, _b = post(door, write_body(load, [key],
                                           clock.now() * 1000.0))
    assert status.startswith("204")
    clock.advance(0.5)
    assert [len(r.processed) for r in core.process_once()] == [2]
    value = p.emitter.value
    assert value("inferno_stream_queue_wait_seconds_count") \
        == value("inferno_stream_lag_seconds_count") == 1
    wait = value("inferno_stream_queue_wait_seconds_sum")
    lag = value("inferno_stream_lag_seconds_sum")
    assert wait == pytest.approx(0.5) and lag == pytest.approx(0.75)
    assert wait <= lag
    assert post(door, b"", method="GET")[0].startswith("405")
    assert post(door, b"not snappy")[0].startswith("400")
    assert post(door, b"", path="/metrics")[2] == b"inner"
    assert value("inferno_stream_door_seconds_count") == 3
    assert value("inferno_stream_door_seconds_sum") > 0.0


def test_queue_wait_only_for_published_groups():
    """A scoped micro-cycle over two changed groups that publishes only
    the first: the queue wait, like the lag, counts the one published
    group, so each wait has its lag and lag = wait + service."""
    c = Cluster(variants=16, namespaces=2, models=8, profiles=2, seed=5)
    clock = rc.Clock()
    load = rc.loads(c)
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=torch.float64)
    core = ps.StreamCore(p.rec, clock=clock.monotonic)
    p.rec.stream_core = core
    door = ps.remote_write_middleware(core)(lambda _e, _s: [b"inner"])
    assert len(core.process_once()) == 1           # the first full pass
    first, second = sorted(load)[:2]
    dropped = set(va_keys(c, [second]))
    orig = p.rec.reconcile

    def publishes_first(**kw):
        clock.advance(0.25)
        result = orig(**kw)
        result.processed = [k for k in result.processed
                            if k not in dropped]
        return result

    p.rec.reconcile = publishes_first
    for key in (first, second):
        load[key]["rps"] *= 1.5
    rc.set_loads(p, load)
    status, _h, _b = post(door, write_body(load, [first, second],
                                           clock.now() * 1000.0))
    assert status.startswith("204")
    clock.advance(0.5)
    results = core.process_once()
    assert [r.processed for r in results] == [va_keys(c, [first])]
    value = p.emitter.value
    assert value("inferno_stream_queue_wait_seconds_count") \
        == value("inferno_stream_lag_seconds_count") == 1
    wait = value("inferno_stream_queue_wait_seconds_sum")
    lag = value("inferno_stream_lag_seconds_sum")
    assert wait == pytest.approx(0.5) and lag == pytest.approx(0.75)
