"""The drift watchdog's batched prediction against its scalar reference.

`controller/drift.py predict_latency_batch` (one float64 analyze_batch a
pass) against the port's per-VA `predict_latency` and the JAX package's:
the same None cases and readings within 1e-9 relative; a lane's bits
alone equal its bits in a batch of 512; reconcile cycles with drifting
observations give the JAX package's PerfModelAccurate conditions, strike
counts and drift ratios. The tracing: one `drift.predict` span under
`stage:prepare` per full pass and per scoped micro-cycle, and
`inferno_drift_lanes` equal to the VAs judged (0 with the watchdog off).
"""

import copy
import importlib
import json
import math
from dataclasses import asdict

import numpy as np
import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def accelerator(crd, acc, a, b, g, d, mb, contexts=()):
    def parms(a, b, g, d):
        return crd.PerfParms(
            decode_parms={"alpha": repr(a), "beta": repr(b)},
            prefill_parms={"gamma": repr(g), "delta": repr(d)})

    return crd.AcceleratorProfile(
        acc=acc, acc_count=1, perf_parms=parms(a, b, g, d),
        max_batch_size=mb,
        context_profiles=[
            crd.ContextProfile(at_context=at, perf_parms=parms(*p),
                               max_batch_size=cmb)
            for at, p, cmb in contexts])


# (slice, alpha, beta, gamma, delta, max batch, context anchors): v5e-8
# carries context buckets, v6e-1 is listed twice (the first one wins),
# v5p-4 has no profile
PROFILES = (
    ("v5e-1", 6.973, 0.027, 5.2, 0.1, 64, ()),
    ("v5e-4", 3.2, 0.012, 2.4, 0.04, 192, ()),
    ("v5e-8", 2.5, 0.01, 2.0, 0.03, 128,
     ((256, (2.4, 0.009, 1.9, 0.028), 128),
      (2048, (3.1, 0.015, 2.6, 0.05), 48))),
    ("v6e-1", 4.1, 0.02, 3.3, 0.06, 96, ()),
    ("v6e-1", 9.0, 0.05, 8.0, 0.2, 32, ()),
)


def system_spec(pkg: str):
    translate = mod(pkg, "controller.translate")
    crd = mod(pkg, "controller.crd")
    acc_cm = translate.parse_accelerator_configmap({
        name: json.dumps({"chip": name.split("-")[0], "chips": "1",
                          "cost": "20"})
        for name in ("v5e-1", "v5e-4", "v5e-8", "v6e-1", "v5p-4")})
    spec = translate.create_system_data(acc_cm, {})
    for acc, a, b, g, d, mb, contexts in PROFILES:
        translate.add_profile_to_system_data(
            spec, "m0", accelerator(crd, acc, a, b, g, d, mb, contexts))
    return spec


# (slice, rpm, input tokens, output tokens, TTFT, ITL, replicas, stale,
# server max batch)
POINTS = [
    ("v5e-1", 240.0, 256.0, 128.0, 60.0, 9.0, 2, False, 0),
    ("v5e-4", 1800.0, 256.0, 128.0, 150.0, 14.0, 3, False, 0),
    ("v5e-4", 600.0, 512.0, 256.0, 80.0, 0.0, 1, False, 0),   # ITL unseen
    ("v5e-1", 240.0, 128.0, 128.0, 0.0, 7.5, 1, False, 0),    # TTFT unseen
    ("v5e-1", 240.0, 128.0, 128.0, 60.0, 9.0, 1, False, 16),  # N override
    ("v5e-1", 30.0, 0.0, 1.0, 12.0, 8.0, 1, False, 0),        # decode-only
    ("v5e-8", 900.0, 100.0, 128.0, 90.0, 6.0, 2, False, 0),   # below anchors
    ("v5e-8", 900.0, 800.0, 128.0, 90.0, 6.0, 2, False, 0),   # interpolated
    ("v5e-8", 300.0, 4000.0, 256.0, 400.0, 9.0, 2, False, 0),  # above anchors
    ("v6e-1", 600.0, 256.0, 128.0, 70.0, 8.0, 2, False, 0),   # first of two
    ("v5e-1", 240.0, 256.0, 128.0, 60.0, 9.0, 2, True, 0),    # stale
    ("v5e-1", 240.0, 256.0, 128.0, 60.0, 9.0, 0, False, 0),   # no replicas
    ("v5e-1", 0.0, 256.0, 128.0, 60.0, 9.0, 2, False, 0),     # no traffic
    ("v5e-1", 240.0, 256.0, 0.4, 60.0, 9.0, 2, False, 0),     # no output
    ("v5p-4", 240.0, 256.0, 128.0, 60.0, 9.0, 2, False, 0),   # no profile
    ("v5e-1", 9000.0, 256.0, 128.0, 900.0, 30.0, 1, False, 0),  # saturated
    ("v5e-1", 240.0, 256.0, 128.0, 0.0, 0.0, 2, False, 0),    # unobserved
    ("v5e-1", 240.0, -3.0, 128.0, 60.0, 9.0, 2, False, 0),    # bad request
]


def load_of(pkg: str, rpm, tin, tout, ttft, itl):
    return mod(pkg, "collector").CollectedLoad(
        arrival_rate_rpm=rpm, avg_input_tokens=tin, avg_output_tokens=tout,
        avg_ttft_ms=ttft, avg_itl_ms=itl)


def scalar_readings(pkg: str, points) -> list:
    drift = mod(pkg, "controller.drift")
    spec = system_spec(pkg)
    return [drift.predict_latency(
        spec, "m0", acc, load_of(pkg, *load), replicas,
        server_max_batch=smb, stale=stale)
        for acc, *load, replicas, stale, smb in points]


def batch_readings(points, device="cpu") -> tuple[list, int]:
    """The port's batched readings, and the lanes it sent to the batch."""
    drift = mod(PORT, "controller.drift")
    index = drift.profile_index(system_spec(PORT).profiles)
    ops = [drift.operating_point(index, "m0", acc, load_of(PORT, *load),
                                 replicas, server_max_batch=smb, stale=stale)
           for acc, *load, replicas, stale, smb in points]
    lanes = [p for p in ops if p is not None]
    got = iter(drift.predict_latency_batch(lanes, device))
    return [None if p is None else next(got) for p in ops], len(lanes)


# At zero input tokens the model has no prefill, so the predicted TTFT is
# the queueing wait alone, W = T - S: two response times of up to ~1e3 ms
# cancelled to nearly nothing. Below saturation both paths read it as
# rounding noise (1e-13 to 1e-6 ms), each its own, so there the TTFT
# prediction is held to an absolute picosecond and its ratio (observed
# over noise) is not compared.
WAIT_ATOL_MS = 1e-9


def assert_readings_close(got, want, wait_only=()) -> None:
    """Readings within RTOL; on the lanes in `wait_only` (zero input
    tokens) the TTFT prediction within WAIT_ATOL_MS and its ratio not
    compared."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (i, g, w)
        if w is None:
            continue
        for key, x in asdict(w).items():
            y = getattr(g, key)
            if i in wait_only and key.startswith(("ttft", "predicted_ttft")):
                if key == "predicted_ttft_ms":
                    assert abs(y - x) <= WAIT_ATOL_MS, (i, x, y)
                continue
            assert (x is None) == (y is None), (i, key)
            if x is not None:
                assert math.isclose(y, x, rel_tol=RTOL, abs_tol=0.0), \
                    (i, key, x, y)


def test_batch_equals_scalar_port_and_jax():
    """Every case, None ones included: the batch reads what the port's
    predict_latency and the JAX package's read, within 1e-9 relative,
    and gives the same verdict."""
    got, lanes = batch_readings(POINTS)
    port = scalar_readings(PORT, POINTS)
    jax = scalar_readings(JAX, POINTS)
    assert_readings_close(got, port)
    assert_readings_close(got, jax)
    drift = mod(PORT, "controller.drift")
    for g, w in zip(got, port):
        if w is not None:
            assert drift.within_tolerance(g, 0.5) \
                == drift.within_tolerance(w, 0.5)
    # the saturated lane goes to the batch and reads None there
    assert lanes == sum(p is not None for p in port) + 1
    judged = [i for i, r in enumerate(port) if r is not None]
    assert judged == list(range(10))


def test_profile_index_keeps_the_first_listed_profile():
    drift = mod(PORT, "controller.drift")
    profiles = system_spec(PORT).profiles
    index = drift.profile_index(profiles)
    dup = [p for p in profiles if p.accelerator == "v6e-1"]
    assert len(dup) == 2 and index["m0"]["v6e-1"] is dup[0]
    assert "v5p-4" not in index["m0"] and "m1" not in index


def random_points(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    accs = [p[0] for p in PROFILES[:4]]
    out = []
    for _ in range(n):
        rpm = float(rng.choice([0.0, 60.0, 600.0, 2400.0, 9000.0],
                               p=[0.05, 0.3, 0.3, 0.3, 0.05]))
        out.append((str(rng.choice(accs)), rpm,
                    float(rng.choice([0.0, 128.0, 512.0, 3000.0])),
                    float(rng.choice([1.0, 128.0, 256.0])),
                    float(rng.uniform(0.0, 400.0)),
                    float(rng.uniform(0.0, 30.0)),
                    int(rng.integers(0, 5)), bool(rng.random() < 0.05),
                    int(rng.choice([0, 0, 0, 8, 256]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_lane_alone_reads_the_bits_of_a_batch_of_512(seed):
    """Each of 512 VAs judged alone reads, bit for bit, what it reads in
    the batch of 512 (whose grid is as wide as its largest lane's); the
    batch equals the scalar reference (zero-input lanes as
    WAIT_ATOL_MS says)."""
    points = random_points(512, seed)
    batch, lanes = batch_readings(points)
    assert lanes > 300
    wait_only = {i for i, p in enumerate(points) if p[2] == 0.0}
    assert_readings_close(batch, scalar_readings(PORT, points), wait_only)
    for point, want in zip(points, batch):
        alone, _n = batch_readings([point])
        assert alone == [want], point


# -- the reconcile cycle ---------------------------------------------------------


def drift_state(b, c: Cluster) -> dict:
    """(name, namespace) -> the PerfModelAccurate condition as (status,
    reason, message), or None, and the strike count."""
    crd = b.mods["ctl"].crd
    out = {}
    for i in range(c.variants):
        name, ns = rc.va_key(i, c)
        va = b.kube.get_variant_autoscaling(name, ns)
        cond = next((x for x in va.status.conditions
                     if x.type == crd.TYPE_PERF_MODEL_ACCURATE), None)
        out[(name, ns)] = (
            None if cond is None else (cond.status, cond.reason,
                                       cond.message),
            b.rec._drift_strikes.get(f"{name}:{ns}"))
    return out


def drift_ratios(b) -> dict:
    return rc.samples(b.emitter, ("inferno_model_drift_ratio",))


def build_pair(c: Cluster, load: dict):
    clock = rc.Clock()
    j = rc.build(JAX, c, clock, copy.deepcopy(load))
    p = rc.build(PORT, c, clock, copy.deepcopy(load), device="cpu",
                 dtype=torch.float64)
    return clock, j, p


def calibrate(b, c: Cluster, load: dict) -> None:
    """Set every judged group's observed ITL and TTFT to what the model
    predicts for it (one VA a group; a group past the stable region has
    no ratio): the drift ratios of the last pass read 1."""
    for i in range(c.variants):
        name, ns = rc.va_key(i, c)
        group = load[(rc.model_of(i, c), ns)]
        for metric in ("itl", "ttft"):
            ratio = b.emitter.value("inferno_model_drift_ratio",
                                    variant_name=name, namespace=ns,
                                    metric=metric)
            if ratio is not None:
                group[metric] /= ratio


def test_cycles_with_drifting_latency_equal_the_scalar_path():
    """Five cycles, the observations calibrated to the model after the
    first: a third of the groups stay on it, a third drift away by 30% a
    cycle (out of tolerance from the third cycle, False on the third
    strike) and a third wobble by 40% either way. Every cycle gives the
    JAX package's per-VA scalar watchdog's PerfModelAccurate conditions,
    strike counts and drift ratios (within 1e-9)."""
    c = Cluster(variants=12, models=12, namespaces=2, profiles=2)
    load = rc.loads(c)
    clock, j, p = build_pair(c, load)
    groups = sorted(load)
    verdicts = []
    for cycle in range(5):
        j.rec.reconcile()
        p.rec.reconcile()
        want, got = drift_state(j, c), drift_state(p, c)
        assert got == want, cycle
        rj, rp = drift_ratios(j), drift_ratios(p)
        assert rp.keys() == rj.keys() and len(rj) >= c.variants
        for key, v in rj.items():
            assert math.isclose(rp[key], v, rel_tol=RTOL, abs_tol=0.0), key
        verdicts.append(sorted(got.values(), key=repr))
        if cycle == 0:
            calibrate(p, c, load)
        for key in groups[1::3]:
            load[key]["itl"] *= 1.3
            load[key]["ttft"] *= 1.3
        for key in groups[2::3]:
            load[key]["ttft"] *= 1.4 if cycle % 2 else 1 / 1.4
        clock.advance(60.0)
        rc.set_loads(j, load)
        rc.set_loads(p, load)
    last = drift_state(p, c)
    assert {cond[0] for cond, _s in last.values() if cond is not None} \
        == {"True", "False"}
    assert {s for _c, s in last.values()} >= {0, 3}
    assert len({repr(v) for v in verdicts}) >= 3


# -- the tracing -------------------------------------------------------------------


def drift_spans(b) -> list:
    trace = b.rec.tracer.traces(1)[0]
    spans = trace.find_spans("drift.predict")
    for sp in spans:
        parent = next(x.name for x in trace.spans if x.span_id == sp.parent_id)
        assert parent == "stage:prepare"
    return spans


def test_one_span_a_pass_and_the_lanes_gauge(monkeypatch):
    """A full pass and a scoped micro-cycle each open one `drift.predict`
    span whose `lanes`, and `inferno_drift_lanes`, count the VAs judged;
    the batch runs once a pass, with one readback the device audit counts
    as "d2h-drift", and the scalar reference never."""
    drift = mod(PORT, "controller.drift")
    calls = []
    orig = drift.predict_latency_batch

    def spy(points, device):
        calls.append(len(points))
        return orig(points, device)

    def scalar(*_a, **_kw):
        raise AssertionError("predict_latency called in a pass")

    monkeypatch.setattr(drift, "predict_latency_batch", spy)
    monkeypatch.setattr(drift, "predict_latency", scalar)
    c = Cluster(variants=16, models=4, namespaces=2)
    load = rc.loads(c)
    quiet = sorted(load)[0]
    load[quiet]["itl"] = load[quiet]["ttft"] = 0.0   # nothing observed
    p = rc.build(PORT, c, rc.Clock(), load, device="cpu",
                 dtype=torch.float64)
    judged = sum(rc.model_of(i, c) != quiet[0] or rc.va_key(i, c)[1]
                 != quiet[1] for i in range(c.variants))
    audit = mod(PORT, "obs").DEVICE_AUDIT
    before = audit.snapshot()
    p.rec.reconcile()
    spans = drift_spans(p)
    assert len(spans) == 1 and spans[0].attributes["lanes"] == judged
    assert calls == [judged] and judged < c.variants
    assert p.emitter.value("inferno_drift_lanes") == judged
    # the batch's one readback, apart from the sizing groups' "d2h"
    transfers = audit.delta(before, audit.snapshot())["transfers"]
    assert transfers["d2h-drift"] == 1

    col = mod(PORT, "collector")
    keys = {"{}:{}".format(*rc.va_key(i, c)) for i in range(c.variants)
            if rc.model_of(i, c) == "m1"}
    streamed = {k: col.CollectedLoad(
        arrival_rate_rpm=1200.0, avg_input_tokens=128.0,
        avg_output_tokens=128.0, avg_ttft_ms=200.0, avg_itl_ms=12.0)
        for k in keys}
    res = p.rec.reconcile(scope=keys, stream_loads=streamed)
    assert sorted(res.processed) == sorted(keys)
    spans = drift_spans(p)
    assert len(spans) == 1 and spans[0].attributes["lanes"] == len(keys)
    assert calls == [judged, len(keys)]
    assert p.emitter.value("inferno_drift_lanes") == len(keys)


def test_watchdog_off_reads_zero_and_removes_the_condition():
    """With WVA_DRIFT_TOLERANCE at 0 (a negative value falls back to the
    default): no span, the gauge reads 0, and the PerfModelAccurate condition and strikes a previous pass
    left are gone, as in the JAX package."""
    c = Cluster(variants=8, models=4, namespaces=2)
    load = rc.loads(c)
    _clock, j, p = build_pair(c, load)
    for _cycle in range(3):
        for b in (j, p):
            b.rec.reconcile()
    assert p.emitter.value("inferno_drift_lanes") == c.variants
    assert any(cond is not None for cond, _s in drift_state(p, c).values())
    for b in (j, p):
        ctl = b.mods["ctl"]
        cm = b.kube.get_configmap(ctl.CONFIG_MAP_NAME,
                                  ctl.CONFIG_MAP_NAMESPACE)
        b.kube.put_configmap(ctl.ConfigMap(
            ctl.CONFIG_MAP_NAME, ctl.CONFIG_MAP_NAMESPACE,
            {**cm.data, "WVA_DRIFT_TOLERANCE": "0"}))
        b.rec.reconcile()
    assert drift_spans(p) == []
    assert p.emitter.value("inferno_drift_lanes") == 0
    assert drift_state(p, c) == drift_state(j, c)
    assert all(v == (None, None) for v in drift_state(p, c).values())
    assert drift_ratios(p) == drift_ratios(j) == {}
