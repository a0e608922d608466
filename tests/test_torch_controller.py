"""The reconcile cycle's parts in the port, against the JAX package.

Each part of the port's controller slice runs beside the JAX package's
on the same inputs (made with numpy or written out), exactly:
`translate.warmup_plan` and `ttft_percentile`; `engine_backend`'s whole
selection table (the System's device standing in for the reference's
"host is CPU-only") and the knob warnings of the meshes; `collect_load` and
`validate_metrics_availability` over a FakePromAPI; the `LoadCache`
tiers; `ops/analyzer.py`'s scalar `QueueAnalyzer.size`/`analyze`; the
drift watchdog's `predict_latency`; the emitter's device-audit series.
The port's own additions are pinned too: the warm-up on the CPU, the
device audit's feeds (the readback, the arena's staging copies, the
kernel library's first build) and the audit's record in the cycle's
profile.
"""

import importlib
import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster

PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- translate --------------------------------------------------------------


def cluster_vas(pkg: str, c: Cluster):
    clock = rc.Clock()
    b = rc.build(pkg, c, clock, rc.loads(c), **(
        {"device": "cpu"} if pkg == PORT else {}))
    return b.kube.list_variant_autoscalings(), \
        b.kube.get_configmap(b.mods["ctl"].SERVICE_CLASS_CM_NAME,
                             b.mods["ctl"].CONFIG_MAP_NAMESPACE).data


@pytest.mark.parametrize("c,operator", [
    (Cluster(variants=40, models=8), {}),
    (Cluster(variants=40, models=8, percentile=0.95), {}),
    (Cluster(variants=40, models=8, profiles=8), {"WVA_TTFT_PERCENTILE": "0.9"}),
    (Cluster(variants=3, models=3, profiles=1), {}),
])
def test_warmup_plan_equals_reference(c, operator):
    plans = []
    for pkg in PKGS:
        vas, classes = cluster_vas(pkg, c)
        plans.append(mod(pkg, "controller.translate").warmup_plan(
            vas, service_class_cm=classes, operator_cm=operator))
    assert plans[1] == plans[0]
    assert plans[1]


def test_warmup_plan_of_an_empty_fleet_equals_reference():
    plans = [mod(pkg, "controller.translate").warmup_plan([])
             for pkg in PKGS]
    assert plans[1] == plans[0] == [(16, 256, None)]


@pytest.mark.parametrize("raw", ["", "0.9", "0.95", "0.99", "abc", "1.5",
                                 "0.5", " 0.8 "])
def test_ttft_percentile_equals_reference(raw, monkeypatch):
    monkeypatch.delenv("WVA_TTFT_PERCENTILE", raising=False)
    got = [mod(pkg, "controller.translate").ttft_percentile(
        {"WVA_TTFT_PERCENTILE": raw}) for pkg in PKGS]
    assert got[1] == got[0]
    monkeypatch.setenv("WVA_TTFT_PERCENTILE", raw)
    got = [mod(pkg, "controller.translate").ttft_percentile(None)
           for pkg in PKGS]
    assert got[1] == got[0]


def warnings_of(pkg: str, fn, monkeypatch) -> list:
    translate = mod(pkg, "controller.translate")
    said = []
    monkeypatch.setattr(translate.log, "warning",
                        lambda msg, *a, **k: said.append(msg))
    fn(translate)
    monkeypatch.undo()
    return said


def test_pallas_knob_warns_as_reference_and_is_ignored(monkeypatch):
    monkeypatch.setenv("WVA_PALLAS_KERNEL", "true")
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    said_j = warnings_of(JAX, lambda t: t.engine_backend(), monkeypatch)
    monkeypatch.setenv("WVA_PALLAS_KERNEL", "true")
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    picked = []
    said_p = warnings_of(
        PORT, lambda t: picked.append(t.engine_backend("cpu")), monkeypatch)
    assert said_p == said_j and len(said_p) == 1
    assert picked == ["batched"]


@pytest.mark.parametrize("knob", ["unset", "true", "false"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("lib", [True, False], ids=["lib", "nolib"])
def test_backend_follows_the_device(knob, device, lib, monkeypatch):
    """The whole WVA_NATIVE_KERNEL table against the reference's
    engine_backend(): the System's device stands in for its "host is
    CPU-only", and the port's device backend ("kernel" on cuda, "batched"
    on cpu) for its "batched". The same warnings, as many."""
    import workload_variant_autoscaler_tpu.utils.platform as platform

    own = "kernel" if device == "cuda" else "batched"
    picked, said = {}, {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("WVA_PALLAS_KERNEL", raising=False)
            if knob == "unset":
                mp.delenv("WVA_NATIVE_KERNEL", raising=False)
            else:
                mp.setenv("WVA_NATIVE_KERNEL", knob)
            mp.setattr(platform, "host_is_cpu_only", lambda: device == "cpu")
            mp.setattr(platform, "host_is_tpu", lambda: False)
            mp.setattr(mod(pkg, "ops.native"), "available", lambda: lib)
            translate = mod(pkg, "controller.translate")
            said[pkg] = []
            mp.setattr(translate.log, "warning",
                       lambda msg, *a, **k: said[pkg].append(msg))
            if pkg == JAX:
                picked[pkg] = translate.engine_backend()
            else:
                picked[pkg] = translate.engine_backend(torch.device(device))
                n = len(said[pkg])
                assert translate.engine_backend(device) == picked[pkg]
                assert said[pkg][n:] == said[pkg][:n]
                del said[pkg][n:]
    said_j, said_p = said[JAX], said[PORT]
    assert picked[PORT] == {"batched": own}.get(picked[JAX], picked[JAX])
    assert picked[PORT] == ("native" if lib and (knob == "true" or (
        knob == "unset" and device == "cpu")) else own)
    assert len(said_p) == len(said_j) == int(knob == "true" and not lib)
    assert all(s.startswith("WVA_NATIVE_KERNEL set but kernel unavailable")
               for s in said_p + said_j)


@pytest.mark.parametrize("knob,value,warned", [
    ("WVA_MESH_DEVICES", "all", True),
    ("WVA_MESH_DEVICES", "4", True),
    ("WVA_MESH_DEVICES", "", False),
    ("WVA_SHARDED_FLEET", "on", True),
    ("WVA_SHARDED_FLEET", "auto", False),
    ("WVA_SHARDED_FLEET", "off", False),
])
def test_meshes_are_none_and_warn_when_asked(knob, value, warned,
                                             monkeypatch):
    """The host backends take no mesh: both meshes are None for
    "native", with the reference's warning whenever a knob asks for
    sharding explicitly."""
    said, meshes = {}, {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("WVA_MESH_DEVICES", raising=False)
            mp.setenv("WVA_SHARDED_FLEET", "off")
            mp.setenv(knob, value)
            translate = mod(pkg, "controller.translate")
            said[pkg] = []
            mp.setattr(translate.log, "warning",
                       lambda msg, *a, **k: said[pkg].append(msg))
            args = ("native",) if pkg == JAX else ("native", "cpu")
            meshes[pkg] = (translate.engine_mesh(*args),
                           translate.sharded_fleet_mesh(*args))
    assert meshes[PORT] == meshes[JAX] == (None, None)
    assert len(said[PORT]) == len(said[JAX]) == int(warned)
    if warned:
        assert said[PORT][0].startswith(f"{knob} ignored")
        assert said[JAX][0].startswith(f"{knob} ignored")


def test_translation_helpers_equal_reference():
    raw = {"v5e-4": json.dumps({"chip": "v5e", "chips": "4", "cost": "80"}),
           "g2": json.dumps({"device": "L4", "cost": "7.5"})}
    out = [mod(pkg, "controller.translate").parse_accelerator_configmap(raw)
           for pkg in PKGS]
    assert out[1] == out[0]
    for s in ("60s", "2m30s", "1h", "150ms", "1.5m"):
        assert mod(PORT, "controller.translate").parse_duration(s) == \
            mod(JAX, "controller.translate").parse_duration(s)


# -- collector --------------------------------------------------------------


COLLECT_CASES = {
    "steady": dict(rps=12.5, success=12.0, prompt=256.0, gen=128.0,
                   ttft=0.12, itl=0.011),
    "nan-ttft": dict(rps=12.5, success=12.0, prompt=256.0, gen=128.0,
                     ttft=float("nan"), itl=0.011),
    "idle": dict(rps=0.0, success=0.0, prompt=None, gen=None, ttft=None,
                 itl=None),
    "cold-start": dict(rps=3.0, success=0.0, prompt=None, gen=None,
                       ttft=None, itl=None),
    "partial-scrape": dict(rps=8.0, success=7.5, prompt=None, gen=128.0,
                           ttft=0.2, itl=0.02),
    "stale-sample": dict(rps=8.0, success=7.5, prompt=256.0, gen=128.0,
                         ttft=0.2, itl=0.02, age=900.0),
}


def fake_prom(pkg: str, case: dict, clock):
    col = mod(pkg, "collector")
    prom = col.FakePromAPI(now=clock.now)
    m, ns = "m0", "ns0"
    age = case.get("age", 0.0)
    for q, v in ((col.true_arrival_rate_query(m, ns), case["rps"]),
                 (col.arrival_rate_query(m, ns), case["success"]),
                 (col.avg_prompt_tokens_query(m, ns), case["prompt"]),
                 (col.avg_generation_tokens_query(m, ns), case["gen"]),
                 (col.avg_ttft_query(m, ns), case["ttft"]),
                 (col.avg_itl_query(m, ns), case["itl"]),
                 (col.availability_query(m, ns), 1.0)):
        if v is None:
            prom.set_empty(q)
        else:
            prom.set_result(q, v, age_seconds=age)
    return prom


def outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__, str(e))
    return ("ok", asdict(out))


@pytest.mark.parametrize("case", list(COLLECT_CASES))
def test_collect_load_and_validation_equal_reference(case):
    clock = rc.Clock()
    got = []
    for pkg in PKGS:
        col = mod(pkg, "collector")
        prom = fake_prom(pkg, COLLECT_CASES[case], clock)
        fallback = col.CollectedLoad(arrival_rate_rpm=60.0,
                                     avg_input_tokens=300.0,
                                     avg_output_tokens=90.0,
                                     avg_ttft_ms=0.0, avg_itl_ms=0.0)
        got.append((
            outcome(lambda: col.collect_load(prom, "m0", "ns0",
                                             fallback=fallback)),
            outcome(lambda: col.validate_metrics_availability(
                prom, "m0", "ns0", now=clock.now()))))
    assert got[1] == got[0]


@pytest.mark.parametrize("age", [0.0, 299.0, 300.0, 301.0, 899.0, 900.0,
                                 901.0, 5000.0])
def test_load_cache_tiers_equal_reference(age):
    got = []
    for pkg in PKGS:
        col = mod(pkg, "collector")
        cache = col.LoadCache()
        load = col.CollectedLoad(arrival_rate_rpm=120.0,
                                 avg_input_tokens=128.0,
                                 avg_output_tokens=64.0, avg_ttft_ms=80.0,
                                 avg_itl_ms=9.0)
        cache.put("a:ns", load, 1000.0)
        cached, tier = cache.get("a:ns", 1000.0 + age)
        cache.prune({"b:ns"})
        got.append((tier, cache.tier("a:ns", 1000.0 + age),
                    None if cached is None else asdict(cached),
                    cache.get("a:ns", 1000.0)[1]))
    assert got[1] == got[0]


# -- the scalar analyzer and the drift watchdog -------------------------------


def analyzers(seed: int):
    rng = np.random.default_rng(seed)
    cfg = dict(max_batch_size=int(rng.choice([8, 64, 128, 256])),
               max_queue_size=int(rng.choice([0, 64, 640])))
    parms = dict(alpha=float(rng.uniform(3, 10)),
                 beta=float(rng.uniform(0.01, 0.05)),
                 gamma=float(rng.uniform(2, 8)),
                 delta=float(rng.uniform(0.02, 0.2)))
    size = dict(avg_input_tokens=int(rng.choice([0, 128, 1024])),
                avg_output_tokens=int(rng.choice([1, 64, 512])))
    out = []
    for pkg in PKGS:
        a = mod(pkg, "ops.analyzer")
        out.append((a, a.QueueAnalyzer(
            a.QueueConfig(parms=a.ServiceParms(**parms), **cfg),
            a.RequestSize(**size))))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("pct", [None, 0.9])
def test_scalar_analyzer_equals_reference(seed, pct):
    got = []
    for a, qa in analyzers(seed):
        rates = [qa.max_rate * f for f in (0.1, 0.5, 0.9)]
        got.append((
            outcome(lambda: qa.size(a.TargetPerf(ttft=400.0, itl=30.0,
                                                 tps=0.0),
                                    ttft_percentile=pct)),
            [asdict(qa.analyze(r)) for r in rates],
            qa.min_rate, qa.max_rate))
    assert got[1] == got[0]


def drift_inputs(pkg: str):
    translate = mod(pkg, "controller.translate")
    crd = mod(pkg, "controller.crd")
    acc_cm = translate.parse_accelerator_configmap(
        {"v5e-1": json.dumps({"chip": "v5e", "chips": "1", "cost": "20"}),
         "v5e-4": json.dumps({"chip": "v5e", "chips": "4", "cost": "80"})})
    spec = translate.create_system_data(acc_cm, {})
    for acc, a, b, g, d, mb in (("v5e-1", 6.973, 0.027, 5.2, 0.1, 64),
                                ("v5e-4", 3.2, 0.012, 2.4, 0.04, 192)):
        translate.add_profile_to_system_data(spec, "m0", crd.AcceleratorProfile(
            acc=acc, acc_count=1,
            perf_parms=crd.PerfParms(
                decode_parms={"alpha": str(a), "beta": str(b)},
                prefill_parms={"gamma": str(g), "delta": str(d)}),
            max_batch_size=mb))
    return spec


@pytest.mark.parametrize("acc,rpm,ttft,itl,replicas,stale", [
    ("v5e-1", 240.0, 60.0, 9.0, 2, False),
    ("v5e-4", 1800.0, 150.0, 14.0, 3, False),
    ("v5e-1", 0.0, 0.0, 0.0, 2, False),
    ("v5e-1", 9000.0, 900.0, 30.0, 1, False),
    ("v5e-4", 600.0, 80.0, 0.0, 1, False),
    ("v5e-1", 240.0, 60.0, 9.0, 2, True),
    ("v5e-1", 240.0, 60.0, 9.0, 0, False),
])
def test_drift_prediction_equals_reference(acc, rpm, ttft, itl, replicas,
                                           stale):
    got = []
    for pkg in PKGS:
        drift = mod(pkg, "controller.drift")
        col = mod(pkg, "collector")
        load = col.CollectedLoad(arrival_rate_rpm=rpm, avg_input_tokens=256.0,
                                 avg_output_tokens=128.0, avg_ttft_ms=ttft,
                                 avg_itl_ms=itl)
        reading = drift.predict_latency(drift_inputs(pkg), "m0", acc, load,
                                        replicas, stale=stale)
        got.append(None if reading is None else (
            asdict(reading), drift.within_tolerance(reading, 0.5)))
    assert got[1] == got[0]


# -- metrics and the device audit ---------------------------------------------


def test_device_audit_series_equal_reference():
    delta = {"retraces": {"decide_batch": 2}, "transfers": {"h2d": 15,
                                                           "d2h": 2},
             "compiles": [["bisect_kernel", 1.25]]}
    ej = mod(JAX, "metrics").MetricsEmitter()
    ep = mod(PORT, "metrics").MetricsEmitter()
    ej.emit_jax_audit(delta)
    ep.emit_device_audit(delta)
    series = ("inferno_jit_retraces_total",
              "inferno_jit_compile_seconds_count",
              "inferno_jit_compile_seconds_sum",
              "inferno_host_device_transfers_total")
    assert rc.samples(ep, series) == rc.samples(ej, series)
    assert rc.samples(ep, series)


def test_readback_and_arena_pack_feed_the_audit():
    from workload_variant_autoscaler_tpu_torch.obs import DEVICE_AUDIT
    from workload_variant_autoscaler_tpu_torch.ops.arena import CandidateArena
    from workload_variant_autoscaler_tpu_torch.utils import readback

    before = DEVICE_AUDIT.snapshot()
    readback(torch.zeros(3))
    rows = {name: [1.0, 2.0] for name in
            ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
             "ttft", "itl", "tps", "demand", "cost_rate")}
    rows.update(max_batch=[8, 16], min_replicas=[1, 1])
    CandidateArena().pack(rows, device=torch.device("cpu"),
                          dtype=torch.float64)
    delta = DEVICE_AUDIT.delta(before, DEVICE_AUDIT.snapshot())
    assert delta["transfers"] == {"d2h": 1, "h2d": 15}
    assert delta["retraces"] == {} and delta["compiles"] == []


def test_first_library_use_counts_as_one_compile(tmp_path, monkeypatch):
    from workload_variant_autoscaler_tpu_torch.obs import DEVICE_AUDIT
    from workload_variant_autoscaler_tpu_torch.ops import _build

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    built = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_compile", lambda name: (
        built.append(name), _build.library_path(name).touch()))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    before = DEVICE_AUDIT.snapshot()
    lib = _build.library("bisect_kernel")
    assert _build.library("bisect_kernel") is lib
    delta = DEVICE_AUDIT.delta(before, DEVICE_AUDIT.snapshot())
    assert built == ["bisect_kernel"]
    assert [fn for fn, _s in delta["compiles"]] == ["bisect_kernel"]


def test_cycle_profile_carries_the_device_audit(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    c = Cluster(variants=24, models=6)
    b = rc.build(PORT, c, rc.Clock(), rc.loads(c), device="cpu",
                 dtype=torch.float64)
    b.rec.reconcile()
    rec = b.rec.profiler.records()[0]
    transfers = rec.device["transfers"]
    assert transfers["h2d"] > 0 and transfers["d2h"] > 0
    assert rec.to_dict()["device"] == rec.device
    for direction, n in transfers.items():
        assert b.emitter.value("inferno_host_device_transfers_total",
                               direction=direction) == n


# -- the warm-up ---------------------------------------------------------------


@pytest.mark.parametrize("percentile", [None, 0.95])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warmup_runs_each_plan_entry_on_the_cpu(percentile, dtype,
                                                monkeypatch):
    """One decide_batch per plan entry through the kernel wrapper (its
    plain version here): the mean form for every group (a tail group's
    ITL rows), the tail form for the percentile group."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
    from workload_variant_autoscaler_tpu_torch.ops import fused

    vas, classes = cluster_vas(PORT, Cluster(variants=20, models=5,
                                             percentile=percentile))
    plan = mod(PORT, "controller.translate").warmup_plan(
        vas, service_class_cm=classes)
    calls = []
    orig = bk.bisect

    def spy(fcols, icols, clm, k_max, tail_pct=None):
        calls.append((tail_pct, fcols.shape[0], clm.dtype))
        return orig(fcols, icols, clm, k_max, tail_pct)

    monkeypatch.setattr(bk, "bisect", spy)
    for lanes, max_batch, pct in plan:
        fused.warmup(max_batch, lanes, pct, device="cpu", dtype=dtype)
    assert len(plan) == (2 if percentile else 1)
    assert sum(p is None for p, _r, _d in calls) == len(plan)
    assert [p for p, _r, _d in calls if p is not None] == \
        ([percentile] if percentile else [])
    assert {d for _p, _r, d in calls} == {dtype}


def test_warmup_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    from workload_variant_autoscaler_tpu_torch.ops import fused

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fused.warmup()
