"""The port's emulator against the JAX package's, on the same seeds.

The discrete-event engine, the load generator, the Prometheus sinks and
the sim-time Prometheus (`SimPromAPI`) are host code copied into the
port; the twin's tick-for-tick determinism rests on them drawing the
same random numbers in the same order. Each case runs the same seeded
simulation through both packages and compares:

- the request and token event stream (arrivals, every finished request,
  every TTFT and inter-token gap), exactly;
- the Prometheus exposition of the sinks, line for line (less the
  client library's wall-clock `_created` samples);
- every SimPromAPI answer (instant and range queries), exactly, also
  under a FaultPlan (the same JSON loaded by each package's own
  `FaultPlan`): the same samples, or the same exception;
- `experiment.fit_linear`, `run_fixed_batch`, `rate_sweep` and
  `fit_profile`, exactly;
- `server.config_from_env` and `build_app`'s routes and client-error
  answers.
"""

import asyncio
import dataclasses

import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client import generate_latest

import workload_variant_autoscaler_tpu.collector as jcol
import workload_variant_autoscaler_tpu.emulator as je
import workload_variant_autoscaler_tpu.faults as jf
import workload_variant_autoscaler_tpu_torch.collector as pcol
import workload_variant_autoscaler_tpu_torch.emulator as pe
import workload_variant_autoscaler_tpu_torch.faults as pf
from workload_variant_autoscaler_tpu.emulator import experiment as jx
from workload_variant_autoscaler_tpu.emulator import server as js
from workload_variant_autoscaler_tpu_torch.emulator import experiment as px
from workload_variant_autoscaler_tpu_torch.emulator import server as ps

PKGS = {"jax": (je, jcol, jf), "port": (pe, pcol, pf)}
SCHEDULE = [(60, 300), (60, 2400), (30, 0), (60, 900)]
FAULTS = ('{"seed": 3, "rules": ['
          '{"kind": "prom-timeout", "after_s": 40, "until_s": 60},'
          '{"kind": "prom-nan", "after_s": 80, "until_s": 100,'
          ' "probability": 0.5},'
          '{"kind": "prom-partial", "after_s": 120, "until_s": 140},'
          '{"kind": "prom-clock-skew", "after_s": 150, "until_s": 170,'
          ' "skew_s": 30},'
          '{"kind": "prom-outage-window", "after_s": 185, "until_s": 195}'
          ']}')


def config(pkg, **kw):
    e = PKGS[pkg][0]
    return e.SliceModelConfig(
        model_name="m", slice_name="v5e-4", alpha=6.973, beta=0.027,
        gamma=5.2, delta=0.1, max_batch_size=32, hbm_gb=16.0,
        model_size_gb=8.0, kv_mb_per_token=0.5, **kw)


def simulate(pkg, dist, family="vllm", faults=None, seed=5):
    """A seeded run of one fleet: (recording sink, Prometheus sink, the
    SimPromAPI scraped every 5 s, the answers collected on the way)."""
    e, col, f = PKGS[pkg]
    rec = e.RecordingSink()
    prom_sink = e.PrometheusSink("m", "default", family=family)

    class Fan(e.MetricsSink):
        def __getattribute__(self, name):
            if name.startswith(("on_", "set_")):
                def both(*args):
                    getattr(rec, name)(*args)
                    getattr(prom_sink, name)(*args)
                return both
            return object.__getattribute__(self, name)

    fleet = e.Fleet(config(pkg), Fan(), replicas=2)
    sim = e.Simulation(fleet, seed=seed)
    plan = None if faults is None else f.FaultPlan.from_json(faults)
    prom = e.SimPromAPI(prom_sink, "m", "default", fault_plan=plan)
    gen = e.PoissonLoadGenerator(
        sim, schedule=SCHEDULE,
        tokens=e.TokenDistribution(128, 96, dist), seed=seed + 1)
    gen.start()
    answers = []

    def tick(now_ms):
        prom.scrape(now_ms)
        if plan is not None:
            plan.begin_cycle()
        if now_ms == 120_000.0:
            fleet.set_replicas(3, now_ms)
            sim.kick()
        if now_ms == 170_000.0:
            fleet.set_replicas(1, now_ms)
            sim.kick()
        if now_ms % 10_000.0 == 0.0:
            answers.append(ask(col, prom, family))

    sim.run_until(210_000.0, on_tick=tick, tick_ms=5000.0)
    return rec, prom_sink, prom, answers, gen.generated


def queries(col, family_name):
    fam = col.METRIC_FAMILIES[family_name]
    out = ["up", col.availability_query("m", "default", fam),
           col.fleet_availability_query(fam)]
    for name in dir(col):
        if name.endswith("_query") and not name.startswith(
                ("availability", "fleet_")):
            fn = getattr(col, name)
            try:
                out.append(fn("m", "default", fam))
            except TypeError:
                continue
    return [q for q in out if q]


def ask(col, prom, family_name):
    """Every query's answer (labels, value, timestamp) or exception."""
    out = []
    for q in queries(col, family_name):
        try:
            out.append((q, [(s.labels, s.value, s.timestamp)
                            for s in prom.query(q)]))
        except Exception as e:  # noqa: BLE001 — the same error is the answer
            out.append((q, type(e).__name__, str(e)))
    return out


def exposition(sink) -> list:
    """The sink's /metrics text without the `_created` samples (wall-clock
    creation times of the client library's metric objects)."""
    return [ln for ln in generate_latest(sink.registry).decode().splitlines()
            if "_created" not in ln]


def without_created(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if not k.endswith("_created")}


def request_view(r):
    return dataclasses.astuple(r)


@pytest.mark.parametrize("dist", ["deterministic", "uniform", "lognormal"])
def test_event_stream_equals_jax(dist):
    j = simulate("jax", dist)
    p = simulate("port", dist)
    assert p[4] == j[4] and j[4] > 100
    assert p[0].arrivals == j[0].arrivals
    assert [request_view(r) for r in p[0].finished] == \
        [request_view(r) for r in j[0].finished]
    assert p[0].ttfts_ms == j[0].ttfts_ms
    assert p[0].itls_ms == j[0].itls_ms
    assert exposition(p[1]) == exposition(j[1])
    assert without_created(p[1].counters()) == \
        without_created(j[1].counters())


@pytest.mark.parametrize("family", ["vllm", "jetstream"])
def test_simprom_answers_equal_jax(family):
    j = simulate("jax", "uniform", family=family)
    p = simulate("port", "uniform", family=family)
    assert exposition(p[1]) == exposition(j[1])
    assert p[3] == j[3]
    assert len(p[3]) == 21
    jfam = jcol.METRIC_FAMILIES[family]
    pfam = pcol.METRIC_FAMILIES[family]
    for jq, pq in ((jcol.avg_itl_query("m", "default", jfam),
                    pcol.avg_itl_query("m", "default", pfam)),
                   (jcol.avg_running_query("m", "default", jfam),
                    pcol.avg_running_query("m", "default", pfam))):
        assert pq == jq
        a = [(s.labels, s.value, s.timestamp)
             for s in j[2].query_range(jq, 30.0, 200.0, 15.0)]
        b = [(s.labels, s.value, s.timestamp)
             for s in p[2].query_range(pq, 30.0, 200.0, 15.0)]
        assert b == a and a


def test_simprom_answers_under_a_fault_plan_equal_jax():
    j = simulate("jax", "lognormal", faults=FAULTS)
    p = simulate("port", "lognormal", faults=FAULTS)
    assert p[3] == j[3]
    errors = {a[1] for tick in j[3] for a in tick if len(a) == 3}
    assert errors, "the fault plan raised nothing"
    assert p[2].fault_plan.trips == j[2].fault_plan.trips
    assert p[2].fault_plan.trips


def test_multi_prom_dispatch_equals_jax():
    out = {}
    for pkg, (e, col, _f) in PKGS.items():
        sinks = [e.PrometheusSink(m, "ns") for m in ("a", "b")]
        backends = [e.SimPromAPI(s, m, "ns") for s, m in zip(sinks, "ab")]
        multi = e.MultiPromAPI(backends)
        for s in sinks:
            s.on_arrival(e.Request(req_id=0, in_tokens=10, out_tokens=5,
                                   arrival_ms=0.0))
        multi.scrape(5000.0)
        multi.scrape(65000.0)
        q = col.true_arrival_rate_query("a", "ns")
        out[pkg] = ([(s.labels, s.value) for s in multi.query(q)],
                    [(s.labels, s.value) for s in multi.query("up")])
        with pytest.raises(ValueError, match="duplicate"):
            e.MultiPromAPI(backends + backends[:1])
    assert out["port"] == out["jax"]


def test_loadgen_schedule_helpers_equal_jax():
    sched = [(30, 120), (0, 50), (45, 0), (60, 600)]
    for t in (0.0, 29.9, 30.0, 50.0, 75.0, 75.001, 134.0, 136.0, 500.0):
        assert pe.rate_at(t, sched) == je.rate_at(t, sched)
    assert pe.total_duration_s(sched) == je.total_duration_s(sched)
    with pytest.raises(ValueError):
        pe.TokenDistribution(1, 1, "zipf")


def test_experiment_fits_equal_jax():
    xs, ys = [1, 2, 4, 8, 16], [7.1, 7.0, 7.2, 7.3, 7.5]
    assert px.fit_linear(xs, ys) == jx.fit_linear(xs, ys)
    assert px.fit_linear([], []) == jx.fit_linear([], [])
    assert px.fit_linear([3], [2.5]) == jx.fit_linear([3], [2.5])
    assert px.fit_linear([2, 2], [1, 3]) == jx.fit_linear([2, 2], [1, 3])
    for batch in (1, 8):
        a = jx.run_fixed_batch(config("jax"), batch, rounds=3)
        b = px.run_fixed_batch(config("port"), batch, rounds=3)
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
    a = jx.fit_profile(config("jax"), batches=[1, 4, 16])
    b = px.fit_profile(config("port"), batches=[1, 4, 16])
    assert b == a
    a = jx.rate_sweep(config("jax"), rates_rps=[2.0, 6.0], duration_s=40.0)
    b = px.rate_sweep(config("port"), rates_rps=[2.0, 6.0], duration_s=40.0)
    assert b == a


def test_server_config_from_env_equals_jax(monkeypatch):
    assert dataclasses.asdict(ps.config_from_env()) == \
        dataclasses.asdict(js.config_from_env())
    for k, v in {"MODEL_NAME": "llama", "SLICE_NAME": "v6e-4",
                 "ALPHA": "3.5", "BETA": "0.02", "GAMMA": "4",
                 "DELTA": "0.05", "MAX_BATCH_SIZE": "96", "HBM_GB": "32",
                 "MODEL_SIZE_GB": "16", "KV_MB_PER_TOKEN": "0.25"}.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(ps.config_from_env())
    assert got == dataclasses.asdict(js.config_from_env())
    assert got["max_batch_size"] == 96 and got["alpha"] == 3.5


async def _answers(mod, cfg, monkeypatch):
    monkeypatch.setenv("WVA_FAULT_PLAN", FAULTS)
    app = mod.build_app(config=cfg, with_prom_api=True)
    routes = sorted((r.method, r.resource.canonical)
                    for r in app.router.routes())
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = [routes]
        for path, body in (("/v1/chat/completions", "not json"),
                           ("/v1/chat/completions", "[1]"),
                           ("/v1/chat/completions",
                            '{"messages": ["x"]}')):
            r = await client.post(path, data=body)
            out.append((r.status, await r.json()))
        for q in ("query=up&start=1", "query=up&start=2&end=1&step=1",
                  "query=up&start=0&end=1&step=0"):
            r = await client.get(f"/api/v1/query_range?{q}")
            out.append((r.status, await r.json()))
        r = await client.get("/metrics")
        out.append((r.status, r.content_type))
        return out
    finally:
        await client.close()


def test_build_app_routes_and_client_errors_equal_jax(monkeypatch):
    a = asyncio.run(_answers(js, config("jax"), monkeypatch))
    b = asyncio.run(_answers(ps, config("port"), monkeypatch))
    assert b == a
    assert ("GET", "/api/v1/query_range") in a[0]
    assert [s for s, _ in a[1:7]] == [400] * 6
    monkeypatch.setenv("WVA_FAULT_PLAN", "{not json")
    for mod, pkg in ((js, "jax"), (ps, "port")):
        with pytest.raises(ValueError):
            mod.build_app(config=config(pkg), with_prom_api=True)
