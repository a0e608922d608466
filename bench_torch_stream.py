"""bench_torch_stream: load change -> published allocation lag, streamed
against polled, with the port's micro-cycles on the card.

The counterpart of bench_stream.py. It drives the port's streaming
reconcile core (stream/) against a 512-variant fleet (64 models, 8:1
sharing, so one event's scope is 8 variants; the Premium class, so every
micro-cycle that sizes runs B1 on the card) with the real ingest wire:
each event is a snappy-compressed protobuf remote-write request POSTed
through the mounted WSGI route, carrying a load step for one model. The
consumer thread (StreamCore.run) picks the event up, debounces it, runs
a scoped micro-cycle (prepare, solve, publish for that model's
variants, launching B1 from that thread) and the core's own lag meter,
the source of `inferno_stream_lag_seconds`, records observed ->
published wall time.

The polled baseline is recorded alongside from measurement and model:
one full 512-variant reconcile cycle is timed on the same cluster, and
the polled lag is `U(0, interval) + cycle_wall` (an event lands at a
uniformly random phase of the 60 s loop): p50 = interval/2 + wall, p99
= 0.99 * interval + wall, labeled `modeled`. The first WARMUP_EVENTS
events are left out of the distribution.

    python3 bench_torch_stream.py [--device cuda|cpu] [--smoke] [--out PATH]

`--smoke` runs 64 variants over 8 models, 10 events after 3 warm-up
events. Runs in float32 on `cuda` unless `--device cpu` is asked; raises
without CUDA. Prints ONE JSON line: bench_stream.py's keys, with
bench_torch_loop.where's keys and kernel_launches (B1/B2 launches and
sizing readbacks per micro-cycle of the events).
"""

from __future__ import annotations

import io
import json
import statistics
import sys
import threading
import time

import torch

from bench_torch_collect import cycle_launches, emit, launch_summary, parse_args
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.collector import (
    FakePromAPI,
    VLLM_FAMILY,
    arrival_rate_query,
    availability_query,
    avg_generation_tokens_query,
    avg_itl_query,
    avg_prompt_tokens_query,
    avg_ttft_query,
    fleet_arrival_rate_query,
    fleet_availability_query,
    fleet_avg_generation_tokens_query,
    fleet_avg_itl_query,
    fleet_avg_prompt_tokens_query,
    fleet_avg_ttft_query,
    fleet_true_arrival_rate_query,
    true_arrival_rate_query,
)
from workload_variant_autoscaler_tpu_torch.controller import (
    ACCELERATOR_CM_NAME,
    CONFIG_MAP_NAME,
    CONFIG_MAP_NAMESPACE,
    SERVICE_CLASS_CM_NAME,
    ConfigMap,
    Deployment,
    InMemoryKube,
    Reconciler,
    crd,
)
from workload_variant_autoscaler_tpu_torch.metrics import MetricsEmitter
from workload_variant_autoscaler_tpu_torch.stream import (
    encode_write_request,
    remote_write_middleware,
    snappy_compress,
)

N_VARIANTS = 512
N_MODELS = 64          # 8:1 variant:model sharing -> scope 8 per event
NS = "default"
INTERVAL_S = 60.0      # the polled baseline's GLOBAL_OPT_INTERVAL
BASE_RPM = 1800.0      # 30 req/s steady state
EVENTS = 50
WARMUP_EVENTS = 5


def model_name(i: int, n_models: int) -> str:
    return f"llama-8b-m{i % n_models}"


def seed_prom(store: FakePromAPI, n_models: int, rps: float = 30.0) -> None:
    fam = VLLM_FAMILY
    grouped = {
        fleet_true_arrival_rate_query(fam): rps,
        fleet_arrival_rate_query(fam): rps,
        fleet_avg_prompt_tokens_query(fam): 128.0,
        fleet_avg_generation_tokens_query(fam): 128.0,
        fleet_avg_ttft_query(fam): 0.2,
        fleet_avg_itl_query(fam): 0.012,
        fleet_availability_query(fam): 1.0,
    }
    for m_i in range(n_models):
        m = model_name(m_i, n_models)
        labels = {"model_name": m, "namespace": NS}
        for q, v in grouped.items():
            store.add_result(q, v, labels=labels)
        for q, v in (
            (availability_query(m, NS, fam), 1.0),
            (true_arrival_rate_query(m, NS, fam), rps),
            (arrival_rate_query(m, NS, fam), rps),
            (avg_prompt_tokens_query(m, NS, fam), 128.0),
            (avg_generation_tokens_query(m, NS, fam), 128.0),
            (avg_ttft_query(m, NS, fam), 0.2),
            (avg_itl_query(m, NS, fam), 0.012),
        ):
            store.set_result(q, v, labels=labels)


def build_cluster(n_variants: int, n_models: int, *, device=None,
                  dtype=None):
    """The event-path fleet: n_variants VAs over n_models models, the
    Reconciler on `device` in `dtype`. bench_torch_streamload.py and
    bench_torch_streamchaos.py reuse it."""
    kube = InMemoryKube(validate_schema=False)
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                 {"GLOBAL_OPT_INTERVAL": f"{INTERVAL_S:.0f}s",
                                  "WVA_DRIFT_TOLERANCE": "0"}))
    kube.put_configmap(ConfigMap(
        ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"v5e-1": json.dumps({"chip": "v5e", "chips": "1", "cost": "20.0"})},
    ))
    slos = "\n".join(
        f"  - model: {model_name(i, n_models)}\n"
        "    slo-tpot: 24\n    slo-ttft: 500"
        for i in range(n_models))
    kube.put_configmap(ConfigMap(
        SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"premium": f"name: Premium\npriority: 1\ndata:\n{slos}\n"},
    ))
    for i in range(n_variants):
        name = f"chat-{i}"
        kube.put_deployment(Deployment(name=name, namespace=NS,
                                       spec_replicas=1, status_replicas=1))
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(name=name, namespace=NS,
                                    labels={crd.ACCELERATOR_LABEL: "v5e-1"}),
            spec=crd.VariantAutoscalingSpec(
                model_id=model_name(i, n_models),
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=SERVICE_CLASS_CM_NAME, key="premium"),
                model_profile=crd.ModelProfile(accelerators=[
                    crd.AcceleratorProfile(
                        acc="v5e-1", acc_count=1,
                        perf_parms=crd.PerfParms(
                            decode_parms={"alpha": "6.973", "beta": "0.027"},
                            prefill_parms={"gamma": "5.2", "delta": "0.1"},
                        ),
                        max_batch_size=64,
                    ),
                ]),
            ),
        ))
    store = FakePromAPI()
    seed_prom(store, n_models)
    rec = Reconciler(kube=kube, prom=store, emitter=MetricsEmitter(),
                     sleep=lambda _s: None, device=device, dtype=dtype)
    return kube, rec


def write_request_body(model: str, rpm: float, ts_ms: int) -> bytes:
    labels = {"model_name": model, "namespace": NS}
    series = [({"__name__": name, **labels}, [(value, ts_ms)])
              for name, value in (
                  ("wva:stream:arrival_rpm", rpm),
                  ("wva:stream:avg_input_tokens", 128.0),
                  ("wva:stream:avg_output_tokens", 128.0),
                  ("wva:stream:avg_ttft_ms", 200.0),
                  ("wva:stream:avg_itl_ms", 12.0),
              )]
    return snappy_compress(encode_write_request(series))


def post_write(app, body: bytes) -> str:
    status: list[str] = []
    environ = {
        "PATH_INFO": "/api/v1/write",
        "REQUEST_METHOD": "POST",
        "CONTENT_LENGTH": str(len(body)),
        "HTTP_CONTENT_ENCODING": "snappy",
        "wsgi.input": io.BytesIO(body),
    }
    list(app(environ, lambda st, _h: status.append(st)))
    return status[0]


def run(n_variants: int = N_VARIANTS, n_models: int = N_MODELS,
        events: int = EVENTS, warmup: int = WARMUP_EVENTS, *, device=None,
        dtype=None) -> dict:
    place = where(device, dtype)
    kube, rec = build_cluster(n_variants, n_models, device=device,
                              dtype=dtype)
    core = rec.ensure_stream_core()
    app = remote_write_middleware(core)(
        lambda _e, _s: [b""])  # the exposition app is not under test

    # capture every lag observation the core itself meters (the source
    # of inferno_stream_lag_seconds)
    lags: list[float] = []
    lag_seen = threading.Event()
    orig_lag = rec.emitter.emit_stream_lag

    def capture(seconds: float) -> None:
        orig_lag(seconds)
        lags.append(seconds)
        lag_seen.set()

    rec.emitter.emit_stream_lag = capture

    # polled baseline: one timed full cycle on the warmed cluster
    rec.reconcile()                      # cold: build, launch, publish
    t0 = time.perf_counter()
    rec.reconcile()
    if rec.device.type == "cuda":
        torch.cuda.synchronize(rec.device)
    cycle_wall_ms = (time.perf_counter() - t0) * 1000.0

    stop = threading.Event()
    consumer = threading.Thread(target=core.run, args=(stop,),
                                name="bench-stream-consumer", daemon=True)
    levels = (4800.0, 9600.0)            # alternate well past epsilon
    measured: list[float] = []
    with cycle_launches() as rows:
        consumer.start()
        deadline = time.monotonic() + 30.0
        while core.state.snapshot is None and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            for i in range(warmup + events):
                model = model_name(i % n_models, n_models)
                rpm = levels[(i // n_models) % len(levels)] + i
                lag_seen.clear()
                before = len(lags)
                status = post_write(
                    app, write_request_body(model, rpm,
                                            int(time.time() * 1000)))
                if not status.startswith("204"):
                    raise RuntimeError(f"event {i}: the door answered "
                                       f"{status}")
                t_wait = time.monotonic() + 10.0
                while len(lags) <= before and time.monotonic() < t_wait:
                    lag_seen.wait(0.005)
                if len(lags) <= before:
                    raise RuntimeError(f"event {i} never published")
                if i >= warmup:
                    measured.append(lags[-1])
        finally:
            stop.set()
            core.queue.request_full("watch")   # wake the consumer to exit
            consumer.join(timeout=5.0)

    measured_ms = sorted(m * 1000.0 for m in measured)

    def pct(p: float) -> float:
        idx = min(int(round(p * (len(measured_ms) - 1))),
                  len(measured_ms) - 1)
        return measured_ms[idx]

    # the pushed loads must actually have re-sized the fleet: sample a
    # variant of the LAST pushed model (no backstop pass ran after it)
    last_model_i = (warmup + events - 1) % n_models
    sample_va = kube.get_variant_autoscaling(f"chat-{last_model_i}", NS)
    scope = n_variants // n_models
    out = {
        "metric": "stream_lag_ms_p99",
        "bench": "stream",
        "variants": n_variants,
        "models": n_models,
        "scope_per_event": scope,
        "debounce_ms": core.queue.debounce_s * 1000.0,
        "ingest": "remote-write",
        "events": len(measured_ms),
        "warmup_events": warmup,
        "value": round(pct(0.99), 3),
        "unit": "ms load-change->published, p99",
        "p50_ms": round(pct(0.50), 3),
        "p99_ms": round(pct(0.99), 3),
        "max_ms": round(measured_ms[-1], 3),
        "mean_ms": round(statistics.fmean(measured_ms), 3),
        "decision_check": {
            "published_replicas": sample_va.status
            .desired_optimized_alloc.num_replicas,
            "resized_from_push": sample_va.status
            .desired_optimized_alloc.num_replicas > 2,
        },
        "polled_baseline": {
            "modeled": True,
            "interval_s": INTERVAL_S,
            "cycle_wall_ms": round(cycle_wall_ms, 1),
            "lag_p50_ms": round(INTERVAL_S / 2.0 * 1000.0 + cycle_wall_ms, 1),
            "lag_p99_ms": round(INTERVAL_S * 0.99 * 1000.0 + cycle_wall_ms, 1),
        },
        **place,
        "kernel_launches": launch_summary(rows),
    }
    out["vs_polled_p50"] = round(
        out["polled_baseline"]["lag_p50_ms"] / max(out["p50_ms"], 1e-9), 1)
    return out


def main(argv=None) -> int:
    opts = parse_args("bench_torch_stream.py", argv, smoke=True)
    if opts.smoke:
        out = run(n_variants=64, n_models=8, events=10, warmup=3,
                  device=opts.device)
        out["smoke"] = True
    else:
        out = run(device=opts.device)
    return emit(out, opts.out)


if __name__ == "__main__":
    sys.exit(main())
