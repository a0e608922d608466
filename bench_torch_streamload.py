"""bench_torch_streamload: sustained ingest throughput through the real
door, with the port's micro-cycles on the card.

The counterpart of bench_streamload.py. Three phases, one JSON line:

1. **Door throughput**: real snappy+protobuf remote-write POSTs driven
   through the mounted WSGI route, each carrying a full fleet sweep of
   series (64 models), measured as sustained series/s with per-POST
   admission latency and every shed accounted by reason. Two lanes: the
   recording-rule contract (`wva:stream:*`, 120 POSTs) and the raw
   vLLM-counter pushdown contract (`vllm:*`, 90 POSTs). No consumer
   runs, so nothing sizes in this phase (kernel_launches says so).
2. **Pushdown equivalence**: two identical clusters fed the same load
   trajectory, one as pre-aggregated rule series, one as raw monotonic
   counters, must publish identical per-variant decisions at every
   step; a third with `WVA_STREAM_PUSHDOWN=off` must ignore raw series.
3. **Pool-scoped limited mode**: a two-pool fleet under
   WVA_LIMITED_MODE with node inventory; flips inside one pool's
   component re-solve only that component, a cross-component storm
   escalates to one full pass and coalesces what follows.

Phases 2 and 3 size through the cores' micro-cycles (`process_once`),
B1 on the card (the Premium class). WVA_STREAM_DEBOUNCE_MS=0 holds for
each phase's duration (bench_streamload.py sets it when imported).

    python3 bench_torch_streamload.py [--device cuda|cpu] [--smoke] [--out PATH]

`check` keeps every gate of bench_streamload.py, split into the
deterministic invariants and the wall-clock budgets (>= 10,000 series/s;
p99 admission < 250 ms per lane); the CLI exits 1 when either fails.
`--smoke` runs 16 models, 20 + 15 POSTs and the small phases 2 and 3,
and, as bench_streamload.py's smoke does, sets no rate floor. Runs in
float32 on `cuda` unless `--device cpu` is asked; raises without CUDA.
"""

from __future__ import annotations

import io
import json
import sys
import time

from bench_torch_collect import (
    cycle_launches,
    emit,
    knobs,
    launch_summary,
    parse_args,
)
from bench_torch_loop import where
from bench_torch_stream import (
    INTERVAL_S,
    NS,
    build_cluster,
    model_name,
    seed_prom,
)
from workload_variant_autoscaler_tpu_torch.collector import (
    CollectedLoad,
    FakePromAPI,
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
from workload_variant_autoscaler_tpu_torch.controller.kube import Node
from workload_variant_autoscaler_tpu_torch.metrics import (
    LANE_COALESCED,
    LANE_FULL,
    LANE_SCOPED,
    MetricsEmitter,
)
from workload_variant_autoscaler_tpu_torch.stream import (
    encode_write_request,
    remote_write_middleware,
    snappy_compress,
)

TARGET_SERIES_PER_S = 10_000.0
ADMIT_BUDGET_MS = 250.0

N_MODELS = 64                # fleet sweep per POST: one series set/model
RULE_POSTS = 120
RAW_POSTS = 90
# deterministic drains: phases 2 and 3 crank the consumer synchronously
DEBOUNCE_OFF = {"WVA_STREAM_DEBOUNCE_MS": "0"}

# exact-derivation load shape: every value is a binary fraction, so the
# ledger's delta arithmetic reproduces the rule series bit-for-bit
IN_TOK = 128.0
OUT_TOK = 64.0
TTFT_S = 0.25                # -> 250.0 ms exactly
ITL_S = 0.015625             # -> 15.625 ms exactly
TRAJECTORY_RPM = (4800.0, 9600.0, 2400.0, 7200.0, 1200.0, 9600.0)

RULE_FIELDS = ("wva:stream:arrival_rpm", "wva:stream:avg_input_tokens",
               "wva:stream:avg_output_tokens", "wva:stream:avg_ttft_ms",
               "wva:stream:avg_itl_ms")


def post(app, body: bytes) -> tuple[str, dict]:
    status: list = []
    headers: dict = {}

    def start_response(st, hs):
        status.append(st)
        headers.update(hs)

    environ = {"PATH_INFO": "/api/v1/write", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)),
               "HTTP_CONTENT_ENCODING": "snappy",
               "wsgi.input": io.BytesIO(body)}
    list(app(environ, start_response))
    return status[0], headers


def rule_sweep_body(n_models: int, rpm_of, ts_ms: int,
                    in_tok=IN_TOK, out_tok=OUT_TOK,
                    ttft_ms=TTFT_S * 1000.0,
                    itl_ms=ITL_S * 1000.0) -> bytes:
    """One request carrying the five rule series for every model."""
    series = []
    for i in range(n_models):
        labels = {"model_name": model_name(i, n_models), "namespace": NS}
        for name, value in zip(RULE_FIELDS,
                               (rpm_of(i), in_tok, out_tok,
                                ttft_ms, itl_ms)):
            series.append(({"__name__": name, **labels},
                           [(value, ts_ms)]))
    return snappy_compress(encode_write_request(series))


def raw_sweep_body(n_models: int, cum_req_of, ts_ms: int) -> bytes:
    """One request carrying the seven raw vLLM counters for every model
    (cumulative values derived from the running request total so the
    per-request averages are constant and float-exact)."""
    series = []
    for i in range(n_models):
        labels = {"model_name": model_name(i, n_models), "namespace": NS,
                  "instance": "pod-0"}
        req = cum_req_of(i)
        for name, value in (
            ("vllm:request_success_total", req),
            ("vllm:prompt_tokens_total", req * IN_TOK),
            ("vllm:generation_tokens_total", req * OUT_TOK),
            ("vllm:time_to_first_token_seconds_sum", req * TTFT_S),
            ("vllm:time_to_first_token_seconds_count", req),
            ("vllm:time_per_output_token_seconds_sum", req * ITL_S),
            ("vllm:time_per_output_token_seconds_count", req),
        ):
            series.append(({"__name__": name, **labels},
                           [(value, ts_ms)]))
    return snappy_compress(encode_write_request(series))


def capture_sheds(core) -> dict:
    sheds: dict[str, int] = {}
    orig = core.emitter.emit_stream_shed

    def capture(reason: str) -> None:
        orig(reason)
        sheds[reason] = sheds.get(reason, 0) + 1

    core.emitter.emit_stream_shed = capture
    return sheds


def _lane(bodies: list, app, per_post: int, n_models: int) -> dict:
    """POST every body through the door; the lane's throughput and
    admission latencies."""
    lat: list[float] = []
    t0 = time.perf_counter()
    for body in bodies:
        t1 = time.perf_counter()
        status, _ = post(app, body)
        lat.append((time.perf_counter() - t1) * 1000.0)
        if not status.startswith("204"):
            raise RuntimeError(f"throughput: the door answered {status}")
    wall = time.perf_counter() - t0
    n_series = len(bodies) * n_models * per_post
    lat.sort()
    return {
        "posts": len(bodies), "series": n_series,
        "groups_per_post": n_models,
        "wall_s": round(wall, 3),
        "series_per_s": round(n_series / wall, 1),
        "p99_admit_ms": round(lat[min(int(round(0.99 * (len(lat) - 1))),
                                      len(lat) - 1)], 3),
        "max_admit_ms": round(lat[-1], 3),
    }


# -- phase 1: door throughput ----------------------------------------------


def run_throughput(n_models: int, rule_posts: int, raw_posts: int, *,
                   device=None, dtype=None) -> dict:
    with knobs(**DEBOUNCE_OFF), cycle_launches() as rows:
        _kube, rec = build_cluster(n_models, n_models, device=device,
                                   dtype=dtype)
        core = rec.ensure_stream_core()
        app = remote_write_middleware(core)(lambda _e, _s: [b""])
        sheds = capture_sheds(core)
        out: dict = {}

        now_ms = int(time.time() * 1000)
        # rules lane: pre-encode all bodies (the bench measures the DOOR
        # — decode, vet, quantize, stripe — not the sender's encoder);
        # the rule window sits well before the raw lane's so the
        # raw-derived merges never read as out-of-order
        bodies = [rule_sweep_body(
            n_models, lambda i, k=k: 2400.0 + k + i,
            now_ms - 600_000 + k)
            for k in range(rule_posts)]
        out["rules"] = _lane(bodies, app, len(RULE_FIELDS), n_models)

        # raw lane: monotonic counters, 1 s sample spacing
        base_ms = now_ms - (raw_posts + 1) * 1000
        bodies = [raw_sweep_body(
            n_models, lambda i, k=k: (k + 1) * 60.0 + i, base_ms + k * 1000)
            for k in range(raw_posts)]
        out["raw"] = _lane(bodies, app, 7, n_models)
    out["sheds_by_reason"] = dict(sorted(sheds.items()))
    out["series_admitted"] = (out["rules"]["series"]
                              + out["raw"]["series"]
                              - sum(sheds.values()))
    out["kernel_launches"] = launch_summary(rows)
    return out


# -- phase 2: pushdown equivalence -----------------------------------------


def fleet_decisions(kube, n_variants: int) -> list:
    out = []
    for i in range(n_variants):
        va = kube.get_variant_autoscaling(f"chat-{i}", NS)
        alloc = va.status.desired_optimized_alloc
        out.append([va.name, alloc.accelerator, alloc.num_replicas])
    return out


def run_equivalence(n_models: int = 8, steps: int = len(TRAJECTORY_RPM),
                    variants_per_model: int = 2, *, device=None,
                    dtype=None) -> dict:
    n_variants = n_models * variants_per_model
    with knobs(**DEBOUNCE_OFF), cycle_launches() as rows:
        clusters = {}
        for key in ("rules", "raw", "off"):
            kube, rec = build_cluster(n_variants, n_models, device=device,
                                      dtype=dtype)
            core = rec.ensure_stream_core()
            core.process_once()              # baseline full pass
            app = remote_write_middleware(core)(lambda _e, _s: [b""])
            clusters[key] = (kube, rec, core, app, capture_sheds(core))

        now_ms = int(time.time() * 1000)
        ts0 = now_ms - (steps + 1) * 60_000  # all samples in the past
        rates = TRAJECTORY_RPM[:steps]

        # raw baseline sample at ts0 (first sight: ledger baselines only)
        _kube, _rec, core, app, _ = clusters["raw"]
        status, _h = post(app, raw_sweep_body(
            n_models, lambda i: 1000.0 + i, ts0))
        if not status.startswith("204"):
            raise RuntimeError(f"equivalence: the door answered {status}")
        core.process_once()

        # off-mode: the same raw payload must be INVISIBLE (no groups,
        # no sheds, no store writes) — the rule-based door byte-for-byte
        _okube, _orec, ocore, oapp, osheds = clusters["off"]
        with knobs(WVA_STREAM_PUSHDOWN="off"):
            before = len(ocore._store)
            status, headers = post(oapp, raw_sweep_body(
                n_models, lambda i: 1000.0 + i, ts0))
            off_clean = (status.startswith("204")
                         and headers.get("X-Ingested-Groups") == "0"
                         and len(ocore._store) == before
                         and not osheds)

        trajectory = []
        equal = True
        cum = [1000.0 + i for i in range(n_models)]
        for k, rpm in enumerate(rates):
            ts = ts0 + (k + 1) * 60_000
            # rule cluster: the pre-aggregated truth
            _kube, _rec, core, app, _ = clusters["rules"]
            status, _h = post(app, rule_sweep_body(
                n_models, lambda _i: rpm, ts))
            if not status.startswith("204"):
                raise RuntimeError(f"equivalence: the door answered "
                                   f"{status}")
            core.process_once()
            # raw cluster: one minute's worth of counter growth at the
            # same rate (delta == rpm over dt == 60000 ms -> exact rpm)
            for i in range(n_models):
                cum[i] += rpm
            _kube2, _rec2, core2, app2, _ = clusters["raw"]
            status, _h = post(app2, raw_sweep_body(
                n_models, lambda i: cum[i], ts))
            if not status.startswith("204"):
                raise RuntimeError(f"equivalence: the door answered "
                                   f"{status}")
            core2.process_once()
            d_rules = fleet_decisions(clusters["rules"][0], n_variants)
            d_raw = fleet_decisions(clusters["raw"][0], n_variants)
            step_equal = d_rules == d_raw
            equal = equal and step_equal
            trajectory.append({"step": k, "rpm": rpm, "equal": step_equal,
                               "replicas": [r[2] for r in d_rules]})
    return {
        "models": n_models, "variants": n_variants,
        "steps": len(rates),
        "pushdown_equals_rules": equal,
        "off_restores_rule_door": bool(off_clean),
        "trajectory": trajectory,
        "kernel_launches": launch_summary(rows),
    }


# -- phase 3: pool-scoped limited mode -------------------------------------


def build_two_pool_cluster(n_models: int = 8, per_model: int = 2, *,
                           device=None, dtype=None):
    """Two disjoint chip pools: models 0..n/2-1 ride v5e, the rest v6e,
    so a flip in one half's models stays inside one pool-connected
    component. WVA_LIMITED_MODE is on from the start and the kube holds
    TPU node inventory for both generations."""
    kube = InMemoryKube(validate_schema=False)
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                 {"GLOBAL_OPT_INTERVAL": f"{INTERVAL_S:.0f}s",
                                  "WVA_DRIFT_TOLERANCE": "0",
                                  "WVA_LIMITED_MODE": "true"}))
    kube.put_configmap(ConfigMap(
        ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"v5e-1": json.dumps({"chip": "v5e", "chips": "1",
                              "cost": "20.0"}),
         "v6e-1": json.dumps({"chip": "v6e", "chips": "1",
                              "cost": "30.0"})},
    ))
    slos = "\n".join(
        f"  - model: {model_name(i, n_models)}\n"
        "    slo-tpot: 24\n    slo-ttft: 500"
        for i in range(n_models))
    kube.put_configmap(ConfigMap(
        SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"premium": f"name: Premium\npriority: 1\ndata:\n{slos}\n"},
    ))
    for gen, accel_label in (("v5e", "tpu-v5-lite-podslice"),
                             ("v6e", "tpu-v6e-slice")):
        for n in range(2):
            kube.put_node(Node(
                name=f"{gen}-node-{n}",
                labels={"cloud.google.com/gke-tpu-accelerator":
                        accel_label},
                tpu_capacity=32))
    half = n_models // 2
    n_variants = n_models * per_model
    for i in range(n_variants):
        model_i = i % n_models
        acc = "v5e-1" if model_i < half else "v6e-1"
        name = f"chat-{i}"
        kube.put_deployment(Deployment(name=name, namespace=NS,
                                       spec_replicas=1, status_replicas=1))
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(name=name, namespace=NS,
                                    labels={crd.ACCELERATOR_LABEL: acc}),
            spec=crd.VariantAutoscalingSpec(
                model_id=model_name(model_i, n_models),
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=SERVICE_CLASS_CM_NAME, key="premium"),
                model_profile=crd.ModelProfile(accelerators=[
                    crd.AcceleratorProfile(
                        acc=acc, acc_count=1,
                        perf_parms=crd.PerfParms(
                            decode_parms={"alpha": "6.973",
                                          "beta": "0.027"},
                            prefill_parms={"gamma": "5.2",
                                           "delta": "0.1"},
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


def run_limited(n_models: int = 8, per_model: int = 2,
                scoped_events: int = 6, *, device=None,
                dtype=None) -> dict:
    with knobs(WVA_STREAM_LAG_BUDGET_MS="5000", **DEBOUNCE_OFF), \
            cycle_launches() as rows:
        _kube, rec = build_two_pool_cluster(n_models, per_model,
                                            device=device, dtype=dtype)
        core = rec.ensure_stream_core()
        lanes: dict[str, int] = {}
        orig_lane = rec.emitter.emit_stream_limited

        def capture(lane: str) -> None:
            orig_lane(lane)
            lanes[lane] = lanes.get(lane, 0) + 1

        rec.emitter.emit_stream_limited = capture
        core.process_once()             # full pass freezes capacity +
        n_variants = n_models * per_model   # pool components
        component = n_variants // 2
        half = n_models // 2
        now_ms = int(time.time() * 1000)

        # alternating single-component flips: each must re-solve ONLY
        # its component (processed == component size, scoped lane)
        scoped_ok = True
        app = remote_write_middleware(core)(lambda _e, _s: [b""])
        for k in range(scoped_events):
            m_i = (k % half) + (0 if k % 2 == 0 else half)
            series = [({"__name__": name,
                        "model_name": model_name(m_i, n_models),
                        "namespace": NS}, [(value, now_ms + k)])
                      for name, value in zip(
                          RULE_FIELDS,
                          (4800.0 + 600.0 * k, IN_TOK, OUT_TOK,
                           TTFT_S * 1000.0, ITL_S * 1000.0))]
            body = snappy_compress(encode_write_request(series))
            status, _h = post(app, body)
            if not status.startswith("204"):
                raise RuntimeError(f"limited: the door answered {status}")
            results = core.process_once()
            scoped_ok = scoped_ok and (
                len(results) == 1
                and len(results[0].processed) == component)
        scoped_lanes = lanes.get(LANE_SCOPED, 0)

        # cross-component storm: both pools flip in one drain ->
        # expansion covers the fleet -> ONE escalated full pass now,
        # follow-ups coalesce onto ONE pending backstop
        def flood(rpm: float) -> None:
            for m_i in (0, half):
                core.observe_load(
                    model_name(m_i, n_models), NS,
                    CollectedLoad(arrival_rate_rpm=rpm,
                                  avg_input_tokens=IN_TOK,
                                  avg_output_tokens=OUT_TOK,
                                  avg_ttft_ms=TTFT_S * 1000.0,
                                  avg_itl_ms=ITL_S * 1000.0))

        flood(9000.0)
        storm_results = core.process_once()
        storm_full = (len(storm_results) == 1
                      and len(storm_results[0].processed) == n_variants)
        flood(9900.0)
        coalesced = core.process_once() == []   # deferred, not solved
    return {
        "fleet_variants": n_variants,
        "component_variants": component,
        "scoped_events": scoped_events,
        "scoped_solves_component_only": scoped_ok,
        "storm_escalates_full": storm_full,
        "storm_coalesces": coalesced,
        "lanes": {LANE_SCOPED: lanes.get(LANE_SCOPED, 0),
                  LANE_FULL: lanes.get(LANE_FULL, 0),
                  LANE_COALESCED: lanes.get(LANE_COALESCED, 0)},
        "scoped_lane_count": scoped_lanes,
        "kernel_launches": launch_summary(rows),
    }


def run(n_models: int = N_MODELS, rule_posts: int = RULE_POSTS,
        raw_posts: int = RAW_POSTS, smoke: bool = False, *, device=None,
        dtype=None) -> dict:
    place = where(device, dtype)
    on = {"device": device, "dtype": dtype}
    throughput = run_throughput(n_models, rule_posts, raw_posts, **on)
    equivalence = run_equivalence(n_models=4 if smoke else 8,
                                  steps=3 if smoke else
                                  len(TRAJECTORY_RPM), **on)
    limited = run_limited(n_models=4 if smoke else 8,
                          scoped_events=2 if smoke else 6, **on)
    headline = min(throughput["rules"]["series_per_s"],
                   throughput["raw"]["series_per_s"])
    return {
        "metric": "stream_ingest_series_per_s",
        "bench": "streamload",
        "value": headline,
        "unit": "series/s sustained, min(rules, raw) lane, real "
                "snappy+protobuf POSTs through the WSGI door",
        "target_series_per_s": TARGET_SERIES_PER_S,
        "admit_budget_ms": ADMIT_BUDGET_MS,
        "throughput": throughput,
        "equivalence": equivalence,
        "limited": limited,
        **place,
    }


def check(out: dict) -> tuple[list[str], list[dict]]:
    """bench_streamload.py's gates: (the deterministic invariants that
    failed, every wall-clock budget with its value and whether it was
    met). A smoke run sets no rate floor, as bench_streamload.py's
    smoke does."""
    fails = []
    if out["throughput"]["sheds_by_reason"]:
        fails.append(f"unexpected sheds "
                     f"{out['throughput']['sheds_by_reason']}")
    if not out["equivalence"]["pushdown_equals_rules"]:
        fails.append("pushdown decisions diverged from rule decisions")
    if not out["equivalence"]["off_restores_rule_door"]:
        fails.append("WVA_STREAM_PUSHDOWN=off did not restore rule door")
    lim = out["limited"]
    if not (lim["scoped_solves_component_only"]
            and lim["storm_escalates_full"] and lim["storm_coalesces"]):
        fails.append(f"limited-mode lanes wrong: {lim}")
    if lim["lanes"]["scoped"] < 1 or lim["lanes"]["coalesced"] < 1:
        fails.append(f"lane counts not pinned: {lim['lanes']}")
    if lim["component_variants"] * 2 > lim["fleet_variants"] + 1:
        fails.append("component does not partition the fleet")
    budgets = []
    if not out.get("smoke"):
        budgets.append({"budget": "series_per_s (min of the lanes)",
                        "value": out["value"], "limit": TARGET_SERIES_PER_S,
                        "met": out["value"] >= TARGET_SERIES_PER_S})
    for lane in ("rules", "raw"):
        p99 = out["throughput"][lane]["p99_admit_ms"]
        budgets.append({"budget": f"{lane} p99_admit_ms", "value": p99,
                        "limit": ADMIT_BUDGET_MS,
                        "met": p99 < ADMIT_BUDGET_MS})
    return fails, budgets


def main(argv=None) -> int:
    opts = parse_args("bench_torch_streamload.py", argv, smoke=True)
    if opts.smoke:
        out = run(n_models=16, rule_posts=20, raw_posts=15, smoke=True,
                  device=opts.device)
        out["smoke"] = True
    else:
        out = run(device=opts.device)
    return emit(out, opts.out, *check(out))


if __name__ == "__main__":
    sys.exit(main())
