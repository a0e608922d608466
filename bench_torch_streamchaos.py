"""bench_torch_streamchaos: streaming under fire (bounded sheds, warm
restart), with the port's cycles on the card.

The counterpart of bench_streamchaos.py. Three phases, one JSON line:

- **flood** (simulated time, deterministic): the `flash-crowd-flood`
  twin scenario replays every push 100x with phantom relabeling-storm
  groups against a 64-group store and a 32-event queue.
  `StreamCore.ingest_push` (the port's class, restored afterwards) is
  instrumented for the store/queue high-water marks and the attempt
  count: the caps hold, every refusal is metered per reason, admitted +
  shed balances the attempts, and the final published decisions equal a
  calm `flash-crowd-streaming` run's (shed, not lost).
- **wire** (wall clock, measured): a 64-variant fleet takes load steps
  as remote-write POSTs while each step rides inside a 100-post flood
  (phantom groups, jittered duplicates) that keeps the capped store
  shedding; the core's own lag meter records observed -> published for
  every admitted event, the consumer thread launching B1 on the card.
- **restart** (simulated time, deterministic): the `restart-under-load`
  twin scenario kills and rebuilds the controller mid-flash-crowd: one
  warm checkpoint restore, goodput at or above the scenario's floor, no
  variant flapped to zero.

The twins' Reconcilers (and restarted ones) run on the device
(`emulator.twin.run_scenario(device=, dtype=)`), so their cycles size
through B1 on the card.

    python3 bench_torch_streamchaos.py [--device cuda|cpu] [--smoke] [--out PATH]

`check` keeps every check of bench_streamchaos.py, split into the
deterministic invariants and the one wall-clock budget (the wire
phase's p99 lag < 250 ms); the CLI exits 1 when either fails. `--smoke`
runs the abbreviated flood (315 s) and restart (300 s) and a short wire
phase. Runs in float32 on `cuda` unless `--device cpu` is asked; raises
without CUDA. Prints ONE JSON line with bench_torch_loop.where's keys
and each phase's kernel_launches (B1/B2 per reconcile call).
"""

from __future__ import annotations

import random
import statistics
import sys
import threading
import time

from bench_torch_collect import cycle_launches, emit, launch_summary, parse_args
from bench_torch_loop import where
from bench_torch_stream import (
    build_cluster,
    model_name,
    post_write,
    seed_prom,
    write_request_body,
)
from workload_variant_autoscaler_tpu_torch.controller import (
    CONFIG_MAP_NAME,
    CONFIG_MAP_NAMESPACE,
)
from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
    STREAMING_SCENARIOS,
    abbreviated,
)
from workload_variant_autoscaler_tpu_torch.emulator.twin import run_scenario
from workload_variant_autoscaler_tpu_torch.metrics import (
    CHECKPOINT_RESTORE,
    CHECKPOINT_SAVE,
    INFERNO_STREAM_CHECKPOINT_TOTAL,
    INFERNO_STREAM_EVENTS_TOTAL,
    INFERNO_STREAM_SHED_TOTAL,
    LABEL_EVENT,
    LABEL_REASON,
    LABEL_SOURCE,
    SOURCE_BACKSTOP,
    SOURCE_REMOTE_WRITE,
    STREAM_SHED_REASONS,
)
from workload_variant_autoscaler_tpu_torch.stream import (
    StreamCore,
    remote_write_middleware,
)

LAG_BUDGET_MS = 250.0
STORE_CAP = 64             # mirrors the flash-crowd-flood scenario caps
QUEUE_CAP = 32
FLOOD_MULT = 100

# wire-phase fleet: small enough that a shed-requested backstop pass is
# cheap, large enough that scoped micro-cycles stay the common case
WIRE_VARIANTS = 64
WIRE_MODELS = 8
WIRE_ROUNDS = 24
WIRE_WARMUP = 4


def _shed_by_reason(emitter) -> dict:
    out = {}
    for reason in STREAM_SHED_REASONS:
        n = emitter.value(INFERNO_STREAM_SHED_TOTAL,
                          **{LABEL_REASON: reason})
        if n:
            out[reason] = n
    return out


def flood_phase(horizon_s: float = 0.0, converge: bool = True, *,
                device=None, dtype=None) -> dict:
    """Run flash-crowd-flood with ingest_push instrumented for attempt
    counts and store/queue high-water marks; optionally run the calm
    flash-crowd-streaming twin and compare final decisions."""
    sc = STREAMING_SCENARIOS["flash-crowd-flood"]
    calm_sc = STREAMING_SCENARIOS["flash-crowd-streaming"]
    if horizon_s:
        sc = abbreviated(sc, horizon_s)
        calm_sc = abbreviated(calm_sc, horizon_s)

    marks = {"store": 0, "queue": 0, "attempts": 0}
    orig_push = StreamCore.ingest_push

    def tracked_push(self, *args, **kwargs):
        marks["attempts"] += 1
        try:
            return orig_push(self, *args, **kwargs)
        finally:
            marks["store"] = max(marks["store"], len(self._store))
            marks["queue"] = max(marks["queue"],
                                 len(self.queue._events))

    StreamCore.ingest_push = tracked_push
    try:
        with cycle_launches() as rows:
            flood = run_scenario(sc, device=device, dtype=dtype)
    finally:
        StreamCore.ingest_push = orig_push

    em = flood.emitter
    shed = _shed_by_reason(em)
    admitted = em.value(INFERNO_STREAM_EVENTS_TOTAL,
                        **{LABEL_SOURCE: SOURCE_REMOTE_WRITE}) or 0.0
    # the overload ledger: every push either landed (admitted) or was
    # refused at the store with its reason metered. queue-full sheds
    # are NOT part of this sum — the store kept the data, only the
    # scoped wake was folded into a backstop request.
    store_shed = shed.get("store-full", 0.0)
    out = {
        "scenario": flood.scenario,
        "duration_s": flood.duration_s,
        "multiplier": FLOOD_MULT,
        "store_cap": STORE_CAP,
        "store_peak": marks["store"],
        "queue_cap": QUEUE_CAP,
        "queue_peak": marks["queue"],
        "push_attempts": marks["attempts"],
        "events_admitted": admitted,
        "shed": shed,
        "events_shed": round(sum(shed.values())),
        "accounting_ok": admitted + store_shed == marks["attempts"],
        "backstop_passes": em.value(
            INFERNO_STREAM_EVENTS_TOTAL,
            **{LABEL_SOURCE: SOURCE_BACKSTOP}) or 0.0,
        "goodput_fraction": round(flood.goodput_fraction, 4),
        "goodput_floor": flood.goodput_floor,
        "kernel_launches": launch_summary(rows),
    }
    if converge:
        calm = run_scenario(calm_sc, device=device, dtype=dtype)
        converged = True
        for v in calm.variants:
            a = calm.decisions.latest(v.name, v.namespace)
            b = flood.decisions.latest(v.name, v.namespace)
            converged &= (a is not None and b is not None
                          and a.published_replicas == b.published_replicas)
        out["backstop_converged"] = converged
    return out


def wire_phase(n_variants: int = WIRE_VARIANTS,
               n_models: int = WIRE_MODELS,
               rounds: int = WIRE_ROUNDS,
               warmup: int = WIRE_WARMUP,
               flood_mult: int = FLOOD_MULT, *, device=None,
               dtype=None) -> dict:
    """Measured wall-clock lag for admitted events while the door sheds
    a seeded flood. Each round steps every model's load (prom and the
    pushed bodies agree, so backstop passes and scoped cycles publish
    the same answer) inside flood_mult-1 garbage posts."""
    kube, rec = build_cluster(n_variants, n_models, device=device,
                              dtype=dtype)
    caps = {"WVA_STREAM_MAX_GROUPS": str(STORE_CAP),
            "WVA_STREAM_MAX_QUEUE": str(QUEUE_CAP)}
    cm = kube.get_configmap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE)
    cm.data.update(caps)
    kube.put_configmap(cm)
    # the queue depth cap is fixed at core construction: seed the
    # last-seen CM so ensure_stream_core builds with the small caps
    rec.state.last_operator_cm = dict(cm.data)
    core = rec.ensure_stream_core()
    app = remote_write_middleware(core)(
        lambda _e, _s: [b""])          # exposition app not under test

    lags: list[float] = []
    orig_lag = rec.emitter.emit_stream_lag

    def capture(seconds: float) -> None:
        orig_lag(seconds)
        lags.append(seconds)

    rec.emitter.emit_stream_lag = capture

    rec.reconcile()                    # cold: build, launch, publish
    stop = threading.Event()
    consumer = threading.Thread(target=core.run, args=(stop,),
                                name="bench-streamchaos-consumer",
                                daemon=True)
    rng = random.Random(0x57F00D)
    levels = (4800.0, 9600.0)
    statuses = {"204": 0, "429": 0, "other": 0}
    marks = {"store": 0, "queue": 0}
    warm_start = 0

    def drain(grace_s: float) -> None:
        t_wait = time.monotonic() + 10.0
        while core.queue.pending() > 0 and time.monotonic() < t_wait:
            time.sleep(0.005)
        time.sleep(grace_s)            # publishes land after the claim

    def tally(status: str) -> None:
        key = status.split(" ", 1)[0]
        statuses[key if key in statuses else "other"] += 1
        marks["store"] = max(marks["store"], len(core._store))
        marks["queue"] = max(marks["queue"], len(core.queue._events))

    with cycle_launches() as rows:
        consumer.start()
        deadline = time.monotonic() + 30.0
        while core.state.snapshot is None and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            for i in range(rounds):
                if i == warmup:
                    drain(0.3)
                    warm_start = len(lags)
                rpm = levels[i % len(levels)] + i
                seed_prom(rec.prom, n_models, rps=rpm / 60.0)
                ts_ms = int(time.time() * 1000)
                # the real load step lands first, then the relabeling
                # storm rages while the step debounces, drains and
                # publishes: the lag samples measure admitted events
                # DURING the flood
                for m_i in range(n_models):
                    body = write_request_body(model_name(m_i, n_models),
                                              rpm, ts_ms)
                    tally(post_write(app, body))
                for k in range(flood_mult - 1):
                    target = f"phantom-{rng.randrange(1_000_000)}"
                    body = write_request_body(
                        target, rpm * rng.uniform(0.8, 1.2), ts_ms)
                    tally(post_write(app, body))
                    if k % 8 == 7:
                        # senders are remote: a 100-post storm arrives
                        # as wire traffic, not one thread's tight loop;
                        # yield so the consumer thread shares the
                        # interpreter
                        time.sleep(0.001)
            drain(0.5)
        finally:
            stop.set()
            core.queue.request_full("watch")   # wake the consumer to exit
            consumer.join(timeout=5.0)

    measured_ms = sorted(s * 1000.0 for s in lags[warm_start:])
    if not measured_ms:
        raise RuntimeError("wire: no admitted event ever published")

    def pct(p: float) -> float:
        idx = min(int(round(p * (len(measured_ms) - 1))),
                  len(measured_ms) - 1)
        return measured_ms[idx]

    sample_va = kube.get_variant_autoscaling("chat-0", "default")
    replicas = sample_va.status.desired_optimized_alloc.num_replicas
    return {
        "variants": n_variants,
        "models": n_models,
        "rounds": rounds,
        "warmup_rounds": warmup,
        "posts_per_round": flood_mult - 1 + n_models,
        "posts": sum(statuses.values()),
        "accepted_204": statuses["204"],
        "partial_429": statuses["429"],
        "store_cap": STORE_CAP,
        "store_peak": marks["store"],
        "queue_cap": QUEUE_CAP,
        "queue_peak": marks["queue"],
        "shed": _shed_by_reason(rec.emitter),
        "lag_samples": len(measured_ms),
        "p50_ms": round(pct(0.50), 3),
        "p99_ms": round(pct(0.99), 3),
        "max_ms": round(measured_ms[-1], 3),
        "mean_ms": round(statistics.fmean(measured_ms), 3),
        "decision_check": {
            "published_replicas": replicas,
            "resized_from_push": replicas > 2,
        },
        "kernel_launches": launch_summary(rows),
    }


def restart_phase(horizon_s: float = 0.0, *, device=None,
                  dtype=None) -> dict:
    sc = STREAMING_SCENARIOS["restart-under-load"]
    if horizon_s:
        sc = abbreviated(sc, horizon_s)
    with cycle_launches() as rows:
        res = run_scenario(sc, device=device, dtype=dtype)
    em = res.emitter
    return {
        "scenario": res.scenario,
        "duration_s": res.duration_s,
        "fault_trips": res.fault_trips,
        "checkpoint_restores": em.value(
            INFERNO_STREAM_CHECKPOINT_TOTAL,
            **{LABEL_EVENT: CHECKPOINT_RESTORE}) or 0.0,
        "checkpoint_saves": em.value(
            INFERNO_STREAM_CHECKPOINT_TOTAL,
            **{LABEL_EVENT: CHECKPOINT_SAVE}) or 0.0,
        "goodput_fraction": round(res.goodput_fraction, 4),
        "goodput_floor": res.goodput_floor,
        "scale_to_zero_flaps": sum(
            1 for v in res.variants if v.scaled_to_zero_on_stale),
        "kernel_launches": launch_summary(rows),
    }


def check(out: dict) -> tuple[list[str], list[dict]]:
    """bench_streamchaos.py's checks: (the deterministic invariants that
    failed, the wall-clock budget with its value and whether it was
    met)."""
    flood, wire, restart = out["flood"], out["wire"], out["restart"]
    invariants = (
        ("flood store_peak <= store_cap",
         flood["store_peak"] <= flood["store_cap"]),
        ("flood queue_peak <= queue_cap",
         flood["queue_peak"] <= flood["queue_cap"]),
        ("flood store-full sheds", flood["shed"].get("store-full", 0) > 0),
        ("flood queue-full sheds", flood["shed"].get("queue-full", 0) > 0),
        ("flood accounting_ok", flood["accounting_ok"]),
        ("flood backstop_passes > 0", flood["backstop_passes"] > 0),
        ("flood goodput >= floor",
         flood["goodput_fraction"] >= flood["goodput_floor"]),
        ("flood backstop_converged", flood.get("backstop_converged", True)),
        ("wire store_peak <= store_cap",
         wire["store_peak"] <= wire["store_cap"]),
        ("wire partial_429 > 0", wire["partial_429"] > 0),
        ("wire resized_from_push",
         wire["decision_check"]["resized_from_push"]),
        ("restart fault_trips == 1", restart["fault_trips"] == 1),
        ("restart checkpoint_restores == 1",
         restart["checkpoint_restores"] == 1.0),
        ("restart checkpoint_saves >= 1", restart["checkpoint_saves"] >= 1.0),
        ("restart goodput >= floor",
         restart["goodput_fraction"] >= restart["goodput_floor"]),
        ("restart scale_to_zero_flaps == 0",
         restart["scale_to_zero_flaps"] == 0),
    )
    fails = [name for name, ok in invariants if not ok]
    budgets = [{"budget": "wire p99_ms", "value": wire["p99_ms"],
                "limit": out["lag_budget_ms"],
                "met": wire["p99_ms"] < out["lag_budget_ms"]}]
    return fails, budgets


def run(smoke: bool = False, *, device=None, dtype=None) -> dict:
    place = where(device, dtype)
    on = {"device": device, "dtype": dtype}
    if smoke:
        flood = flood_phase(horizon_s=315.0, converge=False, **on)
        wire = wire_phase(n_variants=32, n_models=4, rounds=6,
                          warmup=2, flood_mult=24, **on)
        restart = restart_phase(horizon_s=300.0, **on)
    else:
        flood = flood_phase(**on)
        wire = wire_phase(**on)
        restart = restart_phase(**on)
    return {
        "bench": "streamchaos",
        "metric": "stream_admitted_lag_ms_p99_under_flood",
        "value": wire["p99_ms"],
        "unit": "ms load-change->published for admitted events "
                "during a 100x flood, p99",
        "lag_budget_ms": LAG_BUDGET_MS,
        "flood": flood,
        "wire": wire,
        "restart": restart,
        **place,
    }


def main(argv=None) -> int:
    opts = parse_args("bench_torch_streamchaos.py", argv, smoke=True)
    out = run(opts.smoke, device=opts.device)
    if opts.smoke:
        out["smoke"] = True
    return emit(out, opts.out, *check(out))


if __name__ == "__main__":
    sys.exit(main())
