"""Fleet goodput digital twin: scenario in, headline efficiency out.

`run_scenario` drives the REAL Reconciler through one
`scenarios.Scenario` end-to-end in simulated time — emulator fleets
(one per variant, chip-generation physics from `scenarios.CHIP_MATRIX`)
feeding SimPromAPI/MultiPromAPI, an InMemoryKube holding the CRs and
node pools, a shared deterministic FaultPlan on BOTH dependencies, and
emulated actuation with pod-startup lag — then scores the run with the
fleet-efficiency metric of "ML Fleet Efficiency with ML Productivity
Goodput" (PAPERS.md, arxiv 2502.06982):

    goodput = SLO-attained demand-seconds served
              ---------------------------------------
              chip-cost-seconds provisioned

decomposed tick by tick into badput buckets over the provisioned cost:

- `useful`            capacity that served demand within SLO
- `under-provisioned` SLO-failing ticks the controller simply mis-sized
                      (demand moved between cycles, or capacity was
                      withdrawn below need)
- `over-provisioned`  surplus replicas demand cannot use
- `degradation-held`  mis-provision while the variant rode a degraded
                      rung (stream-degraded/stale-cache/hold — the
                      controller was flying on degraded evidence)
- `actuation-lagged`  the decision was right but pods were still
                      starting (scale-up landed inside the startup lag)

SLO attainment per tick is a capacity test (provisioned >= the replicas
the published SLO-feasible envelope says the GROUND-TRUTH demand needs)
cross-checked against observed TTFT of completions in the tick — a
solver that under-sizes shows up empirically even if its own envelope
claims health. The per-replica envelope comes from the controller's own
published capacity (`Reconciler.capacity_envelopes`, the demand-probe
surface), so the meter judges the controller against the demand it
actually faced, not against a second model of the hardware.

Every reconcile interval's dominant badput bucket is stamped back onto
that cycle's DecisionRecords (`DecisionLog.annotate_goodput`), so
`controller explain <variant>` answers "why did scenario X lose goodput
at cycle N" from the audit trail alone.

Everything runs on the sim clock from seeded inputs — a rerun of the
same scenario is byte-identical, which tests/test_torch_twin.py asserts.
The Reconciler sizes on the card (its CUDA kernels) unless the caller
asks for the CPU; the fleet, the meter and the clock are host code.
"""

from __future__ import annotations

import io
import json
import os
import random
import shutil
import tempfile
from dataclasses import dataclass

import torch

from ..controller import (
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
from ..collector import collect_inventory_k8s
from ..controller.degradation import DegradationState
from ..controller.kube import Node
from ..faults import (
    CONTROLLER_RESTART,
    STREAM_KINDS,
    FaultPlan,
    corrupt_stream_body,
    skew_stream_timestamp,
    stream_flood_multiplier,
)
from ..metrics import MetricsEmitter
from ..obs.decision import GOODPUT_USEFUL
from ..obs.goodput import (
    DEGRADED_RUNGS,
    STALE_ZERO_RUNGS,
    UNPUBLISHED,
    GoodputMeter,
    TickSample,
)
from ..utils import full_name, get_logger, kv, resolve_device, resolve_dtype
from .engine import Fleet, MetricsSink, Request, Simulation, SliceModelConfig
from .loadgen import PoissonLoadGenerator, TokenDistribution, rate_at
from .metrics import PrometheusSink
from .scenarios import CHIP_MATRIX, GKE_POOL_LABELS, Scenario, VariantSpec
from .simprom import MultiPromAPI, SimPromAPI

log = get_logger("wva.twin")

# DEGRADED_RUNGS / STALE_ZERO_RUNGS moved to obs.goodput with the
# meter extraction (this PR); re-exported above because the rung
# policy is part of the twin's public story and tests import it here.
__all__ = ["DEGRADED_RUNGS", "STALE_ZERO_RUNGS", "ScenarioResult",
           "VariantResult", "run_scenario"]

_RUNG_LABELS = {int(s): s.label for s in DegradationState}


class _TTFTRecorder(MetricsSink):
    """Time-ordered (first_token_ms, ttft_ms) samples, consumed one tick
    window at a time by the meter."""

    def __init__(self) -> None:
        self.samples: list[tuple[float, float]] = []
        self._idx = 0

    def on_arrival(self, req: Request) -> None: ...
    def on_token(self, dt_ms: float) -> None: ...
    def on_finish(self, req: Request) -> None: ...
    def set_queue_sizes(self, running: int, waiting: int) -> None: ...
    def set_kv_usage(self, frac: float) -> None: ...

    def on_first_token(self, req: Request) -> None:
        self.samples.append((req.first_token_ms, req.ttft_ms))

    def take_until(self, t_ms: float) -> list[float]:
        """TTFTs of first tokens emitted before t_ms and not yet taken."""
        out = []
        while self._idx < len(self.samples) and \
                self.samples[self._idx][0] < t_ms:
            out.append(self.samples[self._idx][1])
            self._idx += 1
        return out


class _FanSink(MetricsSink):
    """Forward every sink hook to several sinks (the Prometheus sink the
    collector scrapes + the meter's TTFT recorder)."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = sinks

    def on_arrival(self, req: Request) -> None:
        for s in self.sinks:
            s.on_arrival(req)

    def on_first_token(self, req: Request) -> None:
        for s in self.sinks:
            s.on_first_token(req)

    def on_token(self, dt_ms: float) -> None:
        for s in self.sinks:
            s.on_token(dt_ms)

    def on_finish(self, req: Request) -> None:
        for s in self.sinks:
            s.on_finish(req)

    def set_queue_sizes(self, running: int, waiting: int) -> None:
        for s in self.sinks:
            s.set_queue_sizes(running, waiting)

    def set_kv_usage(self, frac: float) -> None:
        for s in self.sinks:
            s.set_kv_usage(frac)


@dataclass
class _VariantState:
    """Per-variant sim-side state. The goodput ACCOUNTING lives in the
    shared `obs.goodput.VariantLedger` (`ledger`) — the twin keeps only
    what the emulation itself needs: the fleet, the TTFT recorder, and
    the actually-serving replica count actuation lags behind."""

    spec: VariantSpec
    fleet: Fleet
    recorder: _TTFTRecorder
    price_per_hour: float
    ledger: object = None       # obs.goodput.VariantLedger
    actual: int = 1             # replicas actually serving (startup lag)

    @property
    def key(self) -> str:
        return full_name(self.spec.name, self.spec.namespace)


@dataclass
class VariantResult:
    """One variant's goodput ledger for the whole run."""

    name: str
    namespace: str
    chip: str
    price_per_hour: float
    cost_dollar_seconds: float
    demand_seconds: float
    slo_demand_seconds: float
    badput: dict[str, float]          # bucket -> dollar-seconds
    min_desired_after_publish: int
    scaled_to_zero_on_stale: bool

    @property
    def goodput_fraction(self) -> float:
        """Useful share of the provisioned cost, in [0, 1]."""
        if self.cost_dollar_seconds <= 0.0:
            return 0.0
        return self.badput.get(GOODPUT_USEFUL, 0.0) / self.cost_dollar_seconds

    @property
    def slo_attainment(self) -> float:
        if self.demand_seconds <= 0.0:
            return 1.0
        return self.slo_demand_seconds / self.demand_seconds

    @property
    def goodput(self) -> float:
        """SLO-attained demand-seconds per dollar-second provisioned."""
        if self.cost_dollar_seconds <= 0.0:
            return 0.0
        return self.slo_demand_seconds / self.cost_dollar_seconds


@dataclass
class ScenarioResult:
    """A full twin run: per-variant ledgers + the run's fault/decision
    evidence. `decisions` is the reconciler's DecisionLog with goodput
    annotations applied — feed it to `obs.explain_text` to answer why a
    cycle lost goodput."""

    scenario: str
    duration_s: float
    cycles: int
    raised_cycles: int
    fault_trips: int
    goodput_floor: float
    variants: list[VariantResult]
    decisions: object = None    # obs.DecisionLog (kept out of to_dict)
    emitter: object = None      # MetricsEmitter of the run
    # obs.Tracer of the run (kept out of to_dict): span durations are
    # SIM durations — the tracer derives them from the reconciler's
    # injected clock — so a scenario rerun traces byte-identically
    # (asserted by tests/test_torch_twin.py)
    tracer: object = None
    # obs.goodput.GoodputMeter the twin drove (kept out of to_dict):
    # per-tick ring + per-variant ledgers, compared against an
    # online-attached meter by the equivalence harness
    meter: object = None

    @property
    def cost_dollar_seconds(self) -> float:
        return sum(v.cost_dollar_seconds for v in self.variants)

    @property
    def goodput_fraction(self) -> float:
        cost = self.cost_dollar_seconds
        if cost <= 0.0:
            return 0.0
        return sum(v.badput.get(GOODPUT_USEFUL, 0.0)
                   for v in self.variants) / cost

    @property
    def slo_attainment(self) -> float:
        demand = sum(v.demand_seconds for v in self.variants)
        if demand <= 0.0:
            return 1.0
        return sum(v.slo_demand_seconds for v in self.variants) / demand

    @property
    def goodput(self) -> float:
        cost = self.cost_dollar_seconds
        if cost <= 0.0:
            return 0.0
        return sum(v.slo_demand_seconds for v in self.variants) / cost

    @property
    def never_scaled_to_zero(self) -> bool:
        return not any(v.scaled_to_zero_on_stale for v in self.variants)

    def to_dict(self) -> dict:
        def r(x: float) -> float:
            return round(x, 6)

        def badput_fractions(cost: float, buckets: dict) -> dict:
            if cost <= 0.0:
                return {}
            return {b: r(c / cost) for b, c in sorted(buckets.items())
                    if b != GOODPUT_USEFUL}

        totals: dict[str, float] = {}
        for v in self.variants:
            for b, c in v.badput.items():
                totals[b] = totals.get(b, 0.0) + c
        return {
            "scenario": self.scenario,
            "duration_s": self.duration_s,
            "cycles": self.cycles,
            "raised_cycles": self.raised_cycles,
            "fault_trips": self.fault_trips,
            "goodput_floor": self.goodput_floor,
            "goodput_fraction": r(self.goodput_fraction),
            "goodput_demand_per_dollar_s": r(self.goodput),
            "slo_attainment": r(self.slo_attainment),
            "cost_dollar_seconds": r(self.cost_dollar_seconds),
            "never_scaled_to_zero": self.never_scaled_to_zero,
            "badput": badput_fractions(self.cost_dollar_seconds, totals),
            "variants": {
                v.name: {
                    "chip": v.chip,
                    "price_per_hour": r(v.price_per_hour),
                    "goodput_fraction": r(v.goodput_fraction),
                    # the cost-skew axis: how many SLO-attained
                    # demand-seconds each dollar-second of this
                    # generation bought
                    "goodput_demand_per_dollar_s": r(v.goodput),
                    "slo_attainment": r(v.slo_attainment),
                    "cost_dollar_seconds": r(v.cost_dollar_seconds),
                    "demand_seconds": r(v.demand_seconds),
                    "badput": badput_fractions(v.cost_dollar_seconds,
                                               v.badput),
                    "min_desired_after_publish":
                        v.min_desired_after_publish,
                }
                for v in self.variants
            },
        }


def _slice_config(spec: VariantSpec) -> SliceModelConfig:
    """Emulator physics for the variant's lane. Memory is sized to be
    non-binding (the goodput scenarios stress capacity and evidence, not
    KV eviction — the tail-stress suite owns that axis)."""
    lane = CHIP_MATRIX[spec.chip]
    return SliceModelConfig(
        model_name=spec.model, slice_name=lane.slice_name,
        alpha=lane.alpha, beta=lane.beta,
        gamma=lane.gamma, delta=lane.delta,
        max_batch_size=lane.max_batch,
        hbm_gb=16.0 * lane.chips, model_size_gb=8.0,
        kv_mb_per_token=0.25,
    )


def _operator_cm(scenario: Scenario,
                 extra: dict[str, str] | None = None) -> dict[str, str]:
    interval = f"{scenario.reconcile_interval_s:.0f}s"
    operator = {"GLOBAL_OPT_INTERVAL": interval, **scenario.operator,
                **(extra or {})}
    if scenario.limited_mode:
        operator.setdefault("WVA_LIMITED_MODE", "true")
    return operator


def _seed_kube(scenario: Scenario, kube: InMemoryKube,
               operator_extra: dict[str, str] | None = None) -> None:
    """ConfigMaps, Deployments, VAs, and node pools for the scenario —
    the same wiring shape the closed-loop e2e tests use, generalized to
    many variants/generations."""
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                 _operator_cm(scenario, operator_extra)))

    # slice-shape catalog: spot-priced when any variant on the shape is
    # spot (the scenarios never mix pricing on one shape)
    accel: dict[str, str] = {}
    for v in scenario.variants:
        lane = CHIP_MATRIX[v.chip]
        accel[v.chip] = json.dumps({
            "chip": lane.generation,
            "chips": str(lane.chips),
            "cost": f"{v.cost_per_hour}",
        })
    kube.put_configmap(ConfigMap(ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
                                 accel))

    rows = "\n".join(
        f"  - model: {v.model}\n"
        f"    slo-tpot: {v.slo_itl_ms:.0f}\n"
        f"    slo-ttft: {v.slo_ttft_ms:.0f}"
        for v in scenario.variants)
    kube.put_configmap(ConfigMap(
        SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"premium": f"name: Premium\npriority: 1\ndata:\n{rows}\n"}))

    for v in scenario.variants:
        lane = CHIP_MATRIX[v.chip]
        kube.put_deployment(Deployment(name=v.name, namespace=v.namespace,
                                       spec_replicas=1, status_replicas=1))
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(
                name=v.name, namespace=v.namespace,
                labels={crd.ACCELERATOR_LABEL: v.chip}),
            spec=crd.VariantAutoscalingSpec(
                model_id=v.model,
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=SERVICE_CLASS_CM_NAME, key="premium"),
                model_profile=crd.ModelProfile(accelerators=[
                    crd.AcceleratorProfile(
                        acc=v.chip, acc_count=1,
                        perf_parms=crd.PerfParms(
                            decode_parms={"alpha": str(lane.alpha),
                                          "beta": str(lane.beta)},
                            prefill_parms={"gamma": str(lane.gamma),
                                           "delta": str(lane.delta)},
                        ),
                        max_batch_size=lane.max_batch,
                    ),
                ]),
            ),
        ))

    for pool in scenario.node_pools:
        label = GKE_POOL_LABELS[pool.generation]
        for i in range(pool.count):
            kube.put_node(Node(
                name=f"{pool.prefix}-{i}",
                labels={"cloud.google.com/gke-tpu-accelerator": label},
                tpu_capacity=pool.chips_per_node,
            ))


def run_scenario(scenario: Scenario,
                 online_meter: GoodputMeter | None = None,
                 *, device=None, dtype=None) -> ScenarioResult:
    """Run one scenario to completion and return its goodput ledger.

    `device`, `dtype`: where every Reconciler of the run (the first one
    and any restarted one) sizes — the card and float32 unless asked;
    `device=None` on a host without CUDA raises.

    `online_meter`: an optional second GoodputMeter attached to the
    Reconciler's live feed path (`Reconciler.attach_goodput_meter`,
    self-tick disabled) while the twin drives its own meter from ground
    truth — the twin-vs-online equivalence harness
    (`bench_goodput_live.py`) runs both and asserts identical per-tick
    ledgers.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    plan = FaultPlan(list(scenario.faults), seed=scenario.seed)
    restart_rules = [r for r in plan.rules
                     if r.kind == CONTROLLER_RESTART]
    operator_extra: dict[str, str] = {}
    ckpt_dir = None
    if restart_rules and scenario.streaming and \
            "WVA_STREAM_CHECKPOINT" not in scenario.operator:
        # restart scenarios get a warm-restart checkpoint by default;
        # the path never enters the result, so reruns stay
        # byte-identical
        ckpt_dir = tempfile.mkdtemp(prefix="wva-twin-ckpt-")
        operator_extra["WVA_STREAM_CHECKPOINT"] = \
            os.path.join(ckpt_dir, "stream.ckpt")
    try:
        return _run_scenario(scenario, plan, restart_rules,
                             operator_extra, online_meter, device, dtype)
    finally:
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _run_scenario(scenario: Scenario, plan: FaultPlan,
                  restart_rules: list, operator_extra: dict[str, str],
                  online_meter: GoodputMeter | None,
                  device: torch.device, dtype: torch.dtype,
                  ) -> ScenarioResult:
    kube = InMemoryKube()
    _seed_kube(scenario, kube, operator_extra)
    kube.attach_fault_plan(plan)

    sinks: list[PrometheusSink] = []
    states: list[_VariantState] = []
    fleets: list[Fleet] = []
    for v in scenario.variants:
        prom_sink = PrometheusSink(v.model, v.namespace)
        recorder = _TTFTRecorder()
        fleet = Fleet(_slice_config(v), _FanSink(prom_sink, recorder),
                      replicas=1)
        sinks.append(prom_sink)
        fleets.append(fleet)
        states.append(_VariantState(
            spec=v, fleet=fleet, recorder=recorder,
            price_per_hour=v.cost_per_hour))

    # the SAME meter class the live Reconciler drives (obs.goodput),
    # here fed from ground truth in sim time; the window keeps the
    # whole run so the score sheet is lifetime, like before the
    # extraction
    meter = GoodputMeter(window_s=scenario.duration_s)
    for st in states:
        st.ledger = meter.register(
            st.spec.name, st.spec.namespace, model=st.spec.model,
            price_per_hour=st.price_per_hour,
            slo_ttft_ms=st.spec.slo_ttft_ms)

    sim = Simulation(fleets, seed=scenario.seed)

    def sim_clock() -> float:
        """The controller's clock, and its spans' duration clock too:
        the trace of a rerun is byte for byte the same."""
        return sim.now_ms / 1000.0

    backends = [SimPromAPI(sink, v.model, v.namespace, fault_plan=plan)
                for sink, v in zip(sinks, scenario.variants)]
    prom = MultiPromAPI(backends)
    emitter = MetricsEmitter()
    rec = Reconciler(kube=kube, prom=prom, emitter=emitter,
                     now=sim_clock, sleep=lambda _s: None,
                     device=device, dtype=dtype, perf=sim_clock)
    if online_meter is not None:
        rec.attach_goodput_meter(online_meter, self_tick=False)

    for i, (v, fleet) in enumerate(zip(scenario.variants, fleets)):
        gen = PoissonLoadGenerator(
            sim, schedule=list(v.schedule),
            tokens=TokenDistribution(v.avg_in_tokens, v.avg_out_tokens,
                                     "deterministic"),
            seed=scenario.seed * 1000 + i, fleet=fleet)
        gen.start()

    tick_s = scenario.tick_s
    interval_ms = scenario.reconcile_interval_s * 1000.0
    delay_ms = scenario.actuation_delay_s * 1000.0
    cycle = 0
    raised = 0
    next_reconcile = interval_ms

    def pool_limit(st: _VariantState,
                   capacity: dict[str, int] | None) -> int | None:
        """Max replicas the variant's generation pool can host right now
        (limited-mode scenarios only; None = unconstrained)."""
        if capacity is None:
            return None
        lane = CHIP_MATRIX[st.spec.chip]
        return capacity.get(lane.generation, 0) // max(lane.chips, 1)

    def gen_capacity() -> dict[str, int] | None:
        """Live schedulable chips per generation, through the SAME node
        LIST the collector's inventory uses — so drain/reclaim windows
        act on the twin's pods exactly as they act on the solver."""
        if not scenario.limited_mode:
            return None
        return collect_inventory_k8s(kube)

    def set_actual(st: _VariantState, n: int, now_ms: float) -> None:
        st.actual = n
        st.fleet.set_replicas(max(n, 0), now_ms)
        kube.put_deployment(Deployment(
            name=st.spec.name, namespace=st.spec.namespace,
            spec_replicas=st.ledger.desired or st.actual,
            status_replicas=st.actual))
        sim.kick()

    def apply_target(st: _VariantState, now_ms: float) -> None:
        """Make the fleet match the published target (idempotent — the
        startup-lag callback re-reads the CURRENT target at fire time).
        In limited mode the target is additionally clamped to what the
        generation pool can host: pods cannot schedule onto drained or
        reclaimed nodes."""
        target = st.ledger.desired if st.ledger.published_once \
            else st.actual
        limit = pool_limit(st, gen_capacity())
        if limit is not None:
            target = min(target, limit)
        if target == st.actual:
            return
        set_actual(st, target, now_ms)

    def meter_tick(now_ms: float) -> None:
        # capacity withdrawal reaches the PODS, not just the solver: a
        # replica whose node drained away or was reclaimed dies now (its
        # in-flight work reroutes/queues per the engine's drain path)
        capacity = gen_capacity()
        if capacity is not None:
            for st in states:
                limit = pool_limit(st, capacity)
                if limit is not None and st.actual > limit:
                    log.info("capacity withdrawal killed replicas",
                             extra=kv(variant=st.spec.name,
                                      had=st.actual, fit=limit))
                    set_actual(st, limit, now_ms)
        # ground truth for the tick: sim demand, the recorder's TTFT
        # completions, and the fleet's billing replica count (draining
        # still bills) — then the SHARED meter does the attribution
        samples = {
            st.key: TickSample(
                demand_rps=rate_at(now_ms / 1000.0,
                                   st.spec.schedule) / 60.0,
                ttft_ms=tuple(st.recorder.take_until(now_ms)),
                replicas=len(st.fleet.all_replicas()),
                pool_limit=pool_limit(st, capacity))
            for st in states
        }
        meter.tick(now_ms / 1000.0, tick_s, samples)
        if online_meter is not None:
            # equivalence mode: the online meter sees the SAME ground
            # truth ticks; its cycle observations come from the live
            # Reconciler feed instead of the twin's kube reads
            online_meter.tick(now_ms / 1000.0, tick_s, samples)

    def begin_cycle() -> None:
        """Per-cycle bookkeeping shared by the polled loop and the
        streaming core (which runs it via its on_cycle_start hook):
        stamp the ended interval's dominant badput bucket onto its
        DecisionRecords (the audit-trail half of the goodput story)."""
        nonlocal cycle
        meter.flush(cycle, rec.decisions.annotate_goodput)
        plan.begin_cycle()
        cycle += 1

    def reconcile(now_ms: float) -> None:
        nonlocal raised
        begin_cycle()
        rungs: dict[str, str] = {}
        try:
            result = rec.reconcile()
            rungs = dict(result.degraded)
        except Exception as e:  # noqa: BLE001 — run_forever's catch, inline
            raised += 1
            log.warning("twin reconcile cycle raised",
                        extra=kv(scenario=scenario.name, cycle=cycle,
                                 error=str(e)))
            for st in states:
                rungs[st.key] = "hold"
        after_cycle(now_ms, rungs)

    def after_cycle(now_ms: float, rungs: dict[str, str]) -> None:
        envelopes = rec.capacity_envelopes()
        # the cycle-level rung floors every variant's rung: a cycle that
        # went limited (optimizer could not fit) or died into hold
        # governs the whole interval even though no per-variant entry
        # exists in result.degraded
        cycle_rung = int(emitter.value(
            "inferno_cycle_degradation_state") or 0)
        rung_ints = {label: value for value, label in _RUNG_LABELS.items()}
        published = {}
        for st in states:
            va = kube.get_variant_autoscaling(st.spec.name,
                                              st.spec.namespace)
            published[st.key] = \
                va.status.desired_optimized_alloc.num_replicas
        meter.observe_cycle(
            published=published, envelopes=envelopes,
            rungs={st.key: rung_ints.get(rungs.get(st.key, "healthy"), 0)
                   for st in states},
            cycle_rung=cycle_rung)
        # the meter judged the publication; now the SIM actuates it
        # (scale-down immediate, scale-up behind pod-startup lag)
        for st in states:
            desired = published[st.key]
            if desired > 0:
                if desired < st.actual:
                    apply_target(st, now_ms)     # scale-down: immediate
                elif desired > st.actual:
                    sim.schedule(delay_ms, "call",
                                 lambda t, st=st: apply_target(st, t))

    # streaming mode (stream/core.py): the core owns the loop — each
    # tick pushes the scraped loads through the ingest door and calls
    # process_once(); the reconcile interval becomes the backstop the
    # core schedules itself. Clock and debounce run on SIM time, so a
    # rerun is tick-for-tick deterministic like the polled path.
    core = None
    if scenario.streaming:
        from ..collector import collect_load
        from ..stream import (
            REMOTE_WRITE_PATH,
            STREAM_SERIES,
            ShedError,
            StreamCore,
            encode_write_request,
            remote_write_middleware,
            snappy_compress,
        )
        from ..stream.core import _LOAD_FIELDS

        def build_core() -> StreamCore:
            # the core reads its knobs (debounce, caps, checkpoint path)
            # from the last-seen operator CM; seed it so the scenario's
            # values apply before the first full pass has populated it —
            # and so a restarted core finds its checkpoint knob
            rec.state.last_operator_cm = _operator_cm(scenario,
                                                      operator_extra)
            c = StreamCore(rec, clock=sim_clock)
            rec.stream_core = c
            c.on_cycle_start(begin_cycle)
            return c

        core = build_core()
        # stream faults perturb with a twin-owned rng, so the plan's
        # per-rule streams stay aligned with non-streaming scenarios
        has_stream_faults = any(r.kind in STREAM_KINDS
                                for r in plan.rules)
        flood_rng = random.Random(scenario.seed * 7919 + 17)

        def push_group(model: str, ns: str, fields: dict,
                       ts_ms: float = 0.0) -> None:
            try:
                core.ingest_push(model, ns, fields, ts_ms=ts_ms)
            except ShedError:
                pass   # metered at the door; the backstop re-covers it

        def post_door(body: bytes) -> None:
            """POST raw bytes through the REAL remote-write door, so the
            corrupt-payload defense under test is the production WSGI
            path (400 + decode-error metering), not a twin re-creation."""
            app = remote_write_middleware(core)(None)
            app({"PATH_INFO": REMOTE_WRITE_PATH,
                 "REQUEST_METHOD": "POST",
                 "CONTENT_LENGTH": str(len(body)),
                 "wsgi.input": io.BytesIO(body)},
                lambda status, headers: None)

        def push_loads(now_ms: float) -> None:
            for v in scenario.variants:
                try:
                    load = collect_load(prom, v.model, v.namespace)
                except Exception:  # noqa: BLE001 — ingest is best-effort
                    continue       # the backstop pass still covers it
                if not has_stream_faults:
                    core.observe_load(v.model, v.namespace, load)
                    continue
                fields = {f: getattr(load, f) for f in _LOAD_FIELDS}
                body = snappy_compress(encode_write_request([
                    ({"__name__": name, "model_name": v.model,
                      "namespace": v.namespace},
                     [(fields[fld], int(now_ms))])
                    for name, fld in STREAM_SERIES.items()]))
                shredded = corrupt_stream_body(plan, body)
                if shredded is not body:
                    post_door(shredded)
                    continue
                ts = skew_stream_timestamp(plan, v.model, v.namespace,
                                           now_ms)
                push_group(v.model, v.namespace, fields,
                           ts_ms=ts if ts != now_ms else 0.0)
                mult = stream_flood_multiplier(plan, v.model,
                                               v.namespace)
                for k in range(mult - 1):
                    jittered = dict(fields)
                    jittered["arrival_rate_rpm"] = \
                        fields["arrival_rate_rpm"] * \
                        flood_rng.uniform(0.8, 1.2)
                    if k % 2:
                        # phantom groups: a relabeling storm minting
                        # ever-new identities, the attack the store cap
                        # absorbs (store-full sheds once it saturates)
                        push_group(
                            f"{v.model}--flood-"
                            f"{flood_rng.randrange(1_000_000)}",
                            v.namespace, jittered)
                    else:
                        push_group(v.model, v.namespace, jittered)

    restarted: set[int] = set()

    def pending_restart():
        for r in restart_rules:
            if id(r) in restarted:
                continue
            if r.in_window(plan.cycle, plan.now_s):
                return r
        return None

    def restart_controller(now_ms: float) -> None:
        """The controller process dies and comes back: fresh Reconciler,
        fresh emitter/decision log (in-memory state is gone), fresh
        StreamCore — warm via the checkpoint when the scenario carries
        one. Cluster (kube) and telemetry (prom) survive, of course."""
        nonlocal rec, core, emitter
        plan.controller_restart()     # record the trip in the evidence
        log.info("controller restart injected",
                 extra=kv(scenario=scenario.name, cycle=cycle,
                          t_s=now_ms / 1000.0))
        emitter = MetricsEmitter()
        rec = Reconciler(kube=kube, prom=prom, emitter=emitter,
                         now=sim_clock, sleep=lambda _s: None,
                         device=device, dtype=dtype, perf=sim_clock)
        if online_meter is not None:
            rec.attach_goodput_meter(online_meter, self_tick=False)
        if scenario.streaming:
            core = build_core()

    def on_tick(now_ms: float) -> None:
        nonlocal next_reconcile
        prom.scrape(now_ms)
        if restart_rules:
            rule = pending_restart()
            if rule is not None:
                restarted.add(id(rule))
                restart_controller(now_ms)
        meter_tick(now_ms)
        if core is not None:
            push_loads(now_ms)
            for result in core.process_once():
                after_cycle(now_ms, dict(result.degraded))
            return
        if now_ms >= next_reconcile:
            next_reconcile += interval_ms
            reconcile(now_ms)

    sim.run_until(scenario.duration_s * 1000.0, on_tick=on_tick,
                  tick_ms=tick_s * 1000.0)
    meter.flush(cycle, rec.decisions.annotate_goodput)

    variants = [
        VariantResult(
            name=st.spec.name, namespace=st.spec.namespace,
            chip=st.spec.chip, price_per_hour=st.price_per_hour,
            cost_dollar_seconds=st.ledger.cost_s,
            demand_seconds=st.ledger.demand_s,
            slo_demand_seconds=st.ledger.slo_demand_s,
            badput=dict(st.ledger.buckets),
            min_desired_after_publish=(
                st.ledger.min_desired_after_publish
                if st.ledger.min_desired_after_publish < UNPUBLISHED
                else 0),
            scaled_to_zero_on_stale=st.ledger.scaled_to_zero_on_stale,
        )
        for st in states
    ]
    return ScenarioResult(
        scenario=scenario.name, duration_s=scenario.duration_s,
        cycles=cycle, raised_cycles=raised, fault_trips=len(plan.trips),
        goodput_floor=scenario.goodput_floor, variants=variants,
        decisions=rec.decisions, emitter=emitter, tracer=rec.tracer,
        meter=meter,
    )
