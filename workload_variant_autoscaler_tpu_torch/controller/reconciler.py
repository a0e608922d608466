"""The reconcile loop: collect -> analyze -> optimize -> publish.

Counterpart of the reference package's `controller/reconciler.py`
(itself the Go reference's
internal/controller/variantautoscaling_controller.go:86-407). Each cycle is
level-triggered and stateless: configuration is re-read from the three
ConfigMaps, load is re-scraped from Prometheus, the engine system is
rebuilt from scratch, and all state lands back in the CR status + emitted
metrics. The analysis step runs all (variant, slice) candidates through
one decision per sizing group (System.calculate -> ops/fused.decide_batch)
on the Reconciler's device: on `cuda` the bisection runs as the CUDA
kernels of ops/bisect_kernel.py, on `cpu` as the PyTorch trip loop.

`Reconciler(..., device=None, dtype=None)` runs on the card unless the
caller passes `device="cpu"`; with no device given and no CUDA present it
raises. The solve engine comes from a `SolveEngineSelector` (the
WVA_INCREMENTAL_SOLVE / WVA_HIER_SOLVE knobs); the backend and the
device meshes come from controller/translate.py (WVA_NATIVE_KERNEL,
WVA_MESH_DEVICES, WVA_SHARDED_FLEET). With WVA_STREAM on (the default)
`run_forever` hands the loop
to the streaming core (stream/core.py), whose scoped micro-cycles call
`reconcile(scope=..., stream_loads=...)`.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Optional

from ..actuator import Actuator
from ..collector import (
    MODE_FLEET,
    MODE_LEGACY,
    MODE_REPAIR,
    MODE_STREAM,
    CountingPromAPI,
    FleetLoadCollector,
    IncompleteMetricsError,
    LoadCache,
    PromAPI,
    active_family,
    collect_inventory_k8s,
    collect_load,
    validate_metrics_availability,
)
from ..collector.prometheus import GuardedPromAPI
from ..metrics import (
    RECONCILE_STAGES,
    STAGE_ANALYZE,
    STAGE_CONFIG,
    STAGE_OPTIMIZE,
    STAGE_PREPARE,
    STAGE_PUBLISH,
    MetricsEmitter,
)
from ..models import SaturationPolicy, System
from ..obs import (
    CLAMP_REPLICA_STEP,
    CLAMP_DEGRADED_FREEZE,
    CLAMP_STABILIZATION,
    CLAMP_STALE_VETO,
    CLAMP_TTFT_BACKPRESSURE,
    HELD,
    LIMITED,
    DecisionBuilder,
    DecisionInputs,
    DecisionLog,
    GoodputMeter,
    Profiler,
    ResidualSampler,
    TickSample,
    Tracer,
)
from ..obs import trace as obs_trace
from ..solver import (
    SOLVE_FULL,
    HierarchicalSolveEngine,
    IncrementalSolveEngine,
    Manager,
    Optimizer,
)
from ..solver.greedy import candidate_chip_pools, pool_components
from ..solver.hierarchy import (
    DEFAULT_CHECKPOINT_EVERY,
    DEFAULT_CHECKPOINT_MAX_AGE_S,
    DEFAULT_MIN_VARIANTS,
    DEFAULT_SHARD_TARGET,
)
from ..solver.incremental import (
    DEFAULT_EPSILON,
    DEFAULT_FULL_EVERY,
    quantize_load,
)
from ..stream.state import FleetSnapshot, StreamState
from ..utils import (
    CIRCUIT_OPEN,
    STANDARD_BACKOFF,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    fanout,
    fanout_workers,
    full_name,
    get_logger,
    kv,
    parse_float_or,
    resolve_device,
    resolve_dtype,
    with_backoff,
)
from . import crd, translate
from .degradation import DegradationState, DegradationTracker, state_for_cache_tier
from .kube import Deployment, KubeClient

log = get_logger("wva.controller")

# Operator ConfigMap coordinates (reference variantautoscaling_controller.go:74-77)
CONFIG_MAP_NAME = "workload-variant-autoscaler-variantautoscaling-config"
CONFIG_MAP_NAMESPACE = "workload-variant-autoscaler-system"
ACCELERATOR_CM_NAME = "accelerator-unit-costs"
SERVICE_CLASS_CM_NAME = "service-classes-config"

DEFAULT_INTERVAL_SECONDS = 60.0

_OFF = ("off", "false", "0", "disabled")
_ON = ("on", "true", "1", "enabled")


class SolveEngineSelector:
    """Holds the last operator ConfigMap mapping and the current engine,
    and hands out the engine the knobs ask for: the reference
    Reconciler's `_solve_knob`, `_incremental_solve_enabled`,
    `_hier_solve_mode` and `_solve_engine` (same names). Knobs, each read
    from the environment first and then from the operator ConfigMap:

    - `WVA_INCREMENTAL_SOLVE` (default on): `off` means no engine (a
      full solve every cycle).
    - `WVA_HIER_SOLVE`: `auto` (default) is the hierarchical engine with
      the `WVA_HIER_MIN_VARIANTS` floor below which it delegates to the
      flat path; `on` forces the two-level path at any fleet size; `off`
      is the flat `IncrementalSolveEngine` itself, not a subclass.
    - `WVA_SOLVE_EPSILON`, `WVA_SOLVE_FULL_EVERY`,
      `WVA_HIER_SHARD_VARIANTS`, `WVA_HIER_MIN_VARIANTS`,
      `WVA_ARENA_CHECKPOINT` (a path; empty = no checkpoint),
      `WVA_ARENA_CHECKPOINT_EVERY`, `WVA_ARENA_CHECKPOINT_MAX_AGE_S`.

    A change of any knob rebuilds the engine, so the next cycle runs
    full, which is what a changed quantization requires."""

    def __init__(self, operator_cm: Optional[dict] = None,
                 engine: Optional[IncrementalSolveEngine] = None):
        self.operator_cm = dict(operator_cm or {})
        self.engine = engine

    def _solve_knob(self, key: str, operator_cm=None) -> str:
        return (os.environ.get(key)
                or (operator_cm if operator_cm is not None
                    else self.operator_cm).get(key)
                or "")

    def _incremental_solve_enabled(self, operator_cm=None) -> bool:
        """WVA_INCREMENTAL_SOLVE: signature-gated steady-state solving
        (default on)."""
        raw = self._solve_knob("WVA_INCREMENTAL_SOLVE", operator_cm)
        return raw.strip().lower() not in _OFF

    def _hier_solve_mode(self, operator_cm=None) -> str:
        """WVA_HIER_SOLVE as one of "auto", "on", "off"."""
        raw = self._solve_knob("WVA_HIER_SOLVE",
                               operator_cm).strip().lower()
        if raw in _OFF:
            return "off"
        if raw in _ON:
            return "on"
        return "auto"

    def _solve_engine(self, operator_cm=None
                      ) -> Optional[IncrementalSolveEngine]:
        """The cycle's incremental solve engine, or None when disabled.
        The current engine is kept while its knobs stand; a changed knob
        builds a new one."""
        if not self._incremental_solve_enabled(operator_cm):
            self.engine = None
            return None
        epsilon = parse_float_or(
            self._solve_knob("WVA_SOLVE_EPSILON", operator_cm),
            DEFAULT_EPSILON)
        full_every = int(parse_float_or(
            self._solve_knob("WVA_SOLVE_FULL_EVERY", operator_cm),
            DEFAULT_FULL_EVERY))
        if epsilon < 0:
            epsilon = DEFAULT_EPSILON
        engine = self.engine
        mode = self._hier_solve_mode(operator_cm)
        if mode == "off":
            if engine is None \
                    or type(engine) is not IncrementalSolveEngine \
                    or engine.epsilon != epsilon \
                    or engine.full_every != max(full_every, 0):
                engine = IncrementalSolveEngine(epsilon=epsilon,
                                                full_every=full_every)
                self.engine = engine
            return engine
        shard_target = max(int(parse_float_or(
            self._solve_knob("WVA_HIER_SHARD_VARIANTS", operator_cm),
            DEFAULT_SHARD_TARGET)), 1)
        min_variants = (0 if mode == "on" else max(int(parse_float_or(
            self._solve_knob("WVA_HIER_MIN_VARIANTS", operator_cm),
            DEFAULT_MIN_VARIANTS)), 0))
        ckpt_path = self._solve_knob("WVA_ARENA_CHECKPOINT",
                                     operator_cm).strip()
        ckpt_every = max(int(parse_float_or(
            self._solve_knob("WVA_ARENA_CHECKPOINT_EVERY", operator_cm),
            DEFAULT_CHECKPOINT_EVERY)), 1)
        ckpt_age = parse_float_or(
            self._solve_knob("WVA_ARENA_CHECKPOINT_MAX_AGE_S",
                             operator_cm),
            DEFAULT_CHECKPOINT_MAX_AGE_S)
        if engine is None \
                or type(engine) is not HierarchicalSolveEngine \
                or engine.epsilon != epsilon \
                or engine.full_every != max(full_every, 0) \
                or engine.shard_target != shard_target \
                or engine.min_variants != min_variants \
                or (engine.checkpoint_path or "") != ckpt_path \
                or engine.checkpoint_every != ckpt_every \
                or engine.checkpoint_max_age_s != ckpt_age:
            engine = HierarchicalSolveEngine(
                epsilon=epsilon, full_every=full_every,
                shard_target=shard_target, min_variants=min_variants,
                checkpoint_path=ckpt_path or None,
                checkpoint_every=ckpt_every,
                checkpoint_max_age_s=ckpt_age)
            self.engine = engine
        return engine


@dataclass
class ReconcileResult:
    requeue_after: float
    processed: list[str] = field(default_factory=list)
    skipped: dict[str, str] = field(default_factory=dict)  # name -> reason
    # name -> degradation-ladder rung label ("stale-cache" | "hold"; see
    # controller/degradation.py) for variants that did not run healthy
    degraded: dict[str, str] = field(default_factory=dict)
    error: Optional[str] = None


class Reconciler:
    # per-dependency breaker defaults: 5 consecutive exhausted-backoff
    # failures open the circuit; a 60s cooldown (one default interval)
    # passes before the single half-open probe
    BREAKER_THRESHOLD = 5
    BREAKER_RESET_S = 60.0

    def __init__(
        self,
        kube: KubeClient,
        prom: PromAPI,
        emitter: Optional[MetricsEmitter] = None,
        config_namespace: str = CONFIG_MAP_NAMESPACE,
        now=time.time,
        sleep=time.sleep,
        monotonic=time.monotonic,
        tracer: Optional[Tracer] = None,
        decisions: Optional[DecisionLog] = None,
        profiler: Optional[Profiler] = None,
        *,
        device=None,
        dtype=None,
    ):
        # the device and dtype every cycle's System is built on (and,
        # through it, the engines' arenas): `cuda` unless told otherwise,
        # raising when CUDA is absent; float32 unless float64 is asked
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.kube = kube
        self.prom = prom
        self.emitter = emitter or MetricsEmitter()
        self.actuator = Actuator(kube, self.emitter)
        self.config_namespace = config_namespace
        self.now = now
        self.sleep = sleep
        self.monotonic = monotonic
        # flight recorder (obs/): one trace per cycle, one immutable
        # DecisionRecord per variant per cycle (served over /debug/ by the
        # process entry point, a later slice of the port). Ring
        # capacities from WVA_TRACE_BUFFER / WVA_TRACE_DECISIONS. The
        # tracer derives span DURATIONS from the injected clock too, so
        # sim-time runs trace sim durations, deterministically.
        self.tracer = tracer or Tracer(now=now)
        self.decisions = decisions or DecisionLog(now=now)
        # wall-clock attribution ledger (obs/profile.py): each cycle's
        # trace folds into a ProfileRecord partitioning the cycle wall
        # into exclusive buckets + the unattributed residual; the
        # per-cycle device-audit delta (kernel builds/transfers) rides
        # along onto the inferno_jit_* series. Ring capacity from
        # WVA_PROFILE_BUFFER.
        self.profiler = profiler or Profiler()
        self._trace_log = os.environ.get(
            "WVA_TRACE_LOG", "").lower() in ("1", "true")
        # ALL engine state that outlives a stage call — the cycle
        # counter, decision scratchpads, stabilization history, probe
        # targets, the fleet snapshot, the merged export series — lives
        # in one explicit StreamState (stream/state.py). The streaming
        # core (stream/core.py) shares this object so the polled loop
        # and the event-driven consumer are two consumers of one engine;
        # the `_`-prefixed accessors below keep the historical attribute
        # names as properties.
        self.state = StreamState()
        # the streaming core, attached lazily by ensure_stream_core()
        # (run_forever with WVA_STREAM on, the process entry point,
        # tests); None means kick() keeps its wake-event-only semantics
        self.stream_core = None
        # per-dependency circuit breakers (utils/backoff.py): a dependency
        # that has failed `threshold` consecutive times fails FAST instead
        # of charging every cycle a full backoff ladder per call — badput
        # control. Clocked on self.now so sim-time tests drive cooldowns.
        threshold = int(parse_float_or(
            os.environ.get("WVA_BREAKER_THRESHOLD"), self.BREAKER_THRESHOLD))
        reset_s = parse_float_or(
            os.environ.get("WVA_BREAKER_RESET"), self.BREAKER_RESET_S)
        self.breakers = {
            "kube": CircuitBreaker("kube", failure_threshold=max(threshold, 1),
                                   reset_after_s=reset_s, clock=now,
                                   on_transition=self._on_breaker_transition),
            "prometheus": CircuitBreaker("prometheus",
                                         failure_threshold=max(threshold, 1),
                                         reset_after_s=reset_s, clock=now,
                                         on_transition=self._on_breaker_transition),
        }
        # scrape-path Prometheus client behind the breaker; the raw
        # client stays for the probe daemon thread (breakers are
        # single-threaded by design)
        self.guarded_prom = GuardedPromAPI(prom, self.breakers["prometheus"],
                                           emitter=self.emitter)
        # last-known-good loads with staleness tiers — the stale-cache
        # rung of the degradation ladder (collector/cache.py)
        self.load_cache = LoadCache()
        # deterministic jitter source for every retry ladder (the chaos
        # suite's no-wall-clock-randomness rule)
        self._rng = random.Random(0x57A)
        # set by kick() to wake run_forever early (watch-event trigger)
        self._wake = threading.Event()
        # the probe daemon thread's private Prometheus client (lazy; a
        # shared requests.Session is not thread-safe under concurrency).
        # The lock covers the lazy init: demand_probe() can be called
        # from the daemon thread and directly by tests/kick paths
        self._probe_prom = None
        self._probe_prom_lock = threading.Lock()
        # incremental solve engine (solver/incremental.py): persists the
        # signature cache / resident arena / warm-start seed across
        # cycles; (re)built lazily by the selector from the WVA_SOLVE_*
        # knobs and dropped when WVA_INCREMENTAL_SOLVE turns off
        self.engines = SolveEngineSelector()
        # live goodput meter (obs/goodput.py — the twin's meter, shared):
        # attached explicitly via attach_goodput_meter() or automatically
        # when WVA_GOODPUT_LIVE is on. None keeps the reconcile path
        # meter-free. The per-cycle capture dicts are filled by
        # _record_decision (NOT read back from the decision ring, whose
        # capacity can be smaller than the fleet) and consumed by
        # _feed_goodput in the cycle's finally.
        self._goodput_meter: Optional[GoodputMeter] = None
        self._goodput_self_tick = True
        self._goodput_last_tick: Optional[float] = None
        self._goodput_published: dict[str, int] = {}
        self._goodput_observed: dict[str, tuple] = {}
        if os.environ.get("WVA_GOODPUT_LIVE", "").lower() in ("1", "true"):
            self.attach_goodput_meter()

    # -- StreamState accessors --------------------------------------------
    # The historical private-attribute names, kept as properties over
    # the shared StreamState so the whole existing body of call sites
    # (and tests) reads/writes the same state the streaming core owns.

    @property
    def _cycle_index(self) -> int:
        return self.state.cycle_index

    @_cycle_index.setter
    def _cycle_index(self, value: int) -> None:
        self.state.cycle_index = value

    @property
    def _cycle_builders(self) -> dict:
        return self.state.cycle_builders

    @_cycle_builders.setter
    def _cycle_builders(self, value: dict) -> None:
        self.state.cycle_builders = value

    @property
    def _deadline(self):
        if self.state.deadline is None:
            self.state.deadline = Deadline.unlimited()
        return self.state.deadline

    @_deadline.setter
    def _deadline(self, value) -> None:
        self.state.deadline = value

    @property
    def _degradation(self):
        if self.state.degradation is None:
            self.state.degradation = DegradationTracker()
        return self.state.degradation

    @_degradation.setter
    def _degradation(self, value) -> None:
        self.state.degradation = value

    @property
    def _recommendations(self) -> dict:
        # scale-down stabilization history per VA (in-memory like HPA's
        # window; a restart just delays one scale-down — the fail-safe
        # direction)
        return self.state.recommendations

    @_recommendations.setter
    def _recommendations(self, value: dict) -> None:
        self.state.recommendations = value

    @property
    def _drift_strikes(self) -> dict:
        return self.state.drift_strikes

    @_drift_strikes.setter
    def _drift_strikes(self, value: dict) -> None:
        self.state.drift_strikes = value

    @property
    def _tpu_util_misses(self) -> dict:
        return self.state.tpu_util_misses

    @_tpu_util_misses.setter
    def _tpu_util_misses(self, value: dict) -> None:
        self.state.tpu_util_misses = value

    @property
    def _probe_targets(self) -> dict:
        return self.state.probe_targets

    @_probe_targets.setter
    def _probe_targets(self, value: dict) -> None:
        self.state.probe_targets = value

    @property
    def _last_operator_cm(self) -> dict:
        return self.state.last_operator_cm

    @_last_operator_cm.setter
    def _last_operator_cm(self, value: dict) -> None:
        self.state.last_operator_cm = value

    @property
    def _shared_ns_warned(self) -> tuple:
        return self.state.shared_ns_warned

    @_shared_ns_warned.setter
    def _shared_ns_warned(self, value: tuple) -> None:
        self.state.shared_ns_warned = value

    @property
    def _cycle_condition_vas(self) -> Optional[dict]:
        return self.state.cycle_condition_vas

    @_cycle_condition_vas.setter
    def _cycle_condition_vas(self, value: Optional[dict]) -> None:
        self.state.cycle_condition_vas = value

    @property
    def _last_capacity(self) -> dict:
        return self.state.last_capacity

    @_last_capacity.setter
    def _last_capacity(self, value: dict) -> None:
        self.state.last_capacity = value

    # -- fleet-scale collection knobs -------------------------------------

    def _fleet_collection_enabled(self, operator_cm=None) -> bool:
        """WVA_FLEET_COLLECTION: grouped O(metric-families) collection +
        one-LIST kube snapshots (default on). `off` is the escape hatch
        back to the per-variant reference shape — env first, then the
        operator ConfigMap (standard knob precedence)."""
        raw = (os.environ.get("WVA_FLEET_COLLECTION")
               or (operator_cm if operator_cm is not None
                   else self._last_operator_cm).get("WVA_FLEET_COLLECTION")
               or "")
        return raw.strip().lower() not in ("off", "false", "0", "disabled")

    def _fanout_workers(self) -> int:
        """WVA_COLLECT_FANOUT: worker threads for the residual
        per-variant calls (status writes, owner-ref patches, TPU-util
        probes). 1 = fully sequential (strict-determinism hatch)."""
        return fanout_workers(self._last_operator_cm)

    # -- streaming reconcile (stream/) ------------------------------------

    def _stream_enabled(self, operator_cm=None) -> bool:
        """WVA_STREAM: the event-driven streaming core behind
        run_forever (default on). `off` restores the polled cadence
        loop byte-for-byte — env first, then the operator ConfigMap
        (standard knob precedence)."""
        raw = (os.environ.get("WVA_STREAM")
               or (operator_cm if operator_cm is not None
                   else self._last_operator_cm).get("WVA_STREAM")
               or "")
        return raw.strip().lower() not in ("off", "false", "0", "disabled")

    def ensure_stream_core(self):
        """Attach (once) and return the streaming core. Lazy import:
        controller/ must stay importable without stream/ and vice
        versa."""
        if self.stream_core is None:
            from ..stream import StreamCore

            self.stream_core = StreamCore(self)
        return self.stream_core

    # -- incremental solve knobs (SolveEngineSelector) ---------------------

    def _knob_cm(self, operator_cm=None) -> dict:
        return (operator_cm if operator_cm is not None
                else self._last_operator_cm)

    @property
    def _solve_engine_obj(self) -> Optional[IncrementalSolveEngine]:
        return self.engines.engine

    def _solve_knob(self, key: str, operator_cm=None) -> str:
        return self.engines._solve_knob(key, self._knob_cm(operator_cm))

    def _incremental_solve_enabled(self, operator_cm=None) -> bool:
        """WVA_INCREMENTAL_SOLVE: signature-gated steady-state solving
        (default on)."""
        return self.engines._incremental_solve_enabled(
            self._knob_cm(operator_cm))

    def _hier_solve_mode(self, operator_cm=None) -> str:
        """WVA_HIER_SOLVE as one of "auto", "on", "off"."""
        return self.engines._hier_solve_mode(self._knob_cm(operator_cm))

    def _solve_engine(self, operator_cm=None) -> Optional[IncrementalSolveEngine]:
        """The cycle's incremental solve engine, or None when disabled.
        A knob change (epsilon / forced-full cadence / hier layout /
        checkpointing) rebuilds the engine — the next cycle runs full,
        which is exactly what a changed quantization requires."""
        return self.engines._solve_engine(self._knob_cm(operator_cm))

    # -- hardened dependency calls ----------------------------------------

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        """Breaker state changes are logged (with the cycle's trace id
        stamped by the formatter) on top of the span event the breaker
        itself records."""
        log.warning("circuit breaker transition",
                    extra=kv(dependency=name, from_state=old, to_state=new))

    def _retry_observer(self, dependency: str):
        """with_backoff telemetry hook -> the retries counter (the span
        events are recorded by with_backoff itself)."""
        def observe(event: str, **_fields) -> None:
            self.emitter.emit_retry(dependency, event)
        return observe

    def _kube_call(self, fn, backoff=STANDARD_BACKOFF, what="call"):
        """Every control-plane read/write: jittered exponential backoff
        under the per-cycle deadline budget, behind the kube circuit
        breaker. One exhausted backoff counts as ONE breaker failure;
        while the breaker is open calls fail fast with CircuitOpenError
        instead of paying the ladder again (badput control).

        Each call runs inside a `kube.<what>` trace span carrying its
        retries/backoff-sleeps/breaker events (a no-op child outside a
        cycle trace, so startup/daemon-thread calls don't pollute the
        ring), and feeds the inferno_dependency_latency_seconds histogram
        (ladder included — the series answers 'how long did the cycle
        wait on kube')."""
        with obs_trace.span(f"kube.{what}"):
            t0 = time.perf_counter()
            try:
                return self.breakers["kube"].call(
                    lambda: with_backoff(
                        fn, backoff=backoff, sleep=self.sleep,
                        rng=self._rng, deadline=self._deadline,
                        observer=self._retry_observer("kube")))
            except CircuitOpenError:
                self.emitter.emit_retry("kube", CIRCUIT_OPEN)
                raise
            finally:
                self.emitter.emit_dependency_latency(
                    "kube", time.perf_counter() - t0)

    def _cycle_budget_s(self) -> float:
        """WVA_CYCLE_DEADLINE: wall-clock budget all of a cycle's retry
        ladders share (env first, then the operator ConfigMap — standard
        knob precedence). Unset/0 = unlimited (the reference's
        behavior); set it below GLOBAL_OPT_INTERVAL so a cycle fails
        into a documented degraded state instead of eating its whole
        interval in nested backoffs."""
        raw = (os.environ.get("WVA_CYCLE_DEADLINE")
               or self._last_operator_cm.get("WVA_CYCLE_DEADLINE") or "")
        if not raw.strip():
            return math.inf
        try:
            budget = translate.parse_duration(raw)
        except ValueError:
            log.warning("bad WVA_CYCLE_DEADLINE, running unbounded",
                        extra=kv(value=raw))
            return math.inf
        return budget if budget > 0 else math.inf

    # -- config reading (reference controller.go:490-594) ----------------

    def read_operator_config(self) -> dict[str, str]:
        cm = self._kube_call(
            lambda: self.kube.get_configmap(CONFIG_MAP_NAME, self.config_namespace),
            what="get:ConfigMap/operator",
        )
        return cm.data

    def read_optimization_interval(self, operator_cm=None) -> float:
        data = self.read_operator_config() if operator_cm is None else operator_cm
        interval = data.get("GLOBAL_OPT_INTERVAL", "")
        if not interval:
            return DEFAULT_INTERVAL_SECONDS
        return translate.parse_duration(interval)

    def read_accelerator_config(self) -> dict[str, dict[str, str]]:
        cm = self._kube_call(
            lambda: self.kube.get_configmap(ACCELERATOR_CM_NAME, self.config_namespace),
            what="get:ConfigMap/accelerators",
        )
        return translate.parse_accelerator_configmap(cm.data)

    def read_service_class_config(self) -> dict[str, str]:
        cm = self._kube_call(
            lambda: self.kube.get_configmap(SERVICE_CLASS_CM_NAME, self.config_namespace),
            what="get:ConfigMap/service-classes",
        )
        return cm.data

    # -- the cycle (reference controller.go:86-202) ----------------------

    def reconcile(self, *, scope=None, stream_loads=None) -> ReconcileResult:
        """One cycle, with per-stage wall-clock timing published as
        inferno_reconcile_stage_duration_msec{stage=...} — whichever
        dependency stalls (apiserver config reads, Prometheus scrapes, the
        sizing kernel, status writes) shows up as its stage.

        Every cycle also ends on a documented degradation-ladder rung
        (controller/degradation.py), exported with the breaker states —
        even a cycle that dies in the config stage reads as a HOLD on the
        series, never as silence.

        The whole cycle is ONE trace (obs/): a root `reconcile` span,
        one child span per stage, and under those the dependency-call,
        solver, and fault-injection spans/events — every log line inside
        carries the cycle's trace_id.

        `scope`/`stream_loads` (keyword-only; the streaming core's
        entry, stream/core.py) turn the cycle into a SCOPED micro-cycle:
        only the named full_name keys are prepared/solved/published, fed
        from the pushed loads instead of Prometheus, against the last
        full pass's FleetSnapshot — zero ConfigMap reads, zero fleet
        LISTs. Wholesale-replaced series are merged, cross-cycle
        bookkeeping (pruning, capacity notes, TPU probes) is left to
        full passes. A scoped call before any full pass has taken a
        snapshot silently runs full. Default (None) is the legacy
        full-fleet cycle, byte-for-byte."""
        stages: dict[str, float] = {}
        t0 = time.perf_counter()
        self.state.scope = (frozenset(scope)
                            if scope and self.state.snapshot is not None
                            else None)
        self.state.stream_loads = (dict(stream_loads)
                                   if stream_loads
                                   and self.state.scope is not None
                                   else None)
        self.state.cycle_loads = {}
        self._cycle_index += 1
        self._cycle_builders = {}
        self._goodput_published = {}
        self._goodput_observed = {}
        # WVA_PROFILE_SAMPLE_HZ: the residual itemizer — a stdlib stack
        # sampler on THIS thread that breaks the ledger's unattributed /
        # stage-exclusive Python time down by caller. Wall-clock based,
        # off by default (0); `make bench-profile` turns it on.
        sampler = None
        sample_hz = parse_float_or(
            os.environ.get("WVA_PROFILE_SAMPLE_HZ")
            or self._last_operator_cm.get("WVA_PROFILE_SAMPLE_HZ"), 0.0)
        if sample_hz > 0:
            sampler = ResidualSampler(sample_hz).start()
        if self.state.scope is not None:
            # a per-event mini-trace: same span shape as a full cycle,
            # tagged with how many variants the event window covered
            root = self.tracer.begin("reconcile", cycle=self._cycle_index,
                                     stream_scope=len(self.state.scope))
        else:
            root = self.tracer.begin("reconcile", cycle=self._cycle_index)
        # the open slot for the stage currently running; mark() names it
        # after the stage it just completed and opens the next slot
        stage_span = [self.tracer.begin("stage")]

        def mark(stage: str) -> None:
            nonlocal t0
            t1 = time.perf_counter()
            stages[stage] = (t1 - t0) * 1000.0
            t0 = t1
            sp = stage_span[0]
            if sp is not None:
                sp.name = f"stage:{stage}"
                sp.finish()
            stage_span[0] = self.tracer.begin("stage")

        # fresh per-cycle budget and ladder bookkeeping; the budget knob
        # is read from the LAST seen operator CM (reading the fresh one
        # is itself a kube call that must run under the budget)
        self._deadline = Deadline(self._cycle_budget_s(),
                                  clock=self.monotonic)
        self._degradation = DegradationTracker()
        if self.state.stream_pressure:
            # the streaming core is serving this cycle under pressure
            # (overload shed, blown lag budget, coalesced escalation):
            # the cycle rides fresh evidence but the event-grained
            # latency contract is suspended, so mark the ladder
            self._degradation.record_cycle(DegradationState.STREAM_DEGRADED)
        err: Optional[BaseException] = None
        try:
            return self._reconcile_timed(mark)
        except BaseException as e:
            err = e
            # the cycle died before publishing anything: HOLD (the
            # published fleet state is frozen until a cycle succeeds)
            self._degradation.record_cycle(DegradationState.HOLD)
            # attribute in-flight time to the stage that raised (the first
            # unmarked one): a 30s apiserver backoff that ends in an
            # exception must read as 30s of config/prepare, not as an
            # instant healthy-looking cycle
            for stage in RECONCILE_STAGES:
                if stage not in stages:
                    mark(stage)
                    break
            raise
        finally:
            # drop the speculative slot opened after the last mark — it
            # covers nothing
            if stage_span[0] is not None:
                stage_span[0].cancel()
            cycle_state = self._degradation.cycle_state()
            root.set(degradation=cycle_state.label,
                     degradation_rung=int(cycle_state))
            root.finish(error=err)
            if self._trace_log:
                log.info("reconcile cycle trace",
                         extra=kv(trace_id=root.trace_id,
                                  cycle=self._cycle_index,
                                  duration_ms=round(root.duration_ms or 0, 3),
                                  spans=len(root.trace.spans),
                                  degradation=cycle_state.label,
                                  status=root.status))
            # fold the finished trace into the attribution ledger and
            # drain the cycle's device-audit delta onto the inferno_jit_*
            # series. Observability only: a ledger bug must not fail
            # (or re-fail) the cycle.
            try:
                residual = sampler.stop() if sampler is not None else None
                record = self.profiler.observe(
                    root.trace, cycle=self._cycle_index, ts=self.now(),
                    residual=residual)
                if record is not None:
                    self.emitter.emit_device_audit(record.device)
            except Exception as e:  # noqa: BLE001
                log.warning("cycle profile ledger failed",
                            extra=kv(error=str(e)))
            self.emitter.emit_cycle_timing(stages)
            samples = self._degradation.gauge_samples()
            if self.state.scope is None:
                self.state.rungs = dict(samples)
                self.emitter.emit_degradation_metrics(
                    dict(self.state.rungs), int(cycle_state))
            else:
                removed = self.state.merge_by_variant(
                    self.state.rungs, samples, set(samples))
                self.emitter.update_degradation_metrics(
                    samples, removed, int(cycle_state))
            self.emitter.emit_circuit_metrics(
                {name: b.state_code() for name, b in self.breakers.items()})
            if self._goodput_meter is not None:
                # the live goodput feed runs INSIDE the cycle's finally
                # so scoped micro-cycles and raising cycles meter too;
                # observability only — it must never (re-)fail the cycle
                try:
                    self._feed_goodput(int(cycle_state))
                except Exception as e:  # noqa: BLE001
                    log.warning("goodput meter feed failed",
                                extra=kv(error=str(e)))
            self.state.scope = None
            self.state.stream_loads = None

    def _reconcile_timed(self, mark) -> ReconcileResult:
        scope = self.state.scope
        snap = self.state.snapshot if scope is not None else None
        if snap is not None:
            # scoped micro-cycle (stream/core.py): config + fleet view
            # come from the last full pass's snapshot — zero ConfigMap
            # reads, zero fleet-wide LISTs on the event path
            operator_cm = dict(snap.operator_cm)
            self._last_operator_cm = operator_cm
            interval = snap.interval_s
            result = ReconcileResult(requeue_after=interval)
            accelerator_cm = snap.accelerator_cm
            service_class_cm = snap.service_class_cm
            vas = list(snap.vas.values())
        else:
            scope = None
            operator_cm = self.read_operator_config()
            self._last_operator_cm = operator_cm  # demand-probe knob source
            interval = self.read_optimization_interval(operator_cm)
            result = ReconcileResult(requeue_after=interval)

            accelerator_cm = self.read_accelerator_config()
            service_class_cm = self.read_service_class_config()

            vas = self._kube_call(self.kube.list_variant_autoscalings,
                                  what="list:VariantAutoscaling")
            # refresh the streaming snapshot: every full pass re-anchors
            # what later scoped micro-cycles solve against (`vas` below
            # are this cycle's working objects; _apply overlays the
            # fresh post-write copies)
            self.state.snapshot = FleetSnapshot(
                operator_cm=dict(operator_cm),
                accelerator_cm=accelerator_cm,
                service_class_cm=service_class_cm,
                interval_s=interval,
                vas={full_name(va.name, va.namespace): va
                     for va in vas if va.is_active()},
                taken_at=self.now(),
            )
        mark(STAGE_CONFIG)
        active = [va for va in vas if va.is_active()]
        if scope is not None:
            active = [va for va in active
                      if full_name(va.name, va.namespace) in scope]
        # fleet mode: the cycle's LIST copies are the condition-metrics
        # source of truth (updated with the fresh post-write objects in
        # _apply), so the post-publish re-LIST is not paid; legacy keeps
        # the LIST (None). Scoped cycles always use the in-hand objects
        # (a per-event LIST would defeat the point).
        self._cycle_condition_vas = (
            {full_name(va.name, va.namespace): va for va in active}
            if (self._fleet_collection_enabled(operator_cm)
                or scope is not None) else None)
        if scope is None:
            for va in vas:
                if not va.is_active():
                    result.skipped[full_name(va.name, va.namespace)] = \
                        "deleted"
            # drop stabilization history for VAs that no longer exist
            # (bounds memory; a recreated namesake starts with a clean
            # window). Scoped cycles see only their slice of the fleet
            # and must not prune the rest.
            active_keys = {full_name(va.name, va.namespace)
                           for va in active}
            for stale in [k for k in self._recommendations
                          if k not in active_keys]:
                del self._recommendations[stale]
            for stale in [k for k in self._drift_strikes
                          if k not in active_keys]:
                del self._drift_strikes[stale]
            self.load_cache.prune(active_keys)
        if scope is not None and not active:
            # every scoped variant left the fleet between the snapshot
            # and the event: nothing to do, nothing to clear
            return result
        if not active:
            log.info("no active VariantAutoscalings, skipping optimization")
            # no fleet: every per-variant/per-namespace series must read
            # empty, not hold its last value forever
            self._publish_power({})
            self._publish_conditions({})
            self._publish_drift({})
            self.emitter.emit_tpu_utilization_metrics({})
            self._note_capacity({})
            return result

        # limited mode (realizes the reference's dead greedy path +
        # CollectInventoryK8S stub, collector.go:37-42): allocate against
        # the cluster's actual per-generation chip inventory. Scoped
        # micro-cycles run limited ONLY when the streaming core vouches
        # the scope is closed under pool-connected components
        # (state.scope_pool_closed): shared capacity couples variants,
        # but only within a component, so a closed scope solved against
        # the snapshot's frozen capacity is exact. Open scopes still
        # escalate to full passes (stream/core.py) — the belt to this
        # suspender.
        limited = (operator_cm.get("WVA_LIMITED_MODE", "").lower() == "true"
                   and (scope is None or self.state.scope_pool_closed))
        capacity: dict[str, int] = {}
        if limited and scope is not None:
            # pool-scoped micro-cycle: the capacity view frozen by the
            # last full pass, zero node LISTs on the event path
            capacity = dict(snap.capacity)
            if not capacity:
                limited = False
        elif limited:
            try:
                capacity = self._kube_call(
                    lambda: collect_inventory_k8s(self.kube),
                    what="list:Node/inventory",
                )
            except Exception as e:  # noqa: BLE001
                log.error("node inventory failed; falling back to unlimited",
                          extra=kv(error=str(e)))
                # capacity-blind allocation is reduced-capability
                # operation: the LIMITED rung, visible on the series
                self._degradation.record_cycle(DegradationState.LIMITED)
                limited = False
            else:
                if not capacity:
                    # no recognised TPU nodes: zero pools would starve the
                    # whole fleet, which is indistinguishable from genuine
                    # saturation — fail open instead
                    log.warning(
                        "limited mode found no TPU inventory (no nodes with "
                        "google.com/tpu capacity and a known "
                        "gke-tpu-accelerator label); falling back to unlimited"
                    )
                    limited = False
                else:
                    log.info("limited mode capacity", extra=kv(**capacity))
        if scope is None:
            self._note_capacity(capacity if limited else {})
            if self.state.snapshot is not None:
                # freeze the capacity view for pool-scoped limited
                # micro-cycles (empty when unlimited: the streaming core
                # reads an empty view as "scoped limited unavailable")
                self.state.snapshot.capacity = (dict(capacity)
                                                if limited else {})

        policy = operator_cm.get("WVA_SATURATION_POLICY", "None")
        if SaturationPolicy.parse(policy).value != policy:
            log.warning(
                "unrecognised WVA_SATURATION_POLICY, using None",
                extra=kv(value=policy,
                         valid=[p.value for p in SaturationPolicy]),
            )

        system_spec = translate.create_system_data(
            accelerator_cm, service_class_cm,
            capacity=capacity,
            unlimited=not limited,
            saturation_policy=policy,
        )

        prepared = self._prepare(active, accelerator_cm, service_class_cm,
                                 system_spec, result,
                                 demand_headroom=self._demand_headroom(operator_cm),
                                 family=active_family(
                                     operator_cm.get("WVA_METRIC_FAMILY"),
                                     cm=operator_cm),
                                 drift_tolerance=self._cm_float(
                                     operator_cm, "WVA_DRIFT_TOLERANCE", 0.5),
                                 operator_cm=operator_cm)
        mark(STAGE_PREPARE)
        if not prepared:
            self._publish_power({})
            # nothing published -> nothing to probe
            self._set_probe_targets({})
            # skip-path conditions (MetricsAvailable=False etc.) were
            # written to the CRs above and must reach the series too
            self._emit_conditions()
            return result

        # analyze: ONE decision per sizing group across all candidates, on
        # the Reconciler's device (the CUDA kernels on the card). With the
        # incremental engine (WVA_INCREMENTAL_SOLVE, default on) only the
        # signature-changed sub-batch is solved; unchanged variants reuse
        # cached allocations and skip their kernel lanes entirely.
        system = System(device=self.device, dtype=self.dtype)
        optimizer_spec = system.set_from_spec(system_spec)
        if scope is None and self.state.snapshot is not None:
            # record each variant's pool-connected component so the
            # streaming core can scope limited micro-cycles to exactly
            # the components a drain touched (stream/core.py
            # _claim_scoped_limited); empty when unlimited — capacity
            # only couples variants through chip pools
            self.state.snapshot.pool_components = (
                pool_components(candidate_chip_pools(system))
                if limited else {})
        engine_backend = translate.engine_backend(system.device)
        ttft_percentile = translate.ttft_percentile(operator_cm)
        engine_mesh = translate.engine_mesh(engine_backend, system.device)
        fleet_mesh = translate.sharded_fleet_mesh(engine_backend,
                                                  system.device)
        # scoped micro-cycles bypass the incremental engine (its caches
        # describe the FULL fleet; a scoped pass must not advance or
        # prune them) and solve the event's sub-batch directly, through
        # a resident arena of their own. Loads are snapped to the SAME
        # WVA_SOLVE_EPSILON buckets the engine sizes on, so a streamed
        # decision is bit-equal to what the next full incremental pass
        # would publish for the same load.
        solve_engine = (self._solve_engine(operator_cm)
                        if scope is None else None)
        if scope is not None:
            epsilon = parse_float_or(
                self._solve_knob("WVA_SOLVE_EPSILON", operator_cm),
                DEFAULT_EPSILON)
            if epsilon < 0:
                epsilon = DEFAULT_EPSILON
            for server in system.servers.values():
                server.load = quantize_load(server.load, epsilon)
            if engine_mesh is None:
                system.arena = self.state.stream_arena
        if solve_engine is not None:
            stats = solve_engine.calculate(
                system, backend=engine_backend, mesh=engine_mesh,
                fleet_mesh=fleet_mesh,
                ttft_percentile=ttft_percentile,
                optimizer_spec=optimizer_spec,
                rungs=dict(result.degraded),
                cycle_rung=self._degradation.cycle_state().label)
            solve_modes = solve_engine.solve_modes
            self.emitter.emit_solve_metrics(
                stats.modes, stats.lanes_solved, stats.lanes_skipped)
            if isinstance(solve_engine, HierarchicalSolveEngine):
                self.emitter.emit_hier_solve(
                    stats.shards, solve_engine.drain_ckpt_events())
        else:
            # scoped micro-cycles stay unsharded: their sub-batches are
            # tiny and the stream arena is resident on one device
            system.calculate(
                backend=engine_backend,
                mesh=engine_mesh or (fleet_mesh if scope is None else None),
                ttft_percentile=ttft_percentile)
            solve_modes = dict.fromkeys(system.servers, SOLVE_FULL)
            self.emitter.emit_solve_metrics(
                {SOLVE_FULL: len(system.servers)},
                system.last_solve_lanes, 0)
        # stamp how each variant's sizing was produced onto its
        # DecisionRecord-in-progress (rendered by `controller explain`)
        for key, builder in self._cycle_builders.items():
            mode = solve_modes.get(key)
            if mode:
                builder.inputs = dc_replace(builder.inputs, solve_mode=mode)
        mark(STAGE_ANALYZE)

        # optimize (the stage mark is in a finally: a slow FAILING solve is
        # exactly the stall the stage series exists to expose)
        try:
            try:
                optimizer = Optimizer(optimizer_spec)
                manager = Manager(system, optimizer)
                manager.optimize(warm=(solve_engine.warm_start()
                                       if solve_engine is not None else None))
                self.emitter.emit_solution_time(optimizer.solution_time_msec)
                solution = system.generate_solution()
                if not solution.allocations:
                    raise RuntimeError("no feasible allocations found for any variant")
                if solve_engine is not None:
                    solve_engine.finish_cycle(system)
            finally:
                mark(STAGE_OPTIMIZE)
        except Exception as e:  # noqa: BLE001
            if solve_engine is not None:
                solve_engine.note_failure()
            log.error("optimization failed, retrying next cycle", extra=kv(error=str(e)))
            result.error = str(e)
            # conditions published, no new allocation: the LIMITED rung
            self._degradation.record_cycle(DegradationState.LIMITED)
            for va, _deploy in prepared:
                crd.set_condition(
                    va, crd.TYPE_OPTIMIZATION_READY, "False",
                    crd.REASON_OPTIMIZATION_FAILED, f"Optimization failed: {e}",
                    now=self.now(),
                )
                self._update_status(va)
                self._record_decision(
                    full_name(va.name, va.namespace), outcome=LIMITED,
                    reason=f"optimization failed: {e}",
                    published=va.status.desired_optimized_alloc.num_replicas)
            # the OptimizationReady=False writes must reach the series
            # too, or an alert keyed on the condition never fires
            self._emit_conditions()
            mark(STAGE_PUBLISH)  # the failure-condition status writes
            return result

        # publish (keyed by full name: same-named VAs in different
        # namespaces must not collide)
        stabilization_s = self._stabilization_window(operator_cm)
        noise_margin = self._noise_margin(operator_cm)
        replica_step = self._replica_step(operator_cm)
        backpressure = self._backpressure_factor(operator_cm)
        freeze = self._scaleup_freeze(operator_cm)
        optimized: dict[str, crd.OptimizedAlloc] = {}
        for va, _deploy in prepared:
            key = full_name(va.name, va.namespace)
            builder = self._cycle_builders.get(key)
            try:
                alloc = translate.create_optimized_alloc(
                    va.name, va.namespace, solution, now=self.now()
                )
            except KeyError:
                log.info("no optimized allocation for variant", extra=kv(variant=va.name))
                self._record_decision(
                    key, outcome=LIMITED,
                    reason="no feasible allocation for variant",
                    published=va.status.desired_optimized_alloc.num_replicas)
                continue
            proposed = alloc.num_replicas
            if builder is not None:
                builder.accelerator = alloc.accelerator
                builder.proposed_replicas = proposed
            prev_published = va.status.desired_optimized_alloc.num_replicas
            bp_state = self.state.backpressure.get(key)
            if bp_state is not None and bp_state[3] > 0:
                # a standing backpressure floor is an OVERLAY on the
                # solver path: the stabilization/step guards baseline on
                # the pre-floor published count, so a released floor
                # snaps back to the solver's answer in one cycle instead
                # of step-bleeding the boost for many cycles
                prev_published = min(prev_published, bp_state[3])
            alloc.num_replicas = self._stabilize_scale_down(
                key, alloc.num_replicas, stabilization_s,
                prev_published=prev_published,
                guard=self._demand_guard(system, key, noise_margin),
            )
            if builder is not None:
                builder.clamp(CLAMP_STABILIZATION, proposed,
                              alloc.num_replicas,
                              detail=f"window={stabilization_s:.0f}s, "
                                     f"noise_margin={noise_margin}")
            alloc.num_replicas = self._guard_actuation(
                key, alloc.num_replicas,
                prev_published=prev_published,
                current=_deploy.current_replicas(),
                stale=result.degraded.get(key) == "stale-cache",
                step=replica_step,
                decision=builder,
            )
            alloc.num_replicas = self._freeze_degraded_scaleup(
                key, alloc.num_replicas,
                prev_published=prev_published,
                current=_deploy.current_replicas(),
                freeze=freeze,
                decision=builder,
            )
            alloc.num_replicas = self._ttft_backpressure(
                key, alloc.num_replicas, system,
                prev_published=prev_published,
                current=_deploy.current_replicas(),
                factor=backpressure,
                fresh=(key not in result.degraded
                       and not self.state.stream_pressure),
                decision=builder,
            )
            optimized[key] = alloc
            self._record_decision(key, published=alloc.num_replicas)

        self._apply(prepared, optimized, result, system)
        self._emit_conditions()
        mark(STAGE_PUBLISH)
        return result

    def _scope_variants(self) -> set:
        """The current scope as (variant_name, namespace) pairs (empty
        when running full-fleet)."""
        scope = self.state.scope or ()
        out = set()
        for key in scope:
            name, _, ns = key.partition(":")
            out.add((name, ns))
        return out

    def _publish_power(self, power: dict) -> None:
        """Power series with merge semantics: a full cycle replaces the
        whole gauge (deleted variants' label sets clear); a scoped
        micro-cycle updates only its variants' samples in place — the
        rest of the fleet keeps exporting its last full-pass values, and
        the micro-cycle never pays a fleet-sized gauge rebuild."""
        if self.state.scope is None:
            self.state.power = dict(power)
            self.emitter.emit_power_metrics(dict(self.state.power))
            return
        removed = self.state.merge_by_variant(self.state.power, power,
                                              self._scope_variants())
        self.emitter.update_power_metrics(
            power, removed, sum(self.state.power.values()))

    def _publish_drift(self, samples: dict) -> None:
        """Same merge semantics as the power series."""
        if self.state.scope is None:
            self.state.drift = dict(samples)
            self.emitter.emit_drift_metrics(dict(self.state.drift))
            return
        removed = self.state.merge_by_variant(self.state.drift, samples,
                                              self._scope_variants())
        self.emitter.update_drift_metrics(samples, removed)

    def _set_probe_targets(self, targets: dict) -> None:
        """Demand-probe envelope table with the same merge semantics:
        full cycles rebuild it wholesale, scoped cycles replace only
        their variants' rows."""
        if self.state.scope is None:
            self._probe_targets = dict(targets)
            return
        variants = self._scope_variants()
        for key in [k for k in self._probe_targets
                    if tuple(k.partition(":")[::2]) in variants]:
            del self._probe_targets[key]
        self._probe_targets.update(targets)

    def _note_capacity(self, capacity: dict[str, int]) -> None:
        """Capacity-withdrawal visibility (docs/robustness.md node-pool
        faults): publish the cycle's per-generation chip inventory on
        inferno_pool_capacity_chips and log every shrink against the
        previous cycle — a maintenance drain or spot-reclamation wave is
        an observable capacity event, not a silent smaller solve. Pass {}
        outside limited mode (the gauge clears)."""
        for generation, prev in sorted(self._last_capacity.items()):
            cur = capacity.get(generation, 0)
            if cur < prev:
                log.warning(
                    "pool capacity withdrawn",
                    extra=kv(generation=generation, chips_before=prev,
                             chips_now=cur,
                             withdrawn=prev - cur))
        self._last_capacity = dict(capacity)
        self.emitter.emit_pool_capacity_metrics(capacity)

    def _record_decision(self, key: str, published: int,
                         outcome: str = "", reason: str = "") -> None:
        """Freeze this cycle's DecisionBuilder for `key` into the audit
        ring (no-op when preparation never created one)."""
        builder = self._cycle_builders.pop(key, None)
        if builder is None:
            return
        builder.published_replicas = published
        if outcome:
            builder.outcome = outcome
        if reason:
            builder.reason = reason
        if self._goodput_meter is not None:
            # capture for the goodput feed: what this cycle published
            # and what it observed (rate, TTFT, pre-publish replicas)
            self._goodput_published[key] = published
            inp = builder.inputs
            self._goodput_observed[key] = (inp.arrival_rate_rpm,
                                           inp.avg_ttft_ms,
                                           inp.current_replicas)
        self.decisions.record(builder.freeze(
            trace_id=obs_trace.current_trace_id() or "",
            cycle=self._cycle_index, ts=self.now()))

    # -- live goodput metering (obs/goodput.py) ---------------------------

    def attach_goodput_meter(self, meter: Optional[GoodputMeter] = None, *,
                             self_tick: bool = True) -> GoodputMeter:
        """Attach a GoodputMeter to the live feed path: every reconcile
        (polled loop and streaming micro-cycles alike) registers its
        candidates' pricing/SLOs, ticks the elapsed interval from the
        loads/TTFT it observed, folds in what it published (counts +
        capacity envelopes + degradation rungs), annotates the ended
        cycle's DecisionRecords with the interval's dominant badput
        bucket, and exports the inferno_goodput_* series.

        `self_tick=False` leaves `tick()` to an external caller that
        has ground truth — the digital twin in the equivalence harness
        (`emulator.twin.run_scenario(online_meter=...)`).

        With no `meter` given, one is built with the WVA_GOODPUT_WINDOW_S
        rolling window (default 900 s). Returns the attached meter."""
        if meter is None:
            window = parse_float_or(
                os.environ.get("WVA_GOODPUT_WINDOW_S"), 900.0)
            meter = GoodputMeter(window_s=window)
        self._goodput_meter = meter
        self._goodput_self_tick = self_tick
        self._goodput_last_tick = None
        return meter

    @property
    def goodput_meter(self) -> Optional[GoodputMeter]:
        return self._goodput_meter

    def _feed_goodput(self, cycle_rung: int) -> None:
        """One cycle's worth of live metering, run from the cycle's
        finally. Self-tick mode bills the interval since the previous
        cycle from what THIS cycle observed per decided variant — the
        live approximation of the twin's ground-truth ticks (absent
        variants simply don't bill); with self-tick off the external
        caller owns `tick()` and this feed contributes only the cycle
        observations, which is what makes twin-vs-online equivalence
        assertable."""
        meter = self._goodput_meter
        if self._goodput_self_tick:
            now = self.now()
            last = self._goodput_last_tick
            self._goodput_last_tick = now
            if last is not None and now > last:
                samples = {
                    key: TickSample(
                        demand_rps=rpm / 60.0,
                        ttft_ms=(ttft,) if ttft > 0.0 else (),
                        replicas=replicas)
                    for key, (rpm, ttft, replicas)
                    in self._goodput_observed.items()}
                meter.tick(now, now - last, samples)
        # the interval that just ended was governed by the PREVIOUS
        # cycle's publication: annotate those records
        flushed = meter.flush(self._cycle_index - 1,
                              annotate=self.decisions.annotate_goodput)
        meter.observe_cycle(
            published=dict(self._goodput_published),
            envelopes=self.capacity_envelopes(),
            rungs={full_name(n, ns): rung for (n, ns), rung
                   in self._degradation.gauge_samples().items()},
            cycle_rung=cycle_rung)
        summary = meter.summary()
        self.emitter.emit_goodput_metrics(
            summary["goodput_fraction"], flushed,
            meter.attainment_by_model())

    def _emit_conditions(self) -> None:
        """CR conditions as inferno_condition_status series (post-write
        truth), kube-state-metrics shape without kube-state-metrics —
        the shipped alerts can key on MetricsAvailable/OptimizationReady/
        PerfModelAccurate directly. Fleet mode reads the cycle's in-hand
        VA objects (the LIST copies, overlaid with the fresh post-write
        objects from _apply) instead of paying a third LIST per cycle;
        legacy mode keeps the post-publish re-LIST. Observability only:
        a failure here never fails the cycle."""
        try:
            if self._cycle_condition_vas is not None:
                vas = list(self._cycle_condition_vas.values())
            else:
                vas = self.kube.list_variant_autoscalings()
            samples: dict[tuple[str, str, str], str] = {}
            for va in vas:
                if not va.is_active():
                    continue
                for cond in va.status.conditions:
                    samples[(va.name, va.namespace, cond.type)] = cond.status
            self._publish_conditions(samples)
        except Exception as e:  # noqa: BLE001
            log.warning("condition metrics emission failed",
                        extra=kv(error=str(e)))

    def _publish_conditions(self, samples: dict) -> None:
        """Condition series with the power-gauge merge semantics: full
        cycles replace wholesale, scoped cycles update only their
        variants' condition sets in place."""
        if self.state.scope is None:
            self.state.conditions = dict(samples)
            self.emitter.emit_condition_metrics(
                dict(self.state.conditions))
            return
        removed = self.state.merge_by_variant(
            self.state.conditions, samples, self._scope_variants())
        self.emitter.update_condition_metrics(samples, removed)

    # -- scale-down stabilization (beyond-reference; HPA-style) -----------

    def _stabilization_window(self, operator_cm: dict[str, str]) -> float:
        """WVA_SCALE_DOWN_STABILIZATION duration from the operator
        ConfigMap; 0 (the default) preserves the reference's immediate
        scale-down behavior."""
        raw = operator_cm.get("WVA_SCALE_DOWN_STABILIZATION", "")
        if not raw:
            return 0.0
        try:
            return translate.parse_duration(raw)
        except ValueError:
            log.warning("bad WVA_SCALE_DOWN_STABILIZATION, ignoring",
                        extra=kv(value=raw))
            return 0.0

    @staticmethod
    def _cm_float(operator_cm: dict[str, str], key: str,
                  default: float) -> float:
        """Non-negative float knob from the operator ConfigMap; bad values
        warn and fall back to the default."""
        raw = operator_cm.get(key, "")
        if not raw:
            return default
        val = parse_float_or(raw, default=float("nan"))
        if val != val or val < 0.0:
            log.warning("bad operator config value, using default",
                        extra=kv(key=key, value=raw, default=default))
            return default
        return val

    def _noise_margin(self, operator_cm: dict[str, str]) -> float:
        """WVA_SCALE_DOWN_NOISE_MARGIN: relative noise band assumed on the
        demand the engine sizes for when deciding whether a scale-down is
        provably safe (default 0.2 — the observed band of 1m-rate
        estimates). 0 disables the guard (pure window stabilization)."""
        return self._cm_float(operator_cm, "WVA_SCALE_DOWN_NOISE_MARGIN", 0.2)

    @staticmethod
    def _demand_guard(system, key: str,
                      noise_margin: float) -> Optional[int]:
        """Replica count provably sufficient even if demand is
        noise_margin higher than sized-for: ceil(rate*(1+m)/rate*).
        Above this, held capacity is insurance against nothing — the
        window need not apply. `server.load.arrival_rate` is the demand
        the ENGINE sizes for, i.e. WVA_DEMAND_HEADROOM-inflated when that
        knob is set; the margin deliberately compounds on top — a guard
        computed from the raw measured rate would undercut the desired
        count whenever headroom > margin and bypass the window entirely
        (max(guard, desired) would collapse to desired). None (no guard)
        when the margin is disabled, demand reads zero (a transient empty
        scrape must not bypass the window), or the solve carries no
        per-replica rate."""
        if noise_margin <= 0.0:
            return None
        server = system.servers.get(key)
        if server is None or server.allocation is None or server.load is None:
            return None
        rate_star = server.allocation.max_arrv_rate_per_replica * 1000.0
        demand = server.load.arrival_rate / 60.0  # req/min -> req/sec
        if rate_star <= 0.0 or demand <= 0.0:
            return None
        return int(math.ceil(demand * (1.0 + noise_margin) / rate_star))

    def _stabilize_scale_down(self, key: str, desired: int, window_s: float,
                              prev_published: int = 0,
                              guard: Optional[int] = None) -> int:
        """Publish max(recommendations over the last window_s), capped by
        the demand guard: scale-up is immediate; a scale-down inside the
        measurement-noise band waits out the whole window; capacity the
        guard proves unnecessary even under noise_margin-inflated demand
        is released immediately. Kills replica-count flapping under noisy
        rate-window arrival estimates without paying a full window of
        chip-hours on every genuine ramp-down."""
        t = self.now()
        history = self._recommendations.setdefault(key, [])
        if window_s <= 0.0:
            history[:] = [(t, desired)]
            return desired
        cutoff = t - window_s
        while history and history[0][0] < cutoff:
            history.pop(0)
        if not history and prev_published > desired:
            # gap in the window (controller restart, or cycles skipped
            # longer than window_s): re-seed from the value on the CR
            # status so the published allocation is held one full window
            # instead of dropping instantly — the fail-safe direction
            history.append((t, prev_published))
        history.append((t, desired))
        stabilized = max(r for _t, r in history)
        if guard is not None:
            capped = max(guard, desired)
            if capped < stabilized:
                # the guard has proven the higher window entries obsolete:
                # lower the watermark in the history too, or one
                # guard-unavailable cycle (a transient empty scrape makes
                # _demand_guard return None) would re-publish the stale
                # high value and flap replicas right back up
                history[:] = [(t0, min(r, capped)) for t0, r in history]
                stabilized = capped
        return stabilized

    # -- actuation guardrails (degradation ladder; docs/robustness.md) ----

    def _replica_step(self, operator_cm: dict[str, str]) -> int:
        """WVA_MAX_REPLICA_STEP: hard bound on the per-cycle change of a
        variant's published replica count (0, the default, preserves the
        reference's unbounded behavior). At fleet scale one corrupted
        cycle must be a bounded blip, not a mass mis-scale: whatever the
        solver concluded, the published count moves at most `step` from
        the previous published value per cycle."""
        return int(self._cm_float(operator_cm, "WVA_MAX_REPLICA_STEP", 0.0))

    def _backpressure_factor(self, operator_cm: dict[str, str]) -> float:
        """WVA_TTFT_BACKPRESSURE: per-cycle multiplicative growth applied
        to a variant whose OBSERVED mean TTFT violates its SLO target on
        fresh evidence (1, the default, disables the guardrail). The
        observed-latency feedback the queueing model lacks: the solver
        sizes from its fitted profile, and when real queueing runs ahead
        of the model's optimism the fleet burns SLO for cycles while the
        solver keeps insisting the current size is fine — the worst-found
        attack of the adversarial search (docs/robustness.md,
        'Adversarial scenario search')."""
        return self._cm_float(operator_cm, "WVA_TTFT_BACKPRESSURE", 1.0)

    def _scaleup_freeze(self, operator_cm: dict[str, str]) -> bool:
        """WVA_DEGRADED_SCALEUP_FREEZE: on a cycle the streaming core
        flagged as pressure-degraded (overload shed, blown lag budget,
        coalesced escalation), freeze scale-UP at the previously
        published count (off by default). The evidence such a cycle
        sized on came from a shedding window — arrival counts amplified
        by replayed and coalesced pushes — and mass-scaling a fleet on
        amplified evidence is the adversarial search's dominant badput
        source (degradation-held surplus; docs/robustness.md,
        'Adversarial scenario search'). Scale-down and same-size publish
        are untouched, and the post-window backstop full pass re-sizes
        on clean evidence one cycle later."""
        return self._cm_float(
            operator_cm, "WVA_DEGRADED_SCALEUP_FREEZE", 0.0) > 0.0

    def _freeze_degraded_scaleup(self, key: str, published: int,
                                 prev_published: int, current: int,
                                 freeze: bool,
                                 decision: Optional[DecisionBuilder] = None,
                                 ) -> int:
        """Apply the degraded-evidence scale-up freeze: cap `published`
        at the previously published count (live deployment size on the
        first cycle) while the cycle rides stream pressure."""
        if not freeze or not self.state.stream_pressure:
            return published
        ceiling = max(prev_published if prev_published > 0 else current, 1)
        if published <= ceiling:
            return published
        log.warning("degraded-evidence scale-up frozen",
                    extra=kv(variant=key, proposed=published,
                             frozen_at=ceiling,
                             pressure=self.state.stream_pressure))
        if decision is not None:
            decision.clamp(
                CLAMP_DEGRADED_FREEZE, published, ceiling,
                detail=f"stream pressure ({self.state.stream_pressure}): "
                       f"scale-up on shed-window evidence frozen")
        return ceiling

    # TTFT-backpressure floor dynamics: after a boost the latency window
    # still averages over the pre-boost congestion, so growth pauses for
    # this many cycles before the evidence can ask for more; the standing
    # floor releases only once observed demand falls below this fraction
    # of the demand that provoked the boost (releasing on the first clean
    # window would shrink the fleet back into the very violation the
    # floor just fixed)
    BACKPRESSURE_COOLDOWN_CYCLES = 1
    BACKPRESSURE_RELEASE_FRAC = 0.7

    def _ttft_backpressure(self, key: str, published: int, system,
                           prev_published: int, current: int,
                           factor: float, fresh: bool,
                           decision: Optional[DecisionBuilder] = None,
                           ) -> int:
        """Observed-SLO backpressure floor on the published count. While
        the cycle's measured mean TTFT exceeds the variant's SLO target
        on fresh evidence, grow a floor multiplicatively (x factor over
        the published baseline, at most once per cooldown window so the
        averaging window can flush pre-boost congestion) and publish at
        least the floor. The floor then STANDS while the demand that
        provoked it persists — a single clean window is the floor
        working, not proof it is unnecessary — and releases when demand
        drops, handing ramp-down to the ordinary stabilized, step-bounded
        path. Degraded evidence never grows the floor (stale metrics are
        not evidence either way), and growth is bounded at x factor per
        cooldown: a corrupted latency metric cannot mass mis-scale the
        fleet in one cycle."""
        if factor <= 1.0:
            self.state.backpressure.pop(key, None)
            return published
        floor, boost_rpm, boost_cycle, _solver_prev = \
            self.state.backpressure.get(key, (0, 0.0, -1, 0))
        grown = False
        server = system.servers.get(key)
        # the OBSERVED latency rides the CollectedLoad this cycle sized
        # on (state.cycle_loads); the solver-facing ServerLoadSpec
        # carries only the demand shape
        namespace = key.partition(":")[2]
        load = self.state.cycle_loads.get(
            (server.model_name, namespace)) if server is not None else None
        svc = system.service_classes.get(
            server.service_class_name) if server is not None else None
        target = svc.target(server.model_name) if svc is not None else None
        if fresh and load is not None and target is not None \
                and target.slo_ttft > 0.0:
            if floor > 0 and load.arrival_rate_rpm \
                    < self.BACKPRESSURE_RELEASE_FRAC * boost_rpm:
                # demand-keyed release, judged BEFORE the latency check:
                # the latency window lags the demand drop by an averaging
                # window, and a floor held against demand that is gone is
                # pure over-provision. If latency is genuinely still bad
                # at the lower demand, the next fresh window re-engages
                # the boost with the new demand as its reference.
                log.info("ttft backpressure released",
                         extra=kv(variant=key, floor=floor,
                                  arrival_rpm=round(
                                      load.arrival_rate_rpm, 1),
                                  boost_rpm=round(boost_rpm, 1)))
                self.state.backpressure.pop(key, None)
                return published
            if load.avg_ttft_ms > target.slo_ttft:
                cooling = (floor > 0
                           and self.state.cycle_index - boost_cycle
                           <= self.BACKPRESSURE_COOLDOWN_CYCLES)
                if not cooling:
                    baseline = max(floor,
                                   prev_published if prev_published > 0
                                   else current, 1)
                    new_floor = max(floor,
                                    int(math.ceil(baseline * factor)))
                    if new_floor > floor:
                        floor, grown = new_floor, True
                        boost_rpm = load.arrival_rate_rpm
                        boost_cycle = self.state.cycle_index
                        log.warning(
                            "ttft backpressure engaged",
                            extra=kv(variant=key,
                                     observed_ttft_ms=round(
                                         load.avg_ttft_ms, 1),
                                     slo_ttft_ms=target.slo_ttft,
                                     solver_published=published,
                                     floor=floor))
        if floor > 0:
            # `published` is the post-guard SOLVER-path count: recorded
            # so next cycle's guards baseline on it (overlay semantics)
            self.state.backpressure[key] = (floor, boost_rpm,
                                            boost_cycle, published)
        if floor <= published:
            return published
        if decision is not None:
            detail = (f"floor={floor}, factor={factor:g}"
                      + (f", observed_ttft={load.avg_ttft_ms:.0f}ms > "
                         f"slo_ttft={target.slo_ttft:.0f}ms" if grown
                         else " (standing)"))
            decision.clamp(CLAMP_TTFT_BACKPRESSURE, published, floor,
                           detail=detail)
        return floor

    def _guard_actuation(self, key: str, desired: int, prev_published: int,
                         current: int, stale: bool, step: int,
                         decision: Optional[DecisionBuilder] = None) -> int:
        """Final bound on what a cycle may publish:

        - step bound: |published - baseline| <= step when configured,
          where baseline is the last published count (falling back to
          the live deployment size on the first cycle).
        - no scale-to-zero on stale evidence: a variant sized from the
          last-known-good cache may shrink (bounded, stabilized) but
          never to zero — absence of fresh metrics is not evidence of
          absent load.

        Each engaged guardrail lands in the variant's DecisionRecord as a
        named before/after clamp, so `explain` reproduces the published
        count from the record alone."""
        baseline = prev_published if prev_published > 0 else current
        guarded = desired
        if step > 0:
            lo = max(baseline - step, 0)
            hi = baseline + step
            bounded = min(max(guarded, lo), hi)
            if decision is not None:
                decision.clamp(CLAMP_REPLICA_STEP, guarded, bounded,
                               detail=f"baseline={baseline}, step={step}")
            guarded = bounded
        if stale and guarded == 0 and baseline > 0:
            if decision is not None:
                decision.clamp(CLAMP_STALE_VETO, guarded, 1,
                               detail="stale metrics: no scale-to-zero")
            guarded = 1
        if guarded != desired:
            log.warning(
                "actuation guardrail engaged",
                extra=kv(variant=key, desired=desired, published=guarded,
                         baseline=baseline, step=step, stale_metrics=stale),
            )
        return guarded

    # -- preparation (reference controller.go:218-335) -------------------

    def _demand_headroom(self, operator_cm: dict[str, str]) -> float:
        """WVA_DEMAND_HEADROOM: relative overprovisioning factor on the
        demand the engine sizes for (0, the default and the reference's
        behavior, sizes for exactly the measured rate). Positive values
        absorb ramp steps between reconcile cycles — the TTFT-tail knob;
        chip-hours rise accordingly."""
        return self._cm_float(operator_cm, "WVA_DEMAND_HEADROOM", 0.0)

    def _warn_shared_namespace_aggregation(self, active, family) -> None:
        """A dialect with no model label (JetStream's exporter labels
        series with its own `id`, not model_name) makes every per-variant
        query aggregate ALL models in the namespace — two VAs sharing a
        namespace are each silently sized on their combined load,
        over-provisioning both. Nothing can fix that from here (the label
        simply isn't on the wire), so detect and say so loudly, once per
        distinct offending set; WVA_JETSTREAM_MODEL_LABEL restores
        scoping where the scrape config relabels a model label back on."""
        if family is None or family.model_label:
            return
        counts: dict[str, int] = {}
        for va in active:
            counts[va.namespace] = counts.get(va.namespace, 0) + 1
        shared = tuple(sorted(ns for ns, n in counts.items() if n > 1))
        if shared and shared != self._shared_ns_warned:
            log.warning(
                "metric family has no model label: variants sharing a "
                "namespace are sized on their COMBINED load "
                "(set WVA_JETSTREAM_MODEL_LABEL or split namespaces)",
                extra=kv(family=family.name, namespaces=list(shared)))
        self._shared_ns_warned = shared

    def _prepare(self, active, accelerator_cm, service_class_cm, system_spec,
                 result, demand_headroom: float = 0.0, family=None,
                 drift_tolerance: float = 0.5, operator_cm=None):
        prepared: list[tuple[crd.VariantAutoscaling, Deployment]] = []
        # this cycle's drift readings, replacing the gauge wholesale at
        # the end (same invariant as the power series: deleted variants'
        # label sets are cleared, not left stale)
        drift_samples: dict[tuple[str, str, str], float] = {}
        class_by_key = translate.service_class_key_names(service_class_cm)
        # demand-breakout mode also tightens the CADENCE cycles: size on
        # max(1m, probe-window) so the probe-kicked reconcile sees the
        # ramp step its own probe detected, not the smoothed 1m average
        probe_window = (self.probe_window()
                        if self._probe_knob(self.PROBE_ENV, 0.0) > 0
                        else None)
        scoped = self.state.scope is not None
        if not scoped:
            # the warning keys on fleet-wide namespace sharing; a scoped
            # slice would flap the warned-set state
            self._warn_shared_namespace_aggregation(active, family)

        fleet_mode = self._fleet_collection_enabled(operator_cm)
        # one-LIST kube snapshot: the whole fleet's Deployments in one
        # call, indexed by (namespace, name), instead of a GET per
        # variant. A failed LIST falls back to per-variant GETs — the
        # pre-existing ladder, not a whole-fleet skip. Scoped
        # micro-cycles GET just their few Deployments instead of paying
        # a fleet-wide LIST per event.
        deploy_index: Optional[dict[tuple[str, str], Deployment]] = None
        if fleet_mode and active and not scoped:
            try:
                deploys = self._kube_call(
                    lambda: self.kube.list_deployments(),
                    what="list:Deployment")
            except Exception as e:  # noqa: BLE001
                log.warning(
                    "deployment LIST failed; per-variant gets this cycle",
                    extra=kv(error=str(e)))
            else:
                deploy_index = {(d.namespace, d.name): d for d in deploys}

        # -- pass 1: config screening + object resolution (no Prometheus)
        candidates: list[tuple[crd.VariantAutoscaling, Deployment, str,
                               float, str]] = []
        for va_listed in active:
            name = va_listed.name
            key = full_name(va_listed.name, va_listed.namespace)
            model = va_listed.spec.model_id
            if not model:
                result.skipped[key] = "missing modelID"
                continue

            preferred = class_by_key.get(va_listed.spec.slo_class_ref.key, "")
            try:
                target, class_name = translate.find_model_slo_in_spec(
                    system_spec, model, preferred_class=preferred
                )
            except (KeyError, ValueError) as e:
                log.error("no SLO for model", extra=kv(variant=name, model=model, error=str(e)))
                result.skipped[key] = "no SLO for model"
                continue

            # a malformed profile drops that slice shape only, not the VA
            # (reference controller.go:243-248)
            for profile in va_listed.spec.model_profile.accelerators:
                try:
                    translate.add_profile_to_system_data(system_spec, model, profile)
                except ValueError as e:
                    log.error("bad accelerator profile, dropping candidate",
                              extra=kv(variant=name, acc=profile.acc, error=str(e)))

            acc_name = va_listed.metadata.labels.get(crd.ACCELERATOR_LABEL, "")
            cost_str = accelerator_cm.get(acc_name, {}).get("cost")
            cost = parse_float_or(cost_str, default=float("nan"))
            if cost != cost:
                result.skipped[key] = "missing accelerator cost"
                continue
            if self._goodput_meter is not None:
                # the meter needs the variant's pricing + TTFT SLO to
                # judge its spend; idempotent metadata refresh per cycle
                self._goodput_meter.register(
                    va_listed.name, va_listed.namespace, model=model,
                    price_per_hour=cost, slo_ttft_ms=target.slo_ttft)

            if deploy_index is not None:
                deploy = deploy_index.get((va_listed.namespace, name))
                if deploy is None:
                    log.error("failed to get Deployment",
                              extra=kv(variant=name,
                                       error="not in the fleet snapshot"))
                    result.skipped[key] = "deployment not found"
                    continue
            else:
                try:
                    deploy = self._kube_call(
                        lambda: self.kube.get_deployment(name, va_listed.namespace),
                        what="get:Deployment",
                    )
                except Exception as e:  # noqa: BLE001
                    log.error("failed to get Deployment", extra=kv(variant=name, error=str(e)))
                    result.skipped[key] = "deployment not found"
                    continue

            if fleet_mode:
                # the LIST copy is this cycle's working object — the
                # per-variant re-GET was pure O(V) apiserver traffic
                # (conflict-retried status writes already re-fetch on 409)
                va = va_listed
            else:
                try:
                    va = self._kube_call(
                        lambda: self.kube.get_variant_autoscaling(name, va_listed.namespace),
                        what="get:VariantAutoscaling",
                    )
                except Exception as e:  # noqa: BLE001
                    result.skipped[key] = "variant not found"
                    continue

            candidates.append((va, deploy, acc_name, cost, class_name))

        # -- pass 1b: ownerReference patches, fanned out (first so GC
        # works even before metrics exist, reference controller.go:276-293)
        need_patch = [(va, deploy) for va, deploy, _acc, _cost, _cls
                      in candidates if not va.is_controlled_by(deploy.uid)]
        patch_failed: set[str] = set()
        if need_patch:
            outcomes = fanout(
                [lambda va=va, deploy=deploy: self._kube_call(
                    lambda: self.kube.patch_owner_reference(va, deploy),
                    what="patch:VariantAutoscaling/ownerRef")
                 for va, deploy in need_patch],
                workers=self._fanout_workers(), label="ownerref")
            for (va, _deploy), (_res, err) in zip(need_patch, outcomes):
                if err is not None:
                    log.error("failed to set ownerReference",
                              extra=kv(variant=va.name, error=str(err)))
                    key = full_name(va.name, va.namespace)
                    result.skipped[key] = "ownerReference patch failed"
                    patch_failed.add(key)

        # -- pass 2: load collection + decision building. Fleet mode
        # prefetches ~8 grouped queries and demuxes per variant; labels
        # missing from the grouped result (or a failed prefetch) repair
        # through the per-variant queries — the exact pre-existing
        # semantics, proven by running the SAME validate/collect code
        # against the demux view.
        collect_t0 = time.perf_counter()
        fleet: Optional[FleetLoadCollector] = None
        legacy_prom: Optional[CountingPromAPI] = None
        if fleet_mode:
            fleet = FleetLoadCollector(self.guarded_prom,
                                       family=family or active_family(),
                                       probe_window=probe_window)
        else:
            legacy_prom = CountingPromAPI(self.guarded_prom)
        for va, deploy, acc_name, cost, class_name in candidates:
            name = va.name
            key = full_name(va.name, va.namespace)
            model = va.spec.model_id
            if key in patch_failed:
                continue
            if fleet is not None:
                variant_prom, collection_mode = fleet.variant_prom(
                    model, deploy.namespace)
            else:
                variant_prom, collection_mode = legacy_prom, MODE_LEGACY

            # metrics gate: a live scrape is HEALTHY; any dependency or
            # evidence failure falls through to the last-known-good cache
            # (STALE_CACHE rung) and only a cache miss/expiry HOLDs the
            # variant — the documented degradation ladder
            # (docs/robustness.md). A load pushed by the streaming
            # ingest (stream/core.py) IS live evidence — fresher than
            # any scrape — and replaces the whole Prometheus round-trip
            # for this variant (mode "stream" on the DecisionRecord).
            load = None
            fallback = None  # (skip_reason, condition_reason, message)
            streamed = (self.state.stream_loads or {}).get(key)
            if streamed is not None:
                collection_mode = MODE_STREAM
                load = streamed
                crd.set_condition(
                    va, crd.TYPE_METRICS_AVAILABLE, "True",
                    crd.REASON_METRICS_FOUND,
                    "load folded from streamed ingest (remote-write/"
                    "streamed scrape)", now=self.now(),
                )
            else:
                validation = validate_metrics_availability(
                    variant_prom, model, deploy.namespace, now=self.now(),
                    family=family,
                )
                if validation.available:
                    crd.set_condition(
                        va, crd.TYPE_METRICS_AVAILABLE, "True",
                        validation.reason, validation.message,
                        now=self.now(),
                    )
                    try:
                        load = collect_load(variant_prom, model,
                                            deploy.namespace,
                                            fallback=self._last_known_load(va),
                                            family=family,
                                            probe_window=probe_window)
                    except IncompleteMetricsError as e:
                        # loaded variant with unusable modeling series:
                        # scaling it on zero-filled data would tear it
                        # down to min replicas (the reference zero-fills
                        # here)
                        log.warning("metrics incomplete",
                                    extra=kv(variant=name,
                                             missing=e.missing))
                        fallback = (crd.REASON_METRICS_INCOMPLETE,
                                    crd.REASON_METRICS_INCOMPLETE, str(e))
                    except Exception as e:  # noqa: BLE001
                        log.error("failed to collect metrics",
                                  extra=kv(variant=name, error=str(e)))
                        fallback = ("metric collection failed",
                                    crd.REASON_PROMETHEUS_ERROR,
                                    f"Failed to collect metrics: {e}")
                else:
                    log.warning(
                        "metrics unavailable",
                        extra=kv(variant=name, reason=validation.reason,
                                 troubleshooting=validation.message),
                    )
                    fallback = (validation.reason, validation.reason,
                                validation.message)

            stale_load = False
            if fallback is not None:
                skip_reason, cond_reason, message = fallback
                # surface the outage on the CR either way: a stale
                # MetricsAvailable=True must not outlive a broken scrape
                crd.set_condition(
                    va, crd.TYPE_METRICS_AVAILABLE, "False",
                    cond_reason, message, now=self.now(),
                )
                cached, tier = self.load_cache.get(key, self.now())
                if cached is None:
                    # nothing trustworthy to size on: HOLD (published
                    # allocation frozen; zero actuations)
                    self._update_status(va)
                    result.skipped[key] = skip_reason
                    result.degraded[key] = DegradationState.HOLD.label
                    self._degradation.record(va.name, va.namespace,
                                             DegradationState.HOLD)
                    prev = va.status.desired_optimized_alloc.num_replicas
                    self._cycle_builders[key] = DecisionBuilder(
                        variant=va.name, namespace=va.namespace,
                        accelerator=acc_name,
                        inputs=DecisionInputs(
                            degradation=DegradationState.HOLD.label,
                            cost_per_replica=cost,
                            current_replicas=deploy.current_replicas(),
                            prev_published=prev,
                            collection_mode=collection_mode,
                        ),
                        proposed_replicas=prev,
                    )
                    self._record_decision(key, outcome=HELD,
                                          reason=skip_reason,
                                          published=prev)
                    continue
                state = state_for_cache_tier(tier)
                log.warning(
                    "sizing on last-known-good metrics",
                    extra=kv(variant=name, reason=skip_reason, tier=tier,
                             arrival_rpm=round(cached.arrival_rate_rpm, 2)),
                )
                load = cached
                stale_load = True
                result.degraded[key] = state.label
                self._degradation.record(va.name, va.namespace, state)
            else:
                self.load_cache.put(key, load, self.now())
                self._degradation.record(va.name, va.namespace,
                                         DegradationState.HEALTHY)

            # what this cycle actually sizes on, for the streaming
            # core's consumed-signature bookkeeping (stream/core.py)
            self.state.cycle_loads[(model, deploy.namespace)] = load

            # open this cycle's decision scratchpad: the solve inputs are
            # now known; the publish loop adds proposal + clamps and
            # freezes it into the audit ring (obs/decision.py)
            rung = (DegradationState.STALE_CACHE if stale_load
                    else DegradationState.HEALTHY)
            self._cycle_builders[key] = DecisionBuilder(
                variant=va.name, namespace=va.namespace,
                accelerator=acc_name,
                inputs=DecisionInputs(
                    arrival_rate_rpm=load.arrival_rate_rpm,
                    avg_input_tokens=load.avg_input_tokens,
                    avg_output_tokens=load.avg_output_tokens,
                    avg_ttft_ms=load.avg_ttft_ms,
                    avg_itl_ms=load.avg_itl_ms,
                    degradation=rung.label,
                    cost_per_replica=cost,
                    current_replicas=deploy.current_replicas(),
                    prev_published=va.status.desired_optimized_alloc.num_replicas,
                    collection_mode=collection_mode,
                ),
            )

            va.status.current_alloc = crd.Allocation(
                accelerator=acc_name,
                num_replicas=deploy.current_replicas(),
                max_batch=self._configured_max_batch(va, acc_name),
                variant_cost=f"{deploy.current_replicas() * cost:.2f}",
                itl_average=f"{load.avg_itl_ms:.2f}",
                ttft_average=f"{load.avg_ttft_ms:.2f}",
                load=crd.LoadProfile(
                    arrival_rate=f"{load.arrival_rate_rpm:.2f}",
                    avg_input_tokens=f"{load.avg_input_tokens:.2f}",
                    avg_output_tokens=f"{load.avg_output_tokens:.2f}",
                ),
            )

            translate.add_server_info_to_system_data(
                system_spec, va, class_name, demand_headroom=demand_headroom)
            self._track_drift(va, acc_name, load, deploy.current_replicas(),
                              system_spec, drift_tolerance, drift_samples,
                              stale=stale_load)
            prepared.append((va, deploy))
            result.processed.append(key)
        # collection telemetry: the query counts per path are the series
        # that PROVE O(metric-families) collection (and flag demux rot:
        # a repair count tracking the fleet size)
        if fleet is not None:
            queries_by_mode = {MODE_FLEET: fleet.query_count,
                               MODE_REPAIR: fleet.repair_query_count}
        else:
            queries_by_mode = {MODE_LEGACY: legacy_prom.count}
        self.emitter.emit_collection_metrics(
            queries_by_mode, time.perf_counter() - collect_t0)
        self._publish_drift(drift_samples)
        if not scoped:
            # the per-namespace TPU gauges are observability-only and
            # wholesale-replaced; the backstop cadence keeps them fresh
            # without charging every micro-cycle two queries/namespace
            self._collect_tpu_utilization(
                {deploy.namespace for _va, deploy in prepared},
                operator_cm=operator_cm)
        return prepared

    # after this many consecutive empty probes a namespace's TPU-gauge
    # scrape drops to every Nth cycle: clusters without the
    # tpu-monitoring-library series should not pay two dead queries per
    # namespace on every reconcile
    TPU_UTIL_MISS_LIMIT = 3
    TPU_UTIL_RETRY_EVERY = 10

    def _collect_tpu_utilization(self, namespaces: set[str],
                                 operator_cm=None) -> None:
        """TPU runtime gauges (duty cycle / HBM) per serving namespace,
        opportunistic and observability-only. WVA_TPU_METRICS=false
        (env first, then the operator ConfigMap — the standard knob
        precedence) disables the scrape outright; otherwise namespaces
        whose series are absent are backed off to an occasional re-probe
        (they appear within at most TPU_UTIL_RETRY_EVERY cycles of the
        DaemonSet being installed)."""
        knob = (os.environ.get("WVA_TPU_METRICS")
                or (operator_cm or {}).get("WVA_TPU_METRICS") or "")
        if knob.lower() in ("0", "false"):
            # clear whatever a previously-enabled scrape exported
            self.emitter.emit_tpu_utilization_metrics({})
            return
        from ..collector import collect_tpu_utilization

        out: dict[str, dict[str, float]] = {}
        probing: list[str] = []
        for ns in sorted(namespaces):
            misses, skipped = self._tpu_util_misses.get(ns, (0, 0))
            if misses >= self.TPU_UTIL_MISS_LIMIT and \
                    skipped + 1 < self.TPU_UTIL_RETRY_EVERY:
                self._tpu_util_misses[ns] = (misses, skipped + 1)
                out[ns] = {}   # backed off, known-absent
                continue
            probing.append(ns)
        # two queries per probed namespace, fanned out (a many-namespace
        # fleet must not serialize 2·N round-trips); collect_tpu_...
        # swallows its own errors, so results are always dicts
        outcomes = fanout(
            [lambda ns=ns: collect_tpu_utilization(self.guarded_prom, ns)
             for ns in probing],
            workers=self._fanout_workers(), label="tpu-util")
        for ns, (sample, _err) in zip(probing, outcomes):
            sample = sample or {}
            out[ns] = sample
            if sample:
                self._tpu_util_misses.pop(ns, None)
            else:
                misses, _skipped = self._tpu_util_misses.get(ns, (0, 0))
                self._tpu_util_misses[ns] = (misses + 1, 0)
        # drop back-off state for namespaces that left the fleet — under
        # namespace churn the dict would otherwise grow without bound
        # (unlike _probe_targets, which is rebuilt wholesale each publish)
        for ns in list(self._tpu_util_misses):
            if ns not in namespaces:
                del self._tpu_util_misses[ns]
        # ALWAYS emit, even empty: the wholesale clear()+set is how a
        # namespace that dropped out of the fleet stops exporting its
        # last duty-cycle/HBM reading
        self.emitter.emit_tpu_utilization_metrics(out)

    # consecutive out-of-tolerance cycles before the condition flips: one
    # noisy 1m-rate sample or a transient must not brand the profile bad
    DRIFT_STRIKES = 3

    def _track_drift(self, va, acc_name, load, current_replicas,
                     system_spec, tolerance: float,
                     drift_samples: dict, stale: bool = False) -> None:
        """Compare observed latency averages against the queueing model's
        prediction at the current operating point; persistent mismatch
        sets PerfModelAccurate=False on the CR (see controller/drift.py).
        tolerance <= 0 disables the watchdog — and removes any condition
        a previously-enabled watchdog left behind, so a stale verdict
        can't outlive the feature. stale=True (the load came from the
        last-known-good cache) makes the operating point unjudgeable:
        cached latencies are evidence about the PAST allocation."""
        from . import drift as drift_mod

        key = full_name(va.name, va.namespace)
        if tolerance <= 0:
            self._drift_strikes.pop(key, None)
            crd.remove_condition(va, crd.TYPE_PERF_MODEL_ACCURATE)
            return
        reading = drift_mod.predict_latency(
            system_spec, va.spec.model_id, acc_name, load, current_replicas,
            server_max_batch=translate.profile_max_batch(va, acc_name),
            stale=stale,
        )
        if reading is None:
            # unjudgeable point (idle, saturated, missing profile, nothing
            # observed): keep the previous condition, decay nothing
            return
        for metric, ratio in (("itl", reading.itl_ratio),
                              ("ttft", reading.ttft_ratio)):
            if ratio is not None:
                drift_samples[(va.name, va.namespace, metric)] = ratio
        if drift_mod.within_tolerance(reading, tolerance):
            self._drift_strikes[key] = 0
            crd.set_condition(
                va, crd.TYPE_PERF_MODEL_ACCURATE, "True",
                crd.REASON_MODEL_MATCHES,
                "observed ITL/TTFT match the fitted profile at the current "
                "operating point",
                now=self.now(),
            )
            return
        strikes = self._drift_strikes.get(key, 0) + 1
        self._drift_strikes[key] = strikes
        log.warning(
            "perf-model drift detected",
            extra=kv(variant=va.name, strikes=strikes,
                     itl_ratio=reading.itl_ratio,
                     ttft_ratio=reading.ttft_ratio,
                     predicted_itl_ms=round(reading.predicted_itl_ms, 2),
                     predicted_ttft_ms=round(reading.predicted_ttft_ms, 2)),
        )
        if strikes >= self.DRIFT_STRIKES:
            crd.set_condition(
                va, crd.TYPE_PERF_MODEL_ACCURATE, "False",
                crd.REASON_PROFILE_DRIFT,
                (f"observed/predicted latency ratios (itl "
                 f"{reading.itl_ratio and round(reading.itl_ratio, 2)}, ttft "
                 f"{reading.ttft_ratio and round(reading.ttft_ratio, 2)}) "
                 f"outside tolerance {tolerance} for {strikes} consecutive "
                 "cycles: re-fit the variant's perf profile "
                 "(python -m workload_variant_autoscaler_tpu.fit, or "
                 "docs/tutorials/parameter-estimation.md)"),
                now=self.now(),
            )

    @staticmethod
    def _last_known_load(va: crd.VariantAutoscaling):
        """Token stats last published to the CR status — the checkpoint
        collect_load falls back to when arrivals resume after a quiet
        window (scale-from-zero) and no completion aggregates exist yet."""
        from ..collector import CollectedLoad

        prev = va.status.current_alloc.load
        return CollectedLoad(
            arrival_rate_rpm=parse_float_or(prev.arrival_rate, 0.0),
            avg_input_tokens=parse_float_or(prev.avg_input_tokens, 0.0),
            avg_output_tokens=parse_float_or(prev.avg_output_tokens, 0.0),
            avg_ttft_ms=0.0,
            avg_itl_ms=0.0,
        )

    @staticmethod
    def _configured_max_batch(va: crd.VariantAutoscaling, acc_name: str) -> int:
        """Max batch for status publication: the variant's profile value,
        defaulting to 256 when unprofiled (the reference hardcodes 256 with
        a TODO, collector.go:259). Shares the lookup with the engine
        translation via translate.profile_max_batch."""
        return translate.profile_max_batch(va, acc_name) or 256

    # -- application (reference controller.go:338-407) -------------------

    def _apply(self, prepared, optimized, result, system) -> None:
        from ..collector import true_arrival_rate_query

        family = active_family(
            self._last_operator_cm.get("WVA_METRIC_FAMILY"),
            cm=self._last_operator_cm)
        probe_targets: dict[str, tuple[str, float]] = {}
        power: dict[tuple[str, str, str], float] = {}
        fleet_mode = self._cycle_condition_vas is not None
        publishing: list[tuple[crd.VariantAutoscaling, Deployment]] = []
        for va, _deploy in prepared:
            key = full_name(va.name, va.namespace)
            if key not in optimized:
                continue
            # power is derived from the solve + the published count, not
            # from the fresh CR — record it before the re-get so a
            # transient apiserver failure can't erase a live variant's
            # series from the wholesale-replaced gauge
            power[(va.name, va.namespace, optimized[key].accelerator)] = (
                system.variant_power_watts(
                    key, replicas=optimized[key].num_replicas))
            # capacity envelope for the demand-breakout probe: the rate
            # the PUBLISHED replica count sustains at the sized operating
            # point (req/s); a mid-interval probe comparing live demand
            # against this decides whether to kick an early cycle
            server = system.servers.get(key)
            if server is not None and server.allocation is not None:
                cap = (optimized[key].num_replicas
                       * server.allocation.max_arrv_rate_per_replica
                       * 1000.0)
                if cap > 0:
                    probe_targets[key] = (
                        true_arrival_rate_query(va.spec.model_id,
                                                va.namespace, family,
                                                window=self.probe_window()),
                        cap,
                    )
            publishing.append((va, _deploy))

        def publish_one(va: crd.VariantAutoscaling, deploy: Deployment):
            """Per-variant status write (re-get, signal emission, status
            PUT) — the residual unavoidably-per-variant kube traffic,
            fanned out over WVA_COLLECT_FANOUT workers. Returns the
            written object (the condition-metrics source), or None when
            the re-get failed (logged; the variant keeps its previous
            published state)."""
            key = full_name(va.name, va.namespace)
            try:
                fresh = self._kube_call(
                    lambda: self.kube.get_variant_autoscaling(va.name, va.namespace),
                    what="get:VariantAutoscaling/fresh",
                )
            except Exception as e:  # noqa: BLE001
                log.error("failed to re-get variant", extra=kv(variant=va.name, error=str(e)))
                return None

            fresh.status.current_alloc = va.status.current_alloc
            # the previously PUBLISHED recommendation, for the scaling-
            # decision counter (captured before it is overwritten)
            prev_desired = fresh.status.desired_optimized_alloc.num_replicas
            fresh.status.desired_optimized_alloc = optimized[key]
            fresh.status.actuation.applied = False
            # carry conditions set during preparation across the fresh get
            # (reference controller.go:367-370)
            fresh.status.conditions = va.status.conditions

            crd.set_condition(
                fresh, crd.TYPE_OPTIMIZATION_READY, "True",
                crd.REASON_OPTIMIZATION_SUCCEEDED,
                f"Optimization completed: {fresh.status.desired_optimized_alloc.num_replicas} "
                f"replicas on {fresh.status.desired_optimized_alloc.accelerator}",
                now=self.now(),
            )

            # fleet mode reuses this cycle's Deployment snapshot for the
            # current-replicas signal instead of a per-variant re-GET;
            # legacy keeps the live read
            if self.actuator.emit_metrics(
                    fresh, prev_desired=prev_desired,
                    current=(deploy.current_replicas()
                             if fleet_mode else None)):
                fresh.status.actuation.applied = True

            self._update_status(fresh)
            return fresh

        outcomes = fanout(
            [lambda va=va, deploy=deploy: publish_one(va, deploy)
             for va, deploy in publishing],
            workers=self._fanout_workers(), label="apply")
        snap = self.state.snapshot
        for fresh, _err in outcomes:
            if fresh is None:
                continue
            key = full_name(fresh.name, fresh.namespace)
            if self._cycle_condition_vas is not None:
                self._cycle_condition_vas[key] = fresh
            # keep the streaming snapshot's working copies at the
            # just-published state, so the next scoped micro-cycle
            # stabilizes/steps against what is actually on the CR
            if snap is not None and key in snap.vas:
                snap.vas[key] = fresh
        self._publish_power(power)
        self._set_probe_targets(probe_targets)

    def _update_status(self, va: crd.VariantAutoscaling) -> None:
        from .kube import ConflictError

        def attempt() -> None:
            try:
                self.kube.update_variant_autoscaling_status(va)
            except ConflictError:
                # stale resourceVersion: refresh it and retry with our
                # intended status (conditions/allocs computed this cycle)
                fresh = self.kube.get_variant_autoscaling(va.name, va.namespace)
                va.metadata.resource_version = fresh.metadata.resource_version
                raise

        try:
            self._kube_call(attempt, what="update_status:VariantAutoscaling")
        except Exception as e:  # noqa: BLE001
            log.error("failed to update status", extra=kv(variant=va.name, error=str(e)))

    # -- demand-breakout probe (beyond reference) -------------------------
    # The loop samples Prometheus once per GLOBAL_OPT_INTERVAL; a ramp
    # step landing right after a cycle runs under-provisioned for up to a
    # full interval before the controller even sees it (the reference has
    # the same blindspot — its only mitigation is overprovisioning).
    # WVA_FAST_DEMAND_PROBE=<seconds> runs ONE cheap demand query per
    # variant between cycles and kicks an immediate full reconcile when
    # observed demand breaks out of the published capacity envelope.
    # Scale-down never triggers early (stabilization governs it).

    PROBE_ENV = "WVA_FAST_DEMAND_PROBE"
    PROBE_UTIL_ENV = "WVA_FAST_PROBE_UTIL"
    PROBE_WINDOW_ENV = "WVA_FAST_PROBE_WINDOW"

    def _probe_knob(self, key: str, default: float) -> float:
        raw = os.environ.get(key) or self._last_operator_cm.get(key)
        return parse_float_or(raw, default)

    def probe_window(self) -> str:
        """Rate window for the probe's demand query. Default 1m (safe at
        any Prometheus scrape interval); drop it to e.g. 15s where the
        scrape interval permits — a 1m window smooths a ramp step so
        much that detection can take most of the window."""
        return (os.environ.get(self.PROBE_WINDOW_ENV)
                or self._last_operator_cm.get(self.PROBE_WINDOW_ENV)
                or "1m").strip()

    def capacity_envelopes(self) -> dict[str, float]:
        """Published SLO-feasible capacity per variant in req/s (the
        published replica count x the sized operating point's
        max-arrival rate), keyed by full_name. The same envelope the
        demand-breakout probe compares live demand against — exposed for
        the goodput twin's meter, which judges provisioning against the
        controller's own published capacity model. Empty for variants
        (or cycles) that published nothing."""
        return {key: cap for key, (_q, cap) in self._probe_targets.items()}

    def demand_probe(self) -> bool:
        """One demand query per published variant; True (and an
        immediate-cycle kick) when any variant's observed arrival rate
        pushes its fleet past WVA_FAST_PROBE_UTIL (default 0.85) of the
        PUBLISHED capacity. The envelope is replicas x max SLO-feasible
        rate — the mean SLOs still hold right up to 1.0, but tail
        latency degrades sharply approaching it, so the danger zone
        starts below. Scale-down never triggers early (stabilization
        governs it). Best-effort: query failures skip the variant — the
        cadence cycle remains the backbone."""
        util = self._probe_knob(self.PROBE_UTIL_ENV, 0.85)
        prom = self._probe_client()
        for key, (query, cap_rps) in list(self._probe_targets.items()):
            try:
                samples = prom.query(query)
            except Exception:  # noqa: BLE001 — probe is best-effort
                continue
            rate = sum(s.value for s in samples
                       if not math.isnan(s.value) and not math.isinf(s.value))
            if rate > cap_rps * util:
                log.info(
                    "demand breakout: reconciling early",
                    extra=kv(variant=key, observed_rps=round(rate, 2),
                             capacity_rps=round(cap_rps, 2),
                             util_threshold=util))
                name, _, ns = key.partition(":")
                self.emitter.emit_probe_kick(name, ns)
                self.kick()
                return True
        return False

    def _probe_client(self):
        """The probe daemon's Prometheus client. HTTPPromAPI's shared
        requests.Session is not documented thread-safe, so the probe
        thread — which queries concurrently with the reconcile loop —
        gets its own clone (own Session / connection pool). Clients
        without clone() (in-memory fakes, sim-time shims) are assumed
        re-entrant and shared as-is."""
        with self._probe_prom_lock:
            if self._probe_prom is None:
                clone = getattr(self.prom, "clone", None)
                self._probe_prom = clone() if callable(clone) else self.prom
            return self._probe_prom

    def _start_demand_probe(self, stop: threading.Event) -> None:
        """Poll demand on a daemon thread at the configured period; a
        disabled knob is re-checked lazily so a ConfigMap edit can turn
        the probe on/off without a restart."""

        def loop() -> None:
            while not stop.is_set():
                interval = self._probe_knob(self.PROBE_ENV, 0.0)
                if interval <= 0:
                    stop.wait(5.0)
                    continue
                stop.wait(interval)
                if not stop.is_set():
                    try:
                        self.demand_probe()
                    except Exception as e:  # noqa: BLE001
                        log.warning("demand probe failed",
                                    extra=kv(error=str(e)))

        threading.Thread(target=loop, name="wva-demand-probe",
                         daemon=True).start()

    # -- loop -------------------------------------------------------------

    def kick(self) -> None:
        """Request an immediate reconcile cycle. Thread-safe; multiple
        kicks before the next cycle coalesce into one (workqueue
        semantics; with the streaming core attached, N kicks inside one
        WVA_STREAM_DEBOUNCE_MS window coalesce into exactly ONE pass).
        Watch events land here; shutdown paths may also call it after
        setting `stop` to wake the loop promptly."""
        self._wake.set()
        core = self.stream_core
        if core is not None:
            core.note_kick()

    def on_watch_event(self, ev) -> None:
        """Watch-event filter -> kick. Mirrors the reference's event
        wiring (variantautoscaling_controller.go:456-487): VariantAutoscaling
        Create events reconcile immediately (updates/deletes are dropped —
        the level-triggered cycle picks them up on cadence), and any
        change to the operator ConfigMap triggers a cycle so interval/
        knob edits take effect at once instead of one interval later."""
        if ev.kind == "VariantAutoscaling" and ev.type == "ADDED":
            log.info("watch: new VariantAutoscaling, reconciling now",
                     extra=kv(variant=ev.name, namespace=ev.namespace))
            self.kick()
        elif (ev.kind == "ConfigMap" and ev.name == CONFIG_MAP_NAME
              and ev.namespace == self.config_namespace
              and ev.type in ("ADDED", "MODIFIED")):
            log.info("watch: operator ConfigMap changed, reconciling now")
            self.kick()

    def start_watches(self, stop: threading.Event) -> bool:
        """Hook watch events to kick(), whatever the kube client offers:
        InMemoryKube exposes synchronous listeners; RestKube exposes
        blocking ?watch=true loops, run here on daemon threads. Returns
        True when a watch source was attached."""
        kube = self.kube
        if hasattr(kube, "add_watch_listener"):
            kube.add_watch_listener(self.on_watch_event)
            return True
        if hasattr(kube, "watch_variant_autoscalings"):
            threading.Thread(
                target=kube.watch_variant_autoscalings,
                args=(self.on_watch_event, stop),
                name="wva-watch-va", daemon=True,
            ).start()
            threading.Thread(
                target=kube.watch_configmap,
                args=(CONFIG_MAP_NAME, self.config_namespace,
                      self.on_watch_event, stop),
                name="wva-watch-cm", daemon=True,
            ).start()
            return True
        return False

    def run_forever(self, stop: Optional[threading.Event] = None,
                    watch: bool = True) -> None:
        """RequeueAfter-driven cadence, woken early by watch events.

        With WVA_STREAM on (the default) this hands the loop to the
        streaming core (stream/core.py): the cadence becomes the
        backstop full pass, watch kicks become debounced full passes,
        and pushed/streamed load changes drive scoped micro-cycles in
        between — the polled loop is one consumer of the same engine.
        WVA_STREAM=off runs the legacy polled loop below, byte-for-byte.

        The reference paces itself by requeue but registers watches so a
        VariantAutoscaling Create or an operator-ConfigMap change
        reconciles immediately (controller.go:456-487); same here: the
        cadence wait is interruptible by kick(). A kick arriving during
        a cycle is not lost — the wait returns at once and the next
        cycle runs (at-least-once after the last event)."""
        stop = stop or threading.Event()
        if self._stream_enabled():
            core = self.ensure_stream_core()
            if watch:
                self.start_watches(stop)
            self._start_demand_probe(stop)
            core.run(stop)
            return
        if watch:
            self.start_watches(stop)
        self._start_demand_probe(stop)
        while not stop.is_set():
            self._wake.clear()
            try:
                result = self.reconcile()
                delay = result.requeue_after
            except Exception as e:  # noqa: BLE001
                log.error("reconcile cycle failed", extra=kv(error=str(e)))
                delay = DEFAULT_INTERVAL_SECONDS
            deadline = time.monotonic() + delay
            while not stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if self._wake.wait(min(remaining, 0.2)):
                    # brief coalesce window: a kubectl apply of several
                    # related objects should trigger one cycle, not N
                    stop.wait(0.1)
                    break
