"""Emitted Prometheus series — the output API HPA/KEDA consumes.

Equivalent of the Go reference's internal/metrics/metrics.go. Series names are
kept identical to the reference (`inferno_*`) so existing HPA external
metric rules and KEDA ScaledObjects work unchanged against this controller.
The `/metrics` HTTP server (TLS, cert reload, the kube auth gate) comes
with the port's process entry point; this module is the registry and the
emitter the reconcile cycle writes to.
"""

from __future__ import annotations

import threading
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
)

INFERNO_REPLICA_SCALING_TOTAL = "inferno_replica_scaling_total"
INFERNO_DESIRED_REPLICAS = "inferno_desired_replicas"
INFERNO_CURRENT_REPLICAS = "inferno_current_replicas"
INFERNO_DESIRED_RATIO = "inferno_desired_ratio"
INFERNO_SOLUTION_TIME_MSEC = "inferno_solution_time_msec"
INFERNO_RECONCILE_DURATION_MSEC = "inferno_reconcile_duration_msec"
INFERNO_RECONCILE_STAGE_DURATION_MSEC = "inferno_reconcile_stage_duration_msec"
INFERNO_VARIANT_POWER_WATTS = "inferno_variant_power_watts"
INFERNO_FLEET_POWER_WATTS = "inferno_fleet_power_watts"
INFERNO_MODEL_DRIFT_RATIO = "inferno_model_drift_ratio"
INFERNO_TPU_DUTY_CYCLE = "inferno_tpu_duty_cycle_percent"
INFERNO_TPU_HBM_USAGE = "inferno_tpu_hbm_usage_bytes"
INFERNO_CONDITION_STATUS = "inferno_condition_status"
INFERNO_DEMAND_PROBE_KICKS_TOTAL = "inferno_demand_probe_kicks_total"
INFERNO_DEGRADATION_STATE = "inferno_degradation_state"
INFERNO_CYCLE_DEGRADATION_STATE = "inferno_cycle_degradation_state"
INFERNO_CIRCUIT_STATE = "inferno_circuit_state"
# duration HISTOGRAMS (the gauges above describe the LAST cycle; these
# accumulate the distribution, so tail behavior — the p99 stage stall, the
# slow 1% of apiserver calls — survives scrape intervals)
INFERNO_RECONCILE_STAGE_SECONDS = "inferno_reconcile_stage_seconds"
INFERNO_DEPENDENCY_LATENCY_SECONDS = "inferno_dependency_latency_seconds"
INFERNO_SOLVE_SECONDS = "inferno_solve_seconds"
INFERNO_DEPENDENCY_RETRIES_TOTAL = "inferno_dependency_retries_total"
# fleet-scale collection (collector.FleetLoadCollector): how many
# Prometheus queries each cycle's load collection issued per path, and
# the collection phase's wall time — the series that PROVES collection
# is O(metric-families), not O(variants) (a fleet/legacy ratio near V is
# the escape hatch engaged; a repair rate near V is grouped demux rot)
INFERNO_COLLECTION_QUERIES_TOTAL = "inferno_collection_queries_total"
INFERNO_COLLECTION_SECONDS = "inferno_collection_seconds"
# incremental solve (solver/incremental.py): how each variant's sizing
# was produced this cycle (full / incremental / cached) and how many
# kernel lanes the analyze step actually solved vs skipped — the series
# that PROVE steady-state analyze+optimize is O(changed-variants)
INFERNO_SOLVE_MODE_TOTAL = "inferno_solve_mode_total"
INFERNO_SOLVE_LANES = "inferno_solve_lanes"
# hierarchical two-level solve (solver/hierarchy.py): the super-shard
# partition size and the warm cold-start checkpoint lifecycle — restarts
# that skipped the forced full pass are visible here, as is every
# discarded (torn/stale/reconfigured) arena checkpoint
INFERNO_HIER_SHARDS = "inferno_hier_shards"
INFERNO_ARENA_CHECKPOINT_TOTAL = "inferno_arena_checkpoint_total"
# limited-mode inventory visibility: schedulable chips per TPU generation
# as the collector saw them this cycle — a maintenance drain or a spot
# reclamation wave reads as this series SHRINKING, never as a kube error
# storm (docs/robustness.md, node-pool fault kinds)
INFERNO_POOL_CAPACITY_CHIPS = "inferno_pool_capacity_chips"
# device audit (obs/profile.py DEVICE_AUDIT, drained once per cycle):
# retraces per entry point (none in the port: PyTorch runs eagerly), the
# seconds each kernel-library build paid, and host<->device transfers
# per direction. A steady-state fleet shows the first two FLAT.
INFERNO_JIT_RETRACES_TOTAL = "inferno_jit_retraces_total"
INFERNO_JIT_COMPILE_SECONDS = "inferno_jit_compile_seconds"
INFERNO_HOST_DEVICE_TRANSFERS_TOTAL = "inferno_host_device_transfers_total"
# streaming reconcile core (stream/): how metric deltas reach the
# engine (pushed remote-write, the streamed-scrape fallback, watch
# kicks, cadence backstop passes) and the wall time from a load change
# being OBSERVED to the re-sized allocation being PUBLISHED — the
# reaction-latency distribution the event-driven core exists to shrink
INFERNO_STREAM_EVENTS_TOTAL = "inferno_stream_events_total"
INFERNO_STREAM_LAG_SECONDS = "inferno_stream_lag_seconds"
# streaming overload/quarantine accounting (docs/robustness.md,
# "Streaming fault matrix"): every event the ingest door refuses is
# COUNTED with a reason, never silently dropped — the shed counter plus
# a converging backstop pass is the overload contract; the checkpoint
# counter makes warm-restart outcomes (restored vs discarded) alertable;
# the debounce gauge shows the adaptive window widening under a storm
INFERNO_STREAM_SHED_TOTAL = "inferno_stream_shed_total"
INFERNO_STREAM_CHECKPOINT_TOTAL = "inferno_stream_checkpoint_total"
INFERNO_STREAM_DEBOUNCE_MS = "inferno_stream_debounce_ms"
# limited-mode drain outcomes (stream/core.py): pool-scoped component
# re-solves vs escalated full passes vs valve-coalesced deferrals —
# the scoped/full ratio is the degraded-mode reaction-cost headline
INFERNO_STREAM_LIMITED_TOTAL = "inferno_stream_limited_total"
# live goodput metering (obs/goodput.py, fed by the Reconciler when a
# GoodputMeter is attached — WVA_GOODPUT_LIVE): the twin's offline
# judgment metric as a first-class scrape surface. The badput counter's
# `bucket` label partitions the WHOLE provisioned cost (the `useful`
# bucket is exported too), so sum-over-buckets is total spend and any
# bucket/sum ratio is a badput fraction.
INFERNO_GOODPUT_FRACTION = "inferno_goodput_fraction"
INFERNO_BADPUT_COST_SECONDS_TOTAL = "inferno_badput_cost_seconds_total"
INFERNO_SLO_ATTAINMENT_RATIO = "inferno_slo_attainment_ratio"

LABEL_DEPENDENCY = "dependency"
LABEL_OUTCOME = "outcome"
LABEL_GENERATION = "generation"
LABEL_MODE = "mode"
LABEL_STATE = "state"
LABEL_FN = "fn"
STATE_SOLVED = "solved"
STATE_SKIPPED = "skipped"

LABEL_SOURCE = "source"
# the single source of truth for stream ingest-event sources (the
# `source` label values of inferno_stream_events_total)
SOURCE_REMOTE_WRITE = "remote-write"
SOURCE_SCRAPE = "scrape"
SOURCE_WATCH = "watch"
SOURCE_BACKSTOP = "backstop"
STREAM_SOURCES = (SOURCE_REMOTE_WRITE, SOURCE_SCRAPE, SOURCE_WATCH,
                  SOURCE_BACKSTOP)

LABEL_REASON = "reason"
# the single source of truth for stream shed reasons (the `reason`
# label values of inferno_stream_shed_total): overload shedding first,
# quarantine verdicts second, codec/poller failures last
SHED_BODY_TOO_LARGE = "body-too-large"
SHED_STORE_FULL = "store-full"
SHED_QUEUE_FULL = "queue-full"
SHED_DECODE_ERROR = "decode-error"
SHED_QUARANTINE_NAN = "quarantine-nan"
SHED_QUARANTINE_NEGATIVE = "quarantine-negative"
SHED_QUARANTINE_TIMESTAMP = "quarantine-timestamp"
SHED_QUARANTINE_LABELS = "quarantine-labels"
SHED_SOURCE_QUARANTINED = "source-quarantined"
SHED_SCRAPE_ERROR = "scrape-error"
# raw-counter pushdown (stream/pushdown.py): a Prometheus staleness
# marker retired a ledger entry — accounted, but NOT poison (the next
# genuine sample restarts the epoch)
SHED_STALE_MARKER = "stale-marker"
STREAM_SHED_REASONS = (
    SHED_BODY_TOO_LARGE, SHED_STORE_FULL, SHED_QUEUE_FULL,
    SHED_DECODE_ERROR, SHED_QUARANTINE_NAN, SHED_QUARANTINE_NEGATIVE,
    SHED_QUARANTINE_TIMESTAMP, SHED_QUARANTINE_LABELS,
    SHED_SOURCE_QUARANTINED, SHED_SCRAPE_ERROR, SHED_STALE_MARKER,
)

LABEL_LANE = "lane"
# limited-mode drain lanes (the `lane` label values of
# inferno_stream_limited_total): scoped = re-solved only the
# pool-connected components containing flipped variants; full = the
# event escalated to a full-fleet pass; coalesced = the drain was
# deferred onto one pending backstop pass (the escalation valve)
LANE_SCOPED = "scoped"
LANE_FULL = "full"
LANE_COALESCED = "coalesced"
STREAM_LIMITED_LANES = (LANE_SCOPED, LANE_FULL, LANE_COALESCED)

LABEL_EVENT = "event"
# checkpoint lifecycle events (the `event` label values of
# inferno_stream_checkpoint_total): a restore either succeeds or the
# file is explicitly discarded with the reason class
CHECKPOINT_SAVE = "save"
CHECKPOINT_RESTORE = "restore"
CHECKPOINT_DISCARD_CORRUPT = "discard-corrupt"
CHECKPOINT_DISCARD_STALE = "discard-stale"
STREAM_CHECKPOINT_EVENTS = (
    CHECKPOINT_SAVE, CHECKPOINT_RESTORE,
    CHECKPOINT_DISCARD_CORRUPT, CHECKPOINT_DISCARD_STALE,
)

LABEL_CONDITION_TYPE = "type"

LABEL_METRIC = "metric"

LABEL_STAGE = "stage"
# the single source of truth for reconcile stage names: the reconciler's
# stage marks, the per-stage gauge/histogram label values, and the docs
# all draw from these constants — a literal drifting out of sync here
# silently zeroes a stage's series
STAGE_CONFIG = "config"
STAGE_PREPARE = "prepare"
STAGE_ANALYZE = "analyze"
STAGE_OPTIMIZE = "optimize"
STAGE_PUBLISH = "publish"
RECONCILE_STAGES = (STAGE_CONFIG, STAGE_PREPARE, STAGE_ANALYZE,
                    STAGE_OPTIMIZE, STAGE_PUBLISH)

# histogram buckets, in seconds: stages and dependency calls span
# sub-millisecond (in-memory fakes, warm caches) to tens of seconds
# (backoff ladders under an outage); the solve is sub-millisecond to
# low seconds (a cold kernel build)
_STAGE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
_DEPENDENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
_SOLVE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 1.0, 5.0)

LABEL_VARIANT_NAME = "variant_name"
LABEL_NAMESPACE = "namespace"
LABEL_DIRECTION = "direction"
LABEL_REASON = "reason"
LABEL_ACCELERATOR_TYPE = "accelerator_type"
LABEL_MODEL_NAME = "model_name"
# the `bucket` label values of inferno_badput_cost_seconds_total are
# the GOODPUT_* constants of obs/decision.py (useful /
# under-provisioned / over-provisioned / degradation-held /
# actuation-lagged)
LABEL_BUCKET = "bucket"


class MetricsEmitter:
    """Registers and sets the four scaling-signal series
    (reference metrics.go:20-126). Instance-scoped registry so tests and
    multiple controllers don't collide."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        self._lock = threading.Lock()
        self.replica_scaling_total = Counter(
            INFERNO_REPLICA_SCALING_TOTAL.removesuffix("_total"),
            "Total number of replica scaling operations",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_DIRECTION, LABEL_REASON],
            registry=self.registry,
        )
        self.demand_probe_kicks_total = Counter(
            INFERNO_DEMAND_PROBE_KICKS_TOTAL.removesuffix("_total"),
            "Early reconciles triggered by the demand-breakout probe "
            "(WVA_FAST_DEMAND_PROBE)",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE],
            registry=self.registry,
        )
        self.desired_replicas = Gauge(
            INFERNO_DESIRED_REPLICAS,
            "Desired number of replicas for each variant",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_ACCELERATOR_TYPE],
            registry=self.registry,
        )
        self.current_replicas = Gauge(
            INFERNO_CURRENT_REPLICAS,
            "Current number of replicas for each variant",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_ACCELERATOR_TYPE],
            registry=self.registry,
        )
        self.desired_ratio = Gauge(
            INFERNO_DESIRED_RATIO,
            "Ratio of desired to current replicas for each variant",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_ACCELERATOR_TYPE],
            registry=self.registry,
        )
        # solver wall time (the reference measures SolutionTimeMsec but
        # never exports it, pkg/solver/optimizer.go:30-38 — here it's a
        # first-class observability signal)
        self.solution_time = Gauge(
            INFERNO_SOLUTION_TIME_MSEC,
            "Wall-clock time of the last optimization solve",
            registry=self.registry,
        )
        # per-stage cycle timing (beyond-reference: the reference times the
        # solver internally and exports nothing; here every stage of
        # collect->analyze->optimize->publish is a scrapeable series, so a
        # slow Prometheus or apiserver is visible as the stage that stalls)
        self.reconcile_duration = Gauge(
            INFERNO_RECONCILE_DURATION_MSEC,
            "Wall-clock time of the last full reconcile cycle",
            registry=self.registry,
        )
        self.reconcile_stage_duration = Gauge(
            INFERNO_RECONCILE_STAGE_DURATION_MSEC,
            "Wall-clock time of each stage of the last reconcile cycle",
            [LABEL_STAGE],
            registry=self.registry,
        )
        # modeled power draw (beyond-reference: the reference's Power(util)
        # curve is computed but consumed nowhere, accelerator.go:35-41)
        self.variant_power = Gauge(
            INFERNO_VARIANT_POWER_WATTS,
            "Modeled power draw of the variant's desired allocation",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_ACCELERATOR_TYPE],
            registry=self.registry,
        )
        self.fleet_power = Gauge(
            INFERNO_FLEET_POWER_WATTS,
            "Modeled power draw of the whole optimized fleet",
            registry=self.registry,
        )
        # TPU runtime observability re-exported next to the scaling
        # signals (the north star's "libtpu metrics" scrape: duty cycle /
        # HBM from tpu-monitoring-library, when the cluster exports them)
        self.tpu_duty_cycle = Gauge(
            INFERNO_TPU_DUTY_CYCLE,
            "Average TPU tensorcore duty cycle over the serving namespace",
            [LABEL_NAMESPACE], registry=self.registry,
        )
        self.tpu_hbm_usage = Gauge(
            INFERNO_TPU_HBM_USAGE,
            "Total TPU HBM usage over the serving namespace",
            [LABEL_NAMESPACE], registry=self.registry,
        )
        # CR conditions as series (kube-state-metrics shape, without
        # needing kube-state-metrics): alerts can key on
        # MetricsAvailable/OptimizationReady/PerfModelAccurate directly
        self.condition_status = Gauge(
            INFERNO_CONDITION_STATUS,
            "VariantAutoscaling condition status (1=True, 0=False, "
            "-1=Unknown)",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_CONDITION_TYPE],
            registry=self.registry,
        )
        # degradation ladder (docs/robustness.md): the rung each variant
        # — and the whole cycle — landed on, so "fleet is degraded" is an
        # alertable series, not a log-grep (0=healthy 1=stream-degraded
        # 2=stale-cache 3=limited 4=hold)
        self.degradation_state = Gauge(
            INFERNO_DEGRADATION_STATE,
            "Degradation-ladder rung the variant's last cycle landed on "
            "(0=healthy, 1=stream-degraded, 2=stale-cache, 3=limited, "
            "4=hold)",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE],
            registry=self.registry,
        )
        self.cycle_degradation_state = Gauge(
            INFERNO_CYCLE_DEGRADATION_STATE,
            "Worst degradation-ladder rung of the last reconcile cycle",
            registry=self.registry,
        )
        # per-dependency circuit breakers (utils/backoff.py): 0=closed,
        # 1=half-open, 2=open
        self.circuit_state = Gauge(
            INFERNO_CIRCUIT_STATE,
            "Circuit-breaker state per dependency (0=closed, 1=half-open, "
            "2=open)",
            [LABEL_DEPENDENCY],
            registry=self.registry,
        )
        # duration histograms + the retry counter (the flight recorder's
        # aggregate face, docs/observability.md): the stage/solve gauges
        # above answer "what did the LAST cycle do", these answer "what
        # does the distribution look like" — tails, not last values
        self.stage_seconds = Histogram(
            INFERNO_RECONCILE_STAGE_SECONDS,
            "Distribution of reconcile stage wall time",
            [LABEL_STAGE], buckets=_STAGE_BUCKETS, registry=self.registry,
        )
        self.dependency_latency = Histogram(
            INFERNO_DEPENDENCY_LATENCY_SECONDS,
            "Distribution of dependency call wall time (kube verbs, "
            "Prometheus queries), retries and backoff sleeps included",
            [LABEL_DEPENDENCY], buckets=_DEPENDENCY_BUCKETS,
            registry=self.registry,
        )
        self.solve_seconds = Histogram(
            INFERNO_SOLVE_SECONDS,
            "Distribution of optimization solve wall time",
            buckets=_SOLVE_BUCKETS, registry=self.registry,
        )
        self.dependency_retries = Counter(
            INFERNO_DEPENDENCY_RETRIES_TOTAL.removesuffix("_total"),
            "Retry-ladder outcomes per dependency (retry: another attempt "
            "scheduled; exhausted: ladder spent; deadline: cycle budget "
            "spent; circuit-open: failed fast without calling)",
            [LABEL_DEPENDENCY, LABEL_OUTCOME], registry=self.registry,
        )
        # fleet-scale collection telemetry: queries per collection path
        # (fleet / per-variant-repair / legacy) and the phase's wall time
        self.collection_queries = Counter(
            INFERNO_COLLECTION_QUERIES_TOTAL.removesuffix("_total"),
            "Prometheus queries issued by per-cycle load collection, by "
            "path (fleet: grouped O(families) queries; "
            "per-variant-repair: variants missing from the grouped "
            "result; legacy: WVA_FLEET_COLLECTION=off)",
            [LABEL_MODE], registry=self.registry,
        )
        self.collection_seconds = Histogram(
            INFERNO_COLLECTION_SECONDS,
            "Distribution of the load-collection phase wall time "
            "(grouped prefetch + per-variant demux/repair)",
            buckets=_STAGE_BUCKETS, registry=self.registry,
        )
        # incremental solve telemetry (solver/incremental.py): variants
        # per solve path, and the last cycle's kernel-lane ledger
        self.solve_mode_total = Counter(
            INFERNO_SOLVE_MODE_TOTAL.removesuffix("_total"),
            "Variants sized per solve path each cycle (full: every lane "
            "re-solved; incremental: changed signature, lanes re-solved; "
            "cached: unchanged signature, cached allocations reused)",
            [LABEL_MODE], registry=self.registry,
        )
        self.solve_lanes = Gauge(
            INFERNO_SOLVE_LANES,
            "Candidate kernel lanes of the last analyze step "
            "(solved: dispatched to the sizing kernel or the zero-load "
            "fast path; skipped: reused from the signature cache)",
            [LABEL_STATE], registry=self.registry,
        )
        self.hier_shards = Gauge(
            INFERNO_HIER_SHARDS,
            "Super-shards in the hierarchical solve's current partition "
            "(0 while the flat engine or the small-fleet delegate path "
            "is in effect) — forced-full work per cycle is bounded by "
            "the largest single shard, not the fleet",
            registry=self.registry,
        )
        self.arena_checkpoint = Counter(
            INFERNO_ARENA_CHECKPOINT_TOTAL.removesuffix("_total"),
            "Warm cold-start arena checkpoint lifecycle events (save: "
            "solve state persisted; restore: a restarted controller "
            "skipped the forced full pass; discard-corrupt/discard-"
            "stale/discard-config: the file was rejected and the engine "
            "cold-started; save-error: a failed write, never fatal)",
            [LABEL_EVENT], registry=self.registry,
        )
        # limited-mode chip inventory, per generation: a draining node
        # pool or a spot-reclamation wave is visible as this gauge
        # shrinking cycle over cycle
        self.pool_capacity = Gauge(
            INFERNO_POOL_CAPACITY_CHIPS,
            "Schedulable google.com/tpu chips per generation as collected "
            "this cycle (limited mode only; empty when capacity-unaware)",
            [LABEL_GENERATION], registry=self.registry,
        )
        # device audit (obs/profile.py): retraces per entry point (none
        # in the port), kernel-library builds + host<->device transfers,
        # drained per cycle. The names are the reference package's.
        self.jit_retraces = Counter(
            INFERNO_JIT_RETRACES_TOTAL.removesuffix("_total"),
            "Retraces (recompilations) per entry point; the PyTorch "
            "port runs eagerly and never adds to this",
            [LABEL_FN], registry=self.registry,
        )
        self.jit_compile_seconds = Histogram(
            INFERNO_JIT_COMPILE_SECONDS,
            "Wall time paid per kernel-library build and load (the "
            "first use of the CUDA library in the process)",
            [LABEL_FN], buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                                 10.0, 30.0, 60.0),
            registry=self.registry,
        )
        self.host_device_transfers = Counter(
            INFERNO_HOST_DEVICE_TRANSFERS_TOTAL.removesuffix("_total"),
            "Host<->device array transfers at the pack/readback choke "
            "points (h2d: arrays staged onto device per kernel "
            "dispatch; d2h: result arrays pulled back)",
            [LABEL_DIRECTION], registry=self.registry,
        )
        # streaming reconcile core (stream/core.py): ingest events per
        # source, and the observed->published reaction-latency
        # distribution. Buckets reach down to 10 ms (the event-driven
        # target is tens of ms) and up to the polled interval (the
        # backstop's worst case).
        self.stream_events = Counter(
            INFERNO_STREAM_EVENTS_TOTAL.removesuffix("_total"),
            "Metric deltas and wake events ingested by the streaming "
            "reconcile core (remote-write: pushed WriteRequest groups; "
            "scrape: streamed-scrape poller sweeps; watch: kube "
            "watch/probe kicks; backstop: cadence full passes)",
            [LABEL_SOURCE], registry=self.registry,
        )
        self.stream_lag = Histogram(
            INFERNO_STREAM_LAG_SECONDS,
            "Wall time from a load change being observed by the "
            "streaming core to the re-sized allocation being published",
            buckets=(0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
            registry=self.registry,
        )
        # overload/quarantine shedding + warm-restart checkpoint
        # lifecycle + the adaptive debounce window: the three series that
        # make "streaming under fire" observable (docs/robustness.md)
        self.stream_shed = Counter(
            INFERNO_STREAM_SHED_TOTAL.removesuffix("_total"),
            "Events the streaming ingest door refused, by reason "
            "(overload caps, quarantine verdicts, decode failures, "
            "scrape-poller errors) — shed work is metered here and "
            "re-covered by a backstop/scrape pass, never silently lost",
            [LABEL_REASON], registry=self.registry,
        )
        self.stream_checkpoint = Counter(
            INFERNO_STREAM_CHECKPOINT_TOTAL.removesuffix("_total"),
            "Warm-restart checkpoint lifecycle events (save: state "
            "persisted after a cycle; restore: a restart resumed scoped "
            "operation; discard-corrupt/discard-stale: the file was "
            "rejected and the controller cold-started)",
            [LABEL_EVENT], registry=self.registry,
        )
        self.stream_debounce_ms = Gauge(
            INFERNO_STREAM_DEBOUNCE_MS,
            "Effective debounce window of the streaming core in "
            "milliseconds — widens adaptively under sustained event "
            "storms, narrows back with hysteresis when the storm ebbs",
            registry=self.registry,
        )
        self.stream_limited = Counter(
            INFERNO_STREAM_LIMITED_TOTAL.removesuffix("_total"),
            "Limited-mode drain outcomes in the streaming core (scoped: "
            "only the pool-connected components containing flipped "
            "variants were re-solved; full: the drain escalated to a "
            "full-fleet pass; coalesced: the drain was deferred onto one "
            "pending backstop pass by the escalation valve)",
            [LABEL_LANE], registry=self.registry,
        )
        # perf-model drift (beyond-reference: the reference never compares
        # its scraped latencies against its own queueing model)
        self.model_drift = Gauge(
            INFERNO_MODEL_DRIFT_RATIO,
            "Observed/predicted latency at the current allocation (1.0 = "
            "the fitted profile matches reality)",
            [LABEL_VARIANT_NAME, LABEL_NAMESPACE, LABEL_METRIC],
            registry=self.registry,
        )
        # live goodput (obs/goodput.py GoodputMeter): the twin's
        # fleet-efficiency judgment metric, computed by the RUNNING
        # controller each cycle. Registered unconditionally (scrape
        # parity); the series stay at their zero values until a meter is
        # attached (WVA_GOODPUT_LIVE / Reconciler.attach_goodput_meter).
        self.goodput_fraction = Gauge(
            INFERNO_GOODPUT_FRACTION,
            "Useful share of the fleet's provisioned chip-cost over the "
            "rolling goodput window (WVA_GOODPUT_WINDOW_S), in [0, 1]",
            registry=self.registry,
        )
        self.badput_cost_seconds = Counter(
            INFERNO_BADPUT_COST_SECONDS_TOTAL.removesuffix("_total"),
            "Provisioned cost (dollar-seconds) accumulated per goodput "
            "bucket — useful plus the four badput buckets "
            "(under-provisioned / over-provisioned / degradation-held / "
            "actuation-lagged), partitioning total spend exactly",
            [LABEL_BUCKET], registry=self.registry,
        )
        self.slo_attainment_ratio = Gauge(
            INFERNO_SLO_ATTAINMENT_RATIO,
            "SLO-attained share of the demand-seconds each model served "
            "since the meter attached, in [0, 1]",
            [LABEL_MODEL_NAME, LABEL_NAMESPACE], registry=self.registry,
        )

    def emit_solution_time(self, msec: float) -> None:
        self.solution_time.set(msec)
        self.solve_seconds.observe(msec / 1000.0)

    def emit_dependency_latency(self, dependency: str,
                                seconds: float) -> None:
        """One dependency call's wall time (retries + backoff sleeps
        included: the histogram answers 'how long did the reconcile wait
        on this dependency', not 'how fast is its transport')."""
        self.dependency_latency.labels(
            **{LABEL_DEPENDENCY: dependency}).observe(seconds)

    def emit_retry(self, dependency: str, outcome: str) -> None:
        self.dependency_retries.labels(
            **{LABEL_DEPENDENCY: dependency,
               LABEL_OUTCOME: outcome}).inc()

    def emit_collection_metrics(self, queries_by_mode: dict[str, int],
                                seconds: float) -> None:
        """One cycle's collection telemetry: per-path query counts (zero
        counts skipped — a mode's series appears once that path has ever
        run) and the phase wall time."""
        for mode, count in queries_by_mode.items():
            if count > 0:
                self.collection_queries.labels(
                    **{LABEL_MODE: mode}).inc(count)
        self.collection_seconds.observe(seconds)

    def emit_solve_metrics(self, modes: dict[str, int],
                           lanes_solved: int, lanes_skipped: int) -> None:
        """One cycle's incremental-solve telemetry: per-mode variant
        counts (zero counts skipped — a mode's series appears once that
        path has ever run) and the lane ledger gauges."""
        with self._lock:
            for mode, count in modes.items():
                if count > 0:
                    self.solve_mode_total.labels(
                        **{LABEL_MODE: mode}).inc(count)
            self.solve_lanes.labels(
                **{LABEL_STATE: STATE_SOLVED}).set(lanes_solved)
            self.solve_lanes.labels(
                **{LABEL_STATE: STATE_SKIPPED}).set(lanes_skipped)

    def emit_hier_solve(self, shards: int, ckpt_events: dict) -> None:
        """One cycle's hierarchical-solve telemetry: the partition size
        gauge and any arena-checkpoint lifecycle events drained from the
        engine (event keys normalized to dashed label values)."""
        with self._lock:
            self.hier_shards.set(shards)
            for event, count in ckpt_events.items():
                if count > 0:
                    self.arena_checkpoint.labels(**{
                        LABEL_EVENT: event.replace("_", "-")}).inc(count)

    def emit_device_audit(self, delta: dict) -> None:
        """One cycle's device-audit delta (obs.DeviceAudit.delta shape):
        per-fn retrace counts, the compile events, and per-direction
        host<->device transfer counts."""
        with self._lock:
            for fn, count in (delta.get("retraces") or {}).items():
                if count > 0:
                    self.jit_retraces.labels(**{LABEL_FN: fn}).inc(count)
            for fn, seconds in (delta.get("compiles") or []):
                self.jit_compile_seconds.labels(
                    **{LABEL_FN: fn}).observe(seconds)
            for direction, count in (delta.get("transfers") or {}).items():
                if count > 0:
                    self.host_device_transfers.labels(
                        **{LABEL_DIRECTION: direction}).inc(count)

    def emit_goodput_metrics(self, fraction: float,
                             bucket_costs: dict,
                             attainment: dict) -> None:
        """One cycle's goodput ledger roll-up (obs/goodput.py). The
        fraction gauge carries the rolling-window share; the badput
        counter accrues exactly the just-flushed interval's $·s per
        bucket (zero-cost buckets emit nothing — scrapes see only
        buckets that ever billed); attainment keys are
        (model_name, namespace)."""
        with self._lock:
            self.goodput_fraction.set(fraction)
            for bucket, cost in bucket_costs.items():
                if cost > 0.0:
                    self.badput_cost_seconds.labels(
                        **{LABEL_BUCKET: bucket}).inc(cost)
            for (model_name, namespace), ratio in attainment.items():
                self.slo_attainment_ratio.labels(**{
                    LABEL_MODEL_NAME: model_name,
                    LABEL_NAMESPACE: namespace,
                }).set(ratio)

    # -- incremental (scoped-cycle) updates of the wholesale gauges -----
    # The streaming core's scoped micro-cycles touch a handful of
    # variants; a wholesale clear()+rebuild of a 512-variant gauge costs
    # more than the solve itself (prometheus child churn). These update
    # exactly the changed samples and remove exactly the retired label
    # sets — the merged VIEW equals what a wholesale emit of the merged
    # dict would produce (pinned by tests/test_stream.py).

    @staticmethod
    def _remove_samples(gauge, removed) -> None:
        for labels in removed:
            try:
                gauge.remove(*labels)
            except KeyError:
                pass  # never exported (e.g. a variant added and retired
                #       between scrapes)

    def update_power_metrics(self, fresh: dict, removed: list,
                             fleet_total: float) -> None:
        """Scoped-cycle power update: `fresh` keys are
        (variant_name, namespace, accelerator_type); `removed` are label
        tuples retired by the merge; `fleet_total` is the merged sum."""
        with self._lock:
            self._remove_samples(self.variant_power, removed)
            for (variant_name, namespace, acc_type), watts in fresh.items():
                self.variant_power.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_ACCELERATOR_TYPE: acc_type,
                }).set(watts)
            self.fleet_power.set(fleet_total)

    def update_condition_metrics(self, fresh: dict, removed: list) -> None:
        encoded = {"True": 1.0, "False": 0.0}
        with self._lock:
            self._remove_samples(self.condition_status, removed)
            for (variant_name, namespace, cond_type), status in \
                    fresh.items():
                self.condition_status.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_CONDITION_TYPE: cond_type,
                }).set(encoded.get(status, -1.0))

    def update_drift_metrics(self, fresh: dict, removed: list) -> None:
        with self._lock:
            self._remove_samples(self.model_drift, removed)
            for (variant_name, namespace, metric), ratio in fresh.items():
                self.model_drift.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_METRIC: metric,
                }).set(ratio)

    def update_degradation_metrics(self, fresh: dict, removed: list,
                                   cycle_state: int) -> None:
        with self._lock:
            self._remove_samples(self.degradation_state, removed)
            for (variant_name, namespace), state in fresh.items():
                self.degradation_state.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                }).set(state)
            self.cycle_degradation_state.set(cycle_state)

    def emit_stream_event(self, source: str) -> None:
        """One streaming-core ingest/wake event (stream/core.py).
        Thread-safe by construction (prometheus counters lock
        internally) — this is called from ingest WSGI threads, the
        scrape poller, and watch listeners."""
        self.stream_events.labels(**{LABEL_SOURCE: source}).inc()

    def emit_stream_lag(self, seconds: float) -> None:
        """One consumed load change's observed->published wall time."""
        self.stream_lag.observe(seconds)

    def emit_stream_shed(self, reason: str) -> None:
        """One event refused at the streaming ingest door. Thread-safe
        by construction — called from ingest WSGI threads, the scrape
        poller, and the consumer's escalation valve alike."""
        self.stream_shed.labels(**{LABEL_REASON: reason}).inc()

    def emit_stream_checkpoint(self, event: str) -> None:
        """One warm-restart checkpoint lifecycle event."""
        self.stream_checkpoint.labels(**{LABEL_EVENT: event}).inc()

    def emit_stream_debounce_ms(self, value: float) -> None:
        """Publish the adaptive debounce window currently in effect."""
        self.stream_debounce_ms.set(value)

    def emit_stream_limited(self, lane: str) -> None:
        """One limited-mode drain outcome (consumer thread only)."""
        self.stream_limited.labels(**{LABEL_LANE: lane}).inc()

    def emit_pool_capacity_metrics(self, capacity: dict[str, int]) -> None:
        """Replace the per-generation inventory gauge wholesale each
        cycle (a generation whose last node drained away must stop
        exporting its stale chip count). Pass {} outside limited mode —
        capacity-unaware cycles export nothing rather than a lie."""
        with self._lock:
            self.pool_capacity.clear()
            for generation, chips in capacity.items():
                self.pool_capacity.labels(
                    **{LABEL_GENERATION: generation}).set(chips)

    def emit_power_metrics(
        self, per_variant: dict[tuple[str, str, str], float]
    ) -> None:
        """Replace the power series wholesale each cycle: per-variant
        gauges carry exactly this cycle's published allocations (label
        sets from removed variants or switched accelerators are cleared,
        not left stale) and the fleet gauge is their sum by
        construction. Keys: (variant_name, namespace, accelerator_type)."""
        with self._lock:
            self.variant_power.clear()
            total = 0.0
            for (variant_name, namespace, acc_type), watts in per_variant.items():
                self.variant_power.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_ACCELERATOR_TYPE: acc_type,
                }).set(watts)
                total += watts
            self.fleet_power.set(total)

    def emit_tpu_utilization_metrics(
        self, per_namespace: dict[str, dict[str, float]]
    ) -> None:
        """Replace the TPU runtime gauges wholesale each cycle (same
        invariant as the power/drift series): a namespace whose upstream
        series disappeared — or that dropped out of the fleet — must stop
        exporting its last reading, not serve it forever."""
        with self._lock:
            self.tpu_duty_cycle.clear()
            self.tpu_hbm_usage.clear()
            for namespace, util in per_namespace.items():
                if "duty_cycle_percent" in util:
                    self.tpu_duty_cycle.labels(
                        **{LABEL_NAMESPACE: namespace}
                    ).set(util["duty_cycle_percent"])
                if "hbm_usage_bytes" in util:
                    self.tpu_hbm_usage.labels(
                        **{LABEL_NAMESPACE: namespace}
                    ).set(util["hbm_usage_bytes"])

    def emit_condition_metrics(
        self, per_variant: dict[tuple[str, str, str], str]
    ) -> None:
        """Replace the condition series wholesale each cycle (deleted
        variants' series disappear). Keys: (variant_name, namespace,
        condition_type); values: 'True' | 'False' | anything else =
        Unknown."""
        encoded = {"True": 1.0, "False": 0.0}
        with self._lock:
            self.condition_status.clear()
            for (variant_name, namespace, cond_type), status in \
                    per_variant.items():
                self.condition_status.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_CONDITION_TYPE: cond_type,
                }).set(encoded.get(status, -1.0))

    def emit_drift_metrics(
        self, per_variant: dict[tuple[str, str, str], float]
    ) -> None:
        """Replace the drift series wholesale each cycle (same invariant
        as the power gauges: a deleted variant's — or an unjudged
        metric's — label set disappears rather than exporting its last
        ratio forever). Keys: (variant_name, namespace, metric)."""
        with self._lock:
            self.model_drift.clear()
            for (variant_name, namespace, metric), ratio in per_variant.items():
                self.model_drift.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                    LABEL_METRIC: metric,
                }).set(ratio)

    def emit_degradation_metrics(
        self, per_variant: dict[tuple[str, str], int],
        cycle_state: int,
    ) -> None:
        """Replace the per-variant degradation series wholesale each
        cycle (deleted variants' rungs disappear) and set the cycle-level
        worst rung. Keys: (variant_name, namespace); values: the ladder
        rung (controller/degradation.py)."""
        with self._lock:
            self.degradation_state.clear()
            for (variant_name, namespace), state in per_variant.items():
                self.degradation_state.labels(**{
                    LABEL_VARIANT_NAME: variant_name,
                    LABEL_NAMESPACE: namespace,
                }).set(state)
            self.cycle_degradation_state.set(cycle_state)

    def emit_circuit_metrics(self, per_dependency: dict[str, int]) -> None:
        """Breaker state per dependency (0=closed, 1=half-open, 2=open).
        Not wholesale-replaced: the breaker set is fixed at construction
        and a dependency's series must persist across cycles."""
        with self._lock:
            for dependency, state in per_dependency.items():
                self.circuit_state.labels(
                    **{LABEL_DEPENDENCY: dependency}).set(state)

    def emit_cycle_timing(self, stage_msec: dict[str, float]) -> None:
        """Publish per-stage durations + their total for the last cycle.
        Stages a partial cycle never reached are zeroed, not left holding
        the previous cycle's value — the series always describes ONE
        cycle, so sum(stages) == total. The histogram observes only the
        stages the cycle actually RAN: zero-observations for unreached
        stages would fabricate a fast-looking tail."""
        with self._lock:
            for stage in RECONCILE_STAGES:
                self.reconcile_stage_duration.labels(
                    **{LABEL_STAGE: stage}).set(stage_msec.get(stage, 0.0))
                if stage in stage_msec:
                    self.stage_seconds.labels(**{LABEL_STAGE: stage}).observe(
                        stage_msec[stage] / 1000.0)
            self.reconcile_duration.set(sum(stage_msec.values()))

    def emit_replica_metrics(
        self,
        variant_name: str,
        namespace: str,
        current: int,
        desired: int,
        accelerator_type: str,
    ) -> None:
        """Set current/desired/ratio. Scale-from-zero encodes 0 -> N as
        ratio = N (reference metrics.go:118-124)."""
        labels = {
            LABEL_VARIANT_NAME: variant_name,
            LABEL_NAMESPACE: namespace,
            LABEL_ACCELERATOR_TYPE: accelerator_type,
        }
        with self._lock:
            self.current_replicas.labels(**labels).set(current)
            self.desired_replicas.labels(**labels).set(desired)
            if current == 0:
                self.desired_ratio.labels(**labels).set(desired)
            else:
                self.desired_ratio.labels(**labels).set(desired / current)

    def emit_probe_kick(self, variant_name: str, namespace: str) -> None:
        self.demand_probe_kicks_total.labels(
            **{LABEL_VARIANT_NAME: variant_name,
               LABEL_NAMESPACE: namespace}).inc()

    def emit_scaling_event(
        self, variant_name: str, namespace: str, direction: str, reason: str
    ) -> None:
        self.replica_scaling_total.labels(
            **{
                LABEL_VARIANT_NAME: variant_name,
                LABEL_NAMESPACE: namespace,
                LABEL_DIRECTION: direction,
                LABEL_REASON: reason,
            }
        ).inc()

    def value(self, series: str, **labels) -> Optional[float]:
        """Read back a sample (test/debug helper)."""
        for metric in self.registry.collect():
            for sample in metric.samples:
                if sample.name == series and all(
                    sample.labels.get(k) == v for k, v in labels.items()
                ):
                    return sample.value
        return None
