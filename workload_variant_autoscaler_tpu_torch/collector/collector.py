"""Collector: TPU serving metrics -> current load/latency profile.

Equivalent of the Go reference's internal/collector/collector.go, aimed at
vLLM-TPU / JetStream Prometheus endpoints. Series names are grouped into
a MetricFamily: the default `vllm` dialect (vLLM-TPU exports the same
family the reference scrapes, internal/constants/metrics.go:7-43) or the
`jetstream` dialect (WVA_METRIC_FAMILY=jetstream), with optional TPU
runtime gauges (duty cycle / HBM) collected opportunistically for
observability.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..utils import fix_value, get_logger, kv
from .prometheus import PromAPI, Sample

log = get_logger("wva.collector")

# -- scraped input series (vLLM-TPU exports the same vllm:* family) --------
VLLM_REQUEST_ARRIVAL_TOTAL = "vllm:request_arrival_total"
VLLM_REQUEST_SUCCESS_TOTAL = "vllm:request_success_total"
VLLM_REQUEST_PROMPT_TOKENS_SUM = "vllm:request_prompt_tokens_sum"
VLLM_REQUEST_PROMPT_TOKENS_COUNT = "vllm:request_prompt_tokens_count"
VLLM_REQUEST_GENERATION_TOKENS_SUM = "vllm:request_generation_tokens_sum"
VLLM_REQUEST_GENERATION_TOKENS_COUNT = "vllm:request_generation_tokens_count"
VLLM_TTFT_SECONDS_SUM = "vllm:time_to_first_token_seconds_sum"
VLLM_TTFT_SECONDS_COUNT = "vllm:time_to_first_token_seconds_count"
VLLM_TPOT_SECONDS_SUM = "vllm:time_per_output_token_seconds_sum"
VLLM_TPOT_SECONDS_COUNT = "vllm:time_per_output_token_seconds_count"


@dataclass(frozen=True)
class MetricFamily:
    """Series names of one serving-metrics dialect. Histogram fields hold
    the base name (`_sum`/`_count` are appended by the query builders).
    `arrival_total` may be None — a dialect without an admission counter
    infers saturation-visible demand from `queue_depth` instead (see
    true_arrival_rate_query)."""

    name: str
    success_total: str
    arrival_total: str | None
    queue_depth: str | None
    prompt_tokens: str
    generation_tokens: str
    ttft_seconds: str
    tpot_seconds: str
    # in-service concurrency gauge (batch in decode) — observability and
    # the profile fitter's x-axis, never load-gating
    running: str | None = None
    # label names the per-variant queries match on; "" omits the matcher
    # entirely (a dialect whose exporter doesn't carry that label)
    model_label: str = "model_name"
    namespace_label: str = "namespace"
    # multiplier applied to the running gauge (a dialect exporting slot
    # UTILIZATION as a fraction needs x total-slots to become a batch)
    running_scale: float = 1.0


VLLM_FAMILY = MetricFamily(
    name="vllm",
    success_total=VLLM_REQUEST_SUCCESS_TOTAL,
    arrival_total=VLLM_REQUEST_ARRIVAL_TOTAL,
    queue_depth="vllm:num_requests_waiting",
    prompt_tokens="vllm:request_prompt_tokens",
    generation_tokens="vllm:request_generation_tokens",
    ttft_seconds="vllm:time_to_first_token_seconds",
    tpot_seconds="vllm:time_per_output_token_seconds",
    running="vllm:num_requests_running",
)

# JetStream (MaxText serving) exports histograms for request lengths and
# token latencies plus backlog gauges, but no admission counter — demand
# under saturation is recovered from the prefill backlog growth.
#
# Label caveat (upstream jetstream/core/metrics/prometheus.py): the
# exporter labels series with its own `id`, NOT model_name — so the
# model matcher defaults OFF for this dialect (the `namespace` label is
# attached by prometheus-operator target relabeling and stays). A scrape
# config that relabels a model label back on can restore per-model
# scoping via WVA_JETSTREAM_MODEL_LABEL (docs/user-guide/configuration.md).
# Some builds export slot UTILIZATION (`jetstream_slots_used_percentage`,
# a 0-1 fraction) instead of a count: set
# WVA_JETSTREAM_SLOTS_PERCENTAGE=true plus WVA_JETSTREAM_TOTAL_SLOTS=<N>
# (decode slots per replica) and the running gauge is scaled to a batch.
JETSTREAM_FAMILY = MetricFamily(
    name="jetstream",
    success_total="jetstream_request_success_count_total",
    arrival_total=None,
    queue_depth="jetstream_prefill_backlog_size",
    prompt_tokens="jetstream_request_input_length",
    generation_tokens="jetstream_request_output_length",
    ttft_seconds="jetstream_time_to_first_token",
    tpot_seconds="jetstream_time_per_output_token",
    running="jetstream_slots_used",
    model_label="",
)

METRIC_FAMILIES = {f.name: f for f in (VLLM_FAMILY, JETSTREAM_FAMILY)}


def _jetstream_overrides(family: MetricFamily,
                         cm: dict[str, str] | None = None) -> MetricFamily:
    """Tunable deviations for real JetStream endpoints (see the
    JETSTREAM_FAMILY comment); the in-repo emulator needs none of them.
    Env first, then the operator ConfigMap — the standard knob
    precedence (reference controller.go:516-538)."""
    from dataclasses import replace

    def knob(key: str) -> str | None:
        v = os.environ.get(key)
        if v is None and cm:
            v = cm.get(key)
        return v

    kwargs: dict = {}
    model_label = knob("WVA_JETSTREAM_MODEL_LABEL")
    if model_label is not None:
        kwargs["model_label"] = model_label.strip()
    ns_label = knob("WVA_JETSTREAM_NAMESPACE_LABEL")
    if ns_label is not None:
        kwargs["namespace_label"] = ns_label.strip()
    if (knob("WVA_JETSTREAM_SLOTS_PERCENTAGE") or "").lower() in (
            "1", "true"):
        from ..utils import parse_float_or

        slots = parse_float_or(knob("WVA_JETSTREAM_TOTAL_SLOTS"), 0.0)
        if slots > 0:
            kwargs["running"] = "jetstream_slots_used_percentage"
            kwargs["running_scale"] = slots
        else:
            log.warning(
                "WVA_JETSTREAM_SLOTS_PERCENTAGE needs "
                "WVA_JETSTREAM_TOTAL_SLOTS > 0; keeping the count gauge")
    return replace(family, **kwargs) if kwargs else family


def active_family(cm_value: str | None = None,
                  cm: dict[str, str] | None = None) -> MetricFamily:
    """The dialect selected by WVA_METRIC_FAMILY — env first, then the
    operator-ConfigMap value (reference env-over-ConfigMap precedence,
    controller.go:516-538), default vllm. An unknown name warns and falls
    back — a typo must not silently turn off autoscaling."""
    name = (
        os.environ.get("WVA_METRIC_FAMILY", "").strip()
        or (cm_value or "").strip()
    ).lower() or "vllm"
    family = METRIC_FAMILIES.get(name)
    if family is None:
        log.warning("unknown WVA_METRIC_FAMILY; using vllm",
                    extra=kv(requested=name,
                             known=sorted(METRIC_FAMILIES)))
        return VLLM_FAMILY
    if family.name == "jetstream":
        family = _jetstream_overrides(family, cm=cm)
    return family

# optional TPU runtime gauges (tpu-monitoring-library / libtpu names)
TPU_DUTY_CYCLE = "tpu_duty_cycle_percent"
TPU_HBM_USAGE = "tpu_hbm_memory_usage_bytes"

LABEL_MODEL_NAME = "model_name"
LABEL_NAMESPACE = "namespace"

STALENESS_LIMIT_SECONDS = 300.0  # 5 min (reference collector.go:139-149)
RATE_WINDOW = "1m"               # (reference collector.go:170-209)


def _selector(model: str, namespace: str | None,
              family: "MetricFamily | None") -> str:
    """`{label="value",...}` from the dialect's label names; an empty
    label name omits that matcher (the dialect's exporter doesn't carry
    it — see JETSTREAM_FAMILY's label caveat)."""
    model_label = family.model_label if family else LABEL_MODEL_NAME
    ns_label = family.namespace_label if family else LABEL_NAMESPACE
    parts = []
    if model_label:
        parts.append(f'{model_label}="{model}"')
    if ns_label and namespace is not None:
        parts.append(f'{ns_label}="{namespace}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _rate_sum(metric: str, model: str, namespace: str,
              family: "MetricFamily | None" = None,
              window: str = RATE_WINDOW) -> str:
    sel = _selector(model, namespace, family)
    return f"sum(rate({metric}{sel}[{window}]))"


def _ratio(num: str, den: str, model: str, namespace: str,
           family: "MetricFamily | None" = None) -> str:
    return (f"{_rate_sum(num, model, namespace, family)}/"
            f"{_rate_sum(den, model, namespace, family)}")


def _deriv_sum(metric: str, model: str, namespace: str,
               family: "MetricFamily | None" = None,
               window: str = RATE_WINDOW) -> str:
    sel = _selector(model, namespace, family)
    return f"sum(deriv({metric}{sel}[{window}]))"


def true_arrival_rate_query(
    model: str, namespace: str, family: MetricFamily | None = None,
    window: str = RATE_WINDOW,
) -> str:
    """Demand measured at admission. Under saturation the success rate caps
    at delivered throughput, hiding excess load; the arrival counter does
    not (reference emulator exports it, metrics.py:29-38, but the reference
    collector never reads it — collector.go:170. We prefer it).

    A dialect without an admission counter (JetStream) recovers the same
    signal from queue dynamics: completions/sec plus the backlog growth
    rate is exactly the admission rate, and the clamp keeps a draining
    backlog from under-reporting below delivered throughput."""
    family = family or active_family()
    if family.arrival_total is not None:
        return _rate_sum(family.arrival_total, model, namespace, family,
                         window)
    if family.queue_depth is not None:
        return (
            f"{_rate_sum(family.success_total, model, namespace, family, window)} + "
            f"clamp_min({_deriv_sum(family.queue_depth, model, namespace, family, window)}, 0)"
        )
    return _rate_sum(family.success_total, model, namespace, family, window)


def arrival_rate_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    """Completion-rate fallback for endpoints that lack the arrival counter
    (reference parity, collector.go:170)."""
    family = family or active_family()
    return _rate_sum(family.success_total, model, namespace, family)


def avg_prompt_tokens_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    family = family or active_family()
    return _ratio(
        f"{family.prompt_tokens}_sum", f"{family.prompt_tokens}_count",
        model, namespace, family,
    )


def avg_generation_tokens_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    family = family or active_family()
    return _ratio(
        f"{family.generation_tokens}_sum", f"{family.generation_tokens}_count",
        model, namespace, family,
    )


def avg_ttft_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    family = family or active_family()
    return _ratio(f"{family.ttft_seconds}_sum", f"{family.ttft_seconds}_count",
                  model, namespace, family)


def avg_itl_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    family = family or active_family()
    return _ratio(f"{family.tpot_seconds}_sum", f"{family.tpot_seconds}_count",
                  model, namespace, family)


def avg_running_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    """In-service concurrency over the rate window — the profile fitter's
    x-axis (decode latency is linear in batch). Empty for a dialect
    without a running gauge."""
    family = family or active_family()
    if family.running is None:
        return ""
    sel = _selector(model, namespace, family)
    q = f"sum(avg_over_time({family.running}{sel}[{RATE_WINDOW}]))"
    if family.running_scale != 1.0:
        q = f"{q} * {family.running_scale:g}"
    return q


def avg_waiting_query(
    model: str, namespace: str, family: MetricFamily | None = None
) -> str:
    """Queue depth over the rate window — the fitter uses near-zero
    waiting samples to isolate prefill from queueing wait."""
    family = family or active_family()
    if family.queue_depth is None:
        return ""
    sel = _selector(model, namespace, family)
    return f"sum(avg_over_time({family.queue_depth}{sel}[{RATE_WINDOW}]))"


def availability_query(
    model: str, namespace: str | None = None,
    family: MetricFamily | None = None,
) -> str:
    family = family or active_family()
    sel = _selector(model, namespace, family)
    return f"{family.success_total}{sel}"


@dataclass(frozen=True)
class MetricsValidation:
    """Result of the availability/staleness gate
    (reference collector.go:79-156)."""

    available: bool
    reason: str
    message: str


@dataclass(frozen=True)
class CollectedLoad:
    """Scraped load/latency snapshot for one variant (units converted:
    req/min, tokens, msec)."""

    arrival_rate_rpm: float
    avg_input_tokens: float
    avg_output_tokens: float
    avg_ttft_ms: float
    avg_itl_ms: float


class IncompleteMetricsError(Exception):
    """Load exists but the series needed to model it do not.

    Raised when arrivals are nonzero while a token/latency aggregate is
    absent (or NaN, i.e. 0/0: no completions in the rate window). Feeding
    the resulting 0.0 into the engine would misread a loaded variant as
    idle and take the zero-load path (the reference zero-fills here,
    collector.go:51-76 — a flaw we deliberately do not reproduce)."""

    def __init__(self, model: str, namespace: str, missing: list[str]):
        self.missing = missing
        super().__init__(
            f"model '{model}' in '{namespace}' shows nonzero arrivals but "
            f"no usable data for: {', '.join(missing)}; the scrape may be "
            "partial or no request has completed within the rate window"
        )


def _value_and_presence(prom: PromAPI, promql: str) -> tuple[float | None, bool]:
    """(value, series_present): value is None when the series is absent OR
    the sample is NaN/Inf (PromQL 0/0 or overflow) — 'unknown' must stay
    distinguishable from a genuine 0.0. Presence distinguishes an absent
    series (e.g. a variant that has never served) from a series that
    EXISTS but answers garbage (a NaN storm), which is a scrape failure,
    not idleness."""
    samples = prom.query(promql)
    if not samples:
        return None, False
    v = samples[0].value
    return (v if fix_value(v) == v else None), True


def _value_or_none(prom: PromAPI, promql: str) -> float | None:
    return _value_and_presence(prom, promql)[0]


def validate_metrics_availability(
    prom: PromAPI, model: str, namespace: str, now: float | None = None,
    family: MetricFamily | None = None,
) -> MetricsValidation:
    """Check serving metrics exist and are fresh. Falls back to a
    namespace-less query for emulator endpoints (reference
    collector.go:87-156)."""
    from ..controller import crd

    family = family or active_family()
    try:
        samples = prom.query(availability_query(model, namespace, family))
        if not samples:
            # namespace-less fallback ONLY while a model matcher keeps it
            # scoped: for a dialect with no model label (jetstream) the
            # fallback would be matcher-free and any series anywhere in
            # the cluster would validate an unrelated broken variant
            fallback = availability_query(model, family=family)
            if "{" in fallback:
                samples = prom.query(fallback)
    except Exception as e:  # noqa: BLE001 - any query failure is a condition
        log.error("prometheus query failed during validation",
                  extra=kv(model=model, namespace=namespace, error=str(e)))
        return MetricsValidation(
            available=False,
            reason=crd.REASON_PROMETHEUS_ERROR,
            message=f"Failed to query Prometheus: {e}",
        )

    if not samples:
        return MetricsValidation(
            available=False,
            reason=crd.REASON_METRICS_MISSING,
            message=(
                f"No serving metrics found for model '{model}' in namespace "
                f"'{namespace}'. Check: (1) ServiceMonitor/PodMonitor exists and "
                "matches the serving pods, (2) vLLM-TPU/JetStream pods expose "
                "/metrics, (3) Prometheus scrapes the monitoring namespace"
            ),
        )

    t = time.time() if now is None else now
    for s in samples:
        age = t - s.timestamp
        if age > STALENESS_LIMIT_SECONDS:
            return MetricsValidation(
                available=False,
                reason=crd.REASON_METRICS_STALE,
                message=(
                    f"Serving metrics for model '{model}' are stale "
                    f"(last update {age:.0f}s ago); scrape may be broken"
                ),
            )

    return MetricsValidation(
        available=True,
        reason=crd.REASON_METRICS_FOUND,
        message="serving metrics are available and fresh",
    )


# Token-stat defaults for a cold start with no history anywhere (a fresh
# VA whose first-ever requests haven't completed): a generic chat mix.
DEFAULT_AVG_INPUT_TOKENS = 128.0
DEFAULT_AVG_OUTPUT_TOKENS = 128.0


def collect_load(
    prom: PromAPI,
    model: str,
    namespace: str,
    fallback: CollectedLoad | None = None,
    family: MetricFamily | None = None,
    probe_window: str | None = None,
) -> CollectedLoad:
    """Run the aggregate queries (reference collector.go:158-278) and
    convert units: arrival req/s -> req/min, latencies sec -> msec.

    Demand is the admission-side arrival rate when the endpoint exports it,
    falling back to the completion rate otherwise (see
    true_arrival_rate_query). When arrivals are nonzero but a modeling
    series is unusable, two states are distinguished:

    - completions ARE flowing (success rate > 0) yet an aggregate is
      absent: the scrape is genuinely partial -> IncompleteMetricsError
      (never zero-fill; the reference's zero-fill at collector.go:51-76
      misreads a loaded variant as idle).
    - nothing has completed in the rate window (scaled to zero, cold
      start, or hard saturation): 0/0 aggregates are *expected*, and the
      variant must still be sized or it can never scale up — token stats
      fall back to the caller-provided last-known values (CR status), then
      to defaults.
    """
    family = family or active_family()
    success_rps: float | None = None
    success_fetched = False
    arrival_rps, arrival_present = _value_and_presence(
        prom, true_arrival_rate_query(model, namespace, family))
    if (arrival_rps is not None and probe_window
            and probe_window != RATE_WINDOW):
        # identical windows would issue the byte-identical query twice
        # and max() two equal values — pure Prometheus load for no signal
        # demand-breakout mode (WVA_FAST_DEMAND_PROBE): size on the MAX
        # of the standard 1m window and the probe's short window. Right
        # after a ramp step the 1m rate still averages mostly-old load —
        # a probe-kicked cycle sizing on it under-provisions the very
        # step it reacted to. Steady state the two windows agree (the
        # short one is noisier; max() errs a few % conservative, the
        # fail-safe direction for an SLO autoscaler).
        short = _value_or_none(
            prom, true_arrival_rate_query(model, namespace, family,
                                          window=probe_window))
        if short is not None:
            arrival_rps = max(arrival_rps, short)
    if arrival_rps is None:
        success_rps, success_present = _value_and_presence(
            prom, arrival_rate_query(model, namespace, family))
        success_fetched = True
        arrival_rps = success_rps
        if arrival_rps is None:
            if arrival_present or success_present:
                # the demand series EXIST but answer NaN/Inf (a NaN
                # storm, 0/0 windows during a scrape break): demand is
                # UNKNOWN, not zero — zero-filling here would read a
                # possibly-loaded variant as idle and tear it down
                raise IncompleteMetricsError(model, namespace,
                                             ["arrival_rate"])
            log.warning("no arrival or success rate observable; treating as idle",
                        extra=kv(model=model, namespace=namespace))
            arrival_rps = 0.0

    in_tok = _value_or_none(prom, avg_prompt_tokens_query(model, namespace, family))
    out_tok = _value_or_none(
        prom, avg_generation_tokens_query(model, namespace, family))
    ttft_s = _value_or_none(prom, avg_ttft_query(model, namespace, family))
    itl_s = _value_or_none(prom, avg_itl_query(model, namespace, family))

    missing = [name for name, v in (
        ("avg_prompt_tokens", in_tok),
        ("avg_generation_tokens", out_tok),
        ("avg_ttft", ttft_s),
        ("avg_itl", itl_s),
    ) if v is None]
    if arrival_rps > 0.0 and missing:
        if not success_fetched:
            success_rps = _value_or_none(
                prom, arrival_rate_query(model, namespace, family))
        if success_rps is not None and success_rps > 0.0:
            raise IncompleteMetricsError(model, namespace, missing)
        # no completions in the window: size from demand + best-known
        # token stats so scale-from-zero / cold-start can proceed
        if in_tok is None:
            in_tok = (fallback.avg_input_tokens if fallback else 0.0) \
                or DEFAULT_AVG_INPUT_TOKENS
        if out_tok is None:
            out_tok = (fallback.avg_output_tokens if fallback else 0.0) \
                or DEFAULT_AVG_OUTPUT_TOKENS
        log.info(
            "arrivals without completions in window; using fallback token stats",
            extra=kv(model=model, namespace=namespace,
                     avg_input_tokens=in_tok, avg_output_tokens=out_tok),
        )

    return CollectedLoad(
        arrival_rate_rpm=arrival_rps * 60.0,
        avg_input_tokens=in_tok or 0.0,
        avg_output_tokens=out_tok or 0.0,
        avg_ttft_ms=(ttft_s or 0.0) * 1000.0,
        avg_itl_ms=(itl_s or 0.0) * 1000.0,
    )


# -- fleet-wide grouped queries (O(metric-families) collection) ------------
# The per-variant builders above filter to ONE model and cost the cycle
# ~8 Prometheus round-trips per variant. These aggregate the SAME series
# `by (model_label, namespace_label)` instead, so one query answers the
# whole fleet and the FleetLoadCollector demuxes samples back into
# per-variant loads by label. The per-group value is identical to the
# per-variant value by construction: sum(rate(x{m,ns})) == the (m,ns)
# group of sum by (m,ns)(rate(x)).

# collection modes (DecisionRecords + inferno_collection_queries_total)
MODE_FLEET = "fleet"                    # demuxed from the grouped result
MODE_REPAIR = "per-variant-repair"      # labels missing from the grouped
                                        # result: single-variant queries
MODE_LEGACY = "legacy"                  # WVA_FLEET_COLLECTION=off path
MODE_STREAM = "stream"                  # pushed/streamed ingest (stream/):
                                        # zero Prometheus round-trips


def fleet_group_by(family: MetricFamily | None = None) -> str:
    """The `by (...)` label list for fleet-wide aggregation; empty when
    the dialect carries neither label (grouping impossible — the
    collector then stays on the per-variant path)."""
    family = family or active_family()
    return ",".join(
        label for label in (family.model_label, family.namespace_label)
        if label)


def _fleet_rate_sum(metric: str, family: MetricFamily,
                    window: str = RATE_WINDOW) -> str:
    return f"sum by ({fleet_group_by(family)}) (rate({metric}[{window}]))"


def _fleet_deriv_sum(metric: str, family: MetricFamily,
                     window: str = RATE_WINDOW) -> str:
    return f"sum by ({fleet_group_by(family)}) (deriv({metric}[{window}]))"


def _fleet_ratio(num: str, den: str, family: MetricFamily) -> str:
    # PromQL matches the division on the group labels of both sides, so
    # each (model, ns) group divides its own aggregates — and a 0/0
    # group answers NaN with the group PRESENT, exactly like the
    # per-variant ratio ('unknown', never a fabricated 0)
    return (f"{_fleet_rate_sum(num, family)}/"
            f"{_fleet_rate_sum(den, family)}")


def fleet_true_arrival_rate_query(
    family: MetricFamily | None = None, window: str = RATE_WINDOW,
) -> str:
    """Grouped form of true_arrival_rate_query (same demand semantics,
    queue-dynamics recovery included for admission-counter-less
    dialects)."""
    family = family or active_family()
    if family.arrival_total is not None:
        return _fleet_rate_sum(family.arrival_total, family, window)
    if family.queue_depth is not None:
        return (
            f"{_fleet_rate_sum(family.success_total, family, window)} + "
            f"clamp_min({_fleet_deriv_sum(family.queue_depth, family, window)}, 0)"
        )
    return _fleet_rate_sum(family.success_total, family, window)


def fleet_arrival_rate_query(family: MetricFamily | None = None) -> str:
    family = family or active_family()
    return _fleet_rate_sum(family.success_total, family)


def fleet_avg_prompt_tokens_query(family: MetricFamily | None = None) -> str:
    family = family or active_family()
    return _fleet_ratio(f"{family.prompt_tokens}_sum",
                        f"{family.prompt_tokens}_count", family)


def fleet_avg_generation_tokens_query(
    family: MetricFamily | None = None,
) -> str:
    family = family or active_family()
    return _fleet_ratio(f"{family.generation_tokens}_sum",
                        f"{family.generation_tokens}_count", family)


def fleet_avg_ttft_query(family: MetricFamily | None = None) -> str:
    family = family or active_family()
    return _fleet_ratio(f"{family.ttft_seconds}_sum",
                        f"{family.ttft_seconds}_count", family)


def fleet_avg_itl_query(family: MetricFamily | None = None) -> str:
    family = family or active_family()
    return _fleet_ratio(f"{family.tpot_seconds}_sum",
                        f"{family.tpot_seconds}_count", family)


def fleet_availability_query(family: MetricFamily | None = None) -> str:
    """RAW series, no matcher: every exporter's success counter with its
    full label set and real timestamps — presence AND staleness for the
    whole fleet from one query (the per-variant availability_query is
    the same series filtered to one model)."""
    family = family or active_family()
    return family.success_total


class CountingPromAPI:
    """PromAPI wrapper that counts queries (the
    inferno_collection_queries_total feed for the legacy/repair paths).
    `on_query` lets a FleetLoadCollector share one repair counter across
    every variant's repair client."""

    def __init__(self, inner: PromAPI, on_query=None):
        self.inner = inner
        self.count = 0
        self._on_query = on_query

    def query(self, promql: str) -> list:
        self.count += 1
        if self._on_query is not None:
            self._on_query()
        return self.inner.query(promql)


class _FleetView:
    """Per-variant PromAPI answering from one variant's slice of the
    grouped indexes — validate_metrics_availability/collect_load run
    UNCHANGED against it, so the fleet path cannot drift from the
    per-variant semantics (presence vs. absence, NaN-is-unknown, the
    probe-window override, the namespace-less availability fallback).
    Queries outside the prefetched set (none on the collect path today)
    forward to the real client and count as repair traffic."""

    def __init__(self, fleet: "FleetLoadCollector", model: str,
                 namespace: str):
        self.fleet = fleet
        self.model = model
        fam = fleet.family
        self._key = fleet.group_key(model, namespace)
        q: dict[str, tuple[str, str]] = {
            availability_query(model, namespace, fam):
                ("avail", ""),
            true_arrival_rate_query(model, namespace, fam):
                ("value", "demand"),
            arrival_rate_query(model, namespace, fam):
                ("value", "success"),
            avg_prompt_tokens_query(model, namespace, fam):
                ("value", "prompt_tokens"),
            avg_generation_tokens_query(model, namespace, fam):
                ("value", "generation_tokens"),
            avg_ttft_query(model, namespace, fam): ("value", "ttft"),
            avg_itl_query(model, namespace, fam): ("value", "itl"),
        }
        if fleet.probe_window:
            q[true_arrival_rate_query(model, namespace, fam,
                                      window=fleet.probe_window)] = \
                ("value", "demand_probe")
        # the namespace-less availability fallback (validated only while
        # a model matcher keeps it scoped — same guard as the caller's)
        nsless = availability_query(model, family=fam)
        if nsless not in q and "{" in nsless:
            q[nsless] = ("avail_nsless", "")
        self._queries = q

    def query(self, promql: str) -> list[Sample]:
        spec = self._queries.get(promql)
        if spec is None:
            self.fleet.repair_query_count += 1
            return self.fleet.prom.query(promql)
        kind, name = spec
        if kind == "avail":
            return list(self.fleet.avail.get(self._key, []))
        if kind == "avail_nsless":
            out: list[Sample] = []
            for key, samples in self.fleet.avail.items():
                if self.fleet.key_matches_model(key, self.model):
                    out.extend(samples)
            return out
        sample = self.fleet.values.get(name, {}).get(self._key)
        return [sample] if sample is not None else []


class FleetLoadCollector:
    """O(metric-families) collection for the whole fleet.

    prefetch() issues one grouped query per metric family (~7-8 total,
    fleet-size independent), indexes the returned samples by their
    (model_label, namespace_label) values, and variant_prom() hands each
    variant either a _FleetView over its group (MODE_FLEET) or — when
    the variant's labels are missing from the grouped result, or any
    grouped query failed — the real per-variant client (MODE_REPAIR), so
    a grouped-query quirk degrades to exactly the pre-existing
    per-variant ladder, never to a zero-fill."""

    def __init__(self, prom: PromAPI, family: MetricFamily | None = None,
                 probe_window: str | None = None):
        self.prom = prom
        self.family = family or active_family()
        self.probe_window = (probe_window if probe_window
                             and probe_window != RATE_WINDOW else None)
        self.enabled = bool(fleet_group_by(self.family))
        self.failed = False
        self.query_count = 0         # grouped (fleet-mode) queries issued
        self.repair_query_count = 0  # per-variant repair queries issued
        self._fetched = False
        # group key -> samples (availability) / Sample (aggregates)
        self.avail: dict[tuple, list[Sample]] = {}
        self.values: dict[str, dict[tuple, Sample]] = {}

    # -- label demux -----------------------------------------------------

    def group_key(self, model: str, namespace: str) -> tuple:
        key = []
        if self.family.model_label:
            key.append(model)
        if self.family.namespace_label:
            key.append(namespace)
        return tuple(key)

    def sample_key(self, labels: dict[str, str]) -> tuple | None:
        """The group key carried by a returned sample; None when the
        sample lacks a demux label (it can't be attributed and is
        dropped — the owning variant then takes the repair path)."""
        key = []
        for label in (self.family.model_label,
                      self.family.namespace_label):
            if not label:
                continue
            value = labels.get(label)
            if value is None:
                return None
            key.append(value)
        return tuple(key)

    def key_matches_model(self, key: tuple, model: str) -> bool:
        return bool(self.family.model_label) and bool(key) \
            and key[0] == model

    # -- the grouped fetch ------------------------------------------------

    def prefetch(self) -> None:
        """Issue the grouped queries once per cycle. ANY failure poisons
        the whole batch (failed=True): a half-fetched index could
        misread a grouped timeout as a variant-level series absence, so
        every variant falls back to the per-variant path, which carries
        the existing validation/breaker/backoff ladder."""
        if self._fetched or not self.enabled:
            self._fetched = True
            return
        self._fetched = True
        fam = self.family
        specs: dict[str, str] = {
            "availability": fleet_availability_query(fam),
            "demand": fleet_true_arrival_rate_query(fam),
            "success": fleet_arrival_rate_query(fam),
            "prompt_tokens": fleet_avg_prompt_tokens_query(fam),
            "generation_tokens": fleet_avg_generation_tokens_query(fam),
            "ttft": fleet_avg_ttft_query(fam),
            "itl": fleet_avg_itl_query(fam),
        }
        if self.probe_window:
            specs["demand_probe"] = fleet_true_arrival_rate_query(
                fam, window=self.probe_window)
        try:
            for name, promql in specs.items():
                self.query_count += 1
                samples = self.prom.query(promql)
                if name == "availability":
                    avail: dict[tuple, list[Sample]] = {}
                    for s in samples:
                        key = self.sample_key(s.labels)
                        if key is not None:
                            avail.setdefault(key, []).append(s)
                    self.avail = avail
                else:
                    index: dict[tuple, Sample] = {}
                    for s in samples:
                        key = self.sample_key(s.labels)
                        if key is not None:
                            index[key] = s
                    self.values[name] = index
        except Exception as e:  # noqa: BLE001 - any failure -> repair path
            log.warning(
                "fleet collection prefetch failed; repairing per-variant",
                extra=kv(family=fam.name, error=str(e)))
            self.failed = True

    def variant_prom(self, model: str, namespace: str) -> tuple[PromAPI, str]:
        """(client, mode) for one variant: a grouped-index view when its
        labels landed in the grouped result, the counted real client
        otherwise."""
        self.prefetch()
        if not self.enabled or self.failed:
            return self._repair_prom(), MODE_REPAIR
        key = self.group_key(model, namespace)
        present = (
            key in self.avail
            or key in self.values.get("demand", {})
            or any(self.key_matches_model(k, model) for k in self.avail)
        )
        if not present:
            return self._repair_prom(), MODE_REPAIR
        return _FleetView(self, model, namespace), MODE_FLEET

    def _repair_prom(self) -> PromAPI:
        def bump() -> None:
            self.repair_query_count += 1

        return CountingPromAPI(self.prom, on_query=bump)


# GKE TPU accelerator label values -> chip generation (the TPU analogue of
# the reference's GPU vendor list, collector.go:31-35; realizes its
# CollectInventoryK8S stub, collector.go:37-42, for the limited mode).
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
TPU_ACCELERATOR_GENERATIONS = {
    "tpu-v5-lite-podslice": "v5e",
    "tpu-v5-lite-device": "v5e",
    "tpu-v5p-slice": "v5p",
    "tpu-v6e-slice": "v6e",
}


def collect_inventory_k8s(kube) -> dict[str, int]:
    """Total TPU chips per generation from node labels + google.com/tpu
    capacity — the capacity map the greedy (limited-mode) solver allocates
    against. Nodes without a recognised accelerator label or with zero
    capacity are skipped."""
    capacity: dict[str, int] = {}
    for node in kube.list_nodes():
        if node.tpu_capacity <= 0 or not node.schedulable():
            continue
        accel = node.labels.get(GKE_TPU_ACCELERATOR_LABEL, "")
        generation = TPU_ACCELERATOR_GENERATIONS.get(accel)
        if generation is None:
            continue
        capacity[generation] = capacity.get(generation, 0) + node.tpu_capacity
    return capacity


def collect_tpu_utilization(prom: PromAPI, namespace: str) -> dict[str, float]:
    """Opportunistic TPU runtime gauges; absent OR unusable (NaN/Inf)
    series are simply omitted from the dict — unknown must stay
    distinguishable from a genuine 0 reading (these are
    observability-only, never gating)."""
    out: dict[str, float] = {}
    try:
        duty = _value_or_none(
            prom, f'avg({TPU_DUTY_CYCLE}{{{LABEL_NAMESPACE}="{namespace}"}})')
        if duty is not None:
            out["duty_cycle_percent"] = duty
        hbm = _value_or_none(
            prom, f'sum({TPU_HBM_USAGE}{{{LABEL_NAMESPACE}="{namespace}"}})')
        if hbm is not None:
            out["hbm_usage_bytes"] = hbm
    except Exception:  # noqa: BLE001
        return out
    return out
