"""Prometheus series for the emulator, in the scraped serving namespace.

Mirrors the metric surface of the reference emulator
(the Go reference's tools/vllm-emulator/metrics.py) — the series the collector
queries (internal/constants/metrics.go:7-43) plus scheduler/KV gauges —
on an instance-scoped registry. `family="jetstream"` exports the
JetStream-shaped dialect instead (histogram request lengths / token
latencies, backlog gauges, NO admission counter — matching what a real
JetStream server gives the collector to work with)."""

from __future__ import annotations

from dataclasses import dataclass

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

from .engine import MetricsSink, Request

ITL_BUCKETS = [0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0, 2.5]
TTFT_BUCKETS = [0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5,
                0.75, 1.0, 2.5, 5.0, 7.5, 10.0]
TOKEN_BUCKETS = [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000]


@dataclass(frozen=True)
class SinkSeries:
    """Base names (prometheus_client appends _total/_sum/_count) for one
    serving dialect. `arrival` None = the dialect has no admission
    counter (JetStream)."""

    arrival: str | None
    success: str
    prompt: str
    generation: str
    ttft: str
    tpot: str
    running: str
    waiting: str
    kv: str


def _sink_series(family, kv: str) -> SinkSeries:
    """Derive the exported base names from the collector's MetricFamily,
    so the series the emulator emits and the series the collector queries
    cannot drift apart (counter bases get _total appended by
    prometheus_client — strip it; histogram fields are already bases).
    `kv` is an emulator observability extra the collector never queries,
    hence not part of MetricFamily."""
    def base(name):
        return name.removesuffix("_total") if name else None

    return SinkSeries(
        arrival=base(family.arrival_total),
        success=base(family.success_total),
        prompt=family.prompt_tokens,
        generation=family.generation_tokens,
        ttft=family.ttft_seconds,
        tpot=family.tpot_seconds,
        running=family.running,
        waiting=family.queue_depth,
        kv=kv,
    )


def _sink_families():
    from ..collector import JETSTREAM_FAMILY, VLLM_FAMILY

    return {
        "vllm": _sink_series(VLLM_FAMILY, kv="vllm:gpu_cache_usage_perc"),
        "jetstream": _sink_series(JETSTREAM_FAMILY,
                                  kv="jetstream_kv_cache_utilization"),
    }


SINK_FAMILIES = _sink_families()


class PrometheusSink(MetricsSink):
    def __init__(self, model_name: str, namespace: str = "",
                 registry: CollectorRegistry | None = None,
                 family: str = "vllm"):
        self.registry = registry or CollectorRegistry()
        self.model_name = model_name
        self.namespace = namespace
        self.family = family
        series = SINK_FAMILIES[family]
        labelnames = ["model_name"] + (["namespace"] if namespace else [])
        self._labels = {"model_name": model_name}
        if namespace:
            self._labels["namespace"] = namespace

        r = self.registry
        self.request_arrival = None if series.arrival is None else Counter(
            series.arrival, "Requests received", labelnames, registry=r)
        self.request_success = Counter(
            series.success, "Requests completed", labelnames, registry=r)
        self.prompt_tokens = Histogram(
            series.prompt, "Prompt token count per request",
            labelnames, buckets=TOKEN_BUCKETS, registry=r)
        self.generation_tokens = Histogram(
            series.generation, "Generated token count per request",
            labelnames, buckets=TOKEN_BUCKETS, registry=r)
        self.ttft_seconds = Histogram(
            series.ttft, "TTFT seconds",
            labelnames, buckets=TTFT_BUCKETS, registry=r)
        self.tpot_seconds = Histogram(
            series.tpot, "Inter-token latency seconds",
            labelnames, buckets=ITL_BUCKETS, registry=r)
        self.num_running = Gauge(
            series.running, "Requests in decode", labelnames, registry=r)
        self.num_waiting = Gauge(
            series.waiting, "Requests queued", labelnames, registry=r)
        self.kv_usage = Gauge(
            series.kv, "KV cache usage fraction", labelnames, registry=r)

    def on_arrival(self, req: Request) -> None:
        # True demand signal: counted at admission to the fleet, not at
        # completion, so the collector can see load a saturated replica
        # cannot deliver (reference tools/vllm-emulator/metrics.py:29-35).
        # The jetstream dialect has no such counter; demand visibility
        # comes from the backlog gauge instead.
        if self.request_arrival is not None:
            self.request_arrival.labels(**self._labels).inc()

    def on_first_token(self, req: Request) -> None:
        self.ttft_seconds.labels(**self._labels).observe(max(req.ttft_ms, 0.0) / 1000.0)

    def on_token(self, dt_ms: float) -> None:
        self.tpot_seconds.labels(**self._labels).observe(dt_ms / 1000.0)

    def on_finish(self, req: Request) -> None:
        self.request_success.labels(**self._labels).inc()
        self.prompt_tokens.labels(**self._labels).observe(req.in_tokens)
        self.generation_tokens.labels(**self._labels).observe(req.tokens_out)

    def set_queue_sizes(self, running: int, waiting: int) -> None:
        self.num_running.labels(**self._labels).set(running)
        self.num_waiting.labels(**self._labels).set(waiting)

    def set_kv_usage(self, frac: float) -> None:
        self.kv_usage.labels(**self._labels).set(frac)

    # -- raw counter reads for the sim-time prom (no text scrape) --------

    def counters(self) -> dict[str, float]:
        """Cumulative values for the series the collector rates over."""
        out: dict[str, float] = {}
        for metric in self.registry.collect():
            for sample in metric.samples:
                if sample.name.endswith("_bucket"):
                    continue
                out[sample.name] = out.get(sample.name, 0.0) + sample.value
        return out


class RecordingSink(MetricsSink):
    """Plain recorder for assertions in tests."""

    def __init__(self) -> None:
        self.arrivals = 0
        self.finished: list[Request] = []
        self.ttfts_ms: list[float] = []
        self.itls_ms: list[float] = []

    def on_arrival(self, req: Request) -> None:
        self.arrivals += 1

    def on_first_token(self, req: Request) -> None:
        self.ttfts_ms.append(req.ttft_ms)

    def on_token(self, dt_ms: float) -> None:
        self.itls_ms.append(dt_ms)

    def on_finish(self, req: Request) -> None:
        self.finished.append(req)
