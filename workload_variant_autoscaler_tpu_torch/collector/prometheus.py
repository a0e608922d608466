"""Prometheus query client: HTTPS-only, TLS/mTLS/bearer auth.

Equivalent of the reference's Prometheus transport
(the Go reference's internal/utils/{tls.go,prometheus_transport.go}): the
controller refuses plain-http endpoints (https required, tls.go:63-97),
supports CA pinning, client certs, SNI override and bearer tokens (direct
value or mounted file). The query API is a tiny protocol so tests and the
emulator can stand in for a real server.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Protocol

from ..obs import trace as obs_trace
from ..utils import (
    CIRCUIT_OPEN,
    PROMETHEUS_BACKOFF,
    CircuitOpenError,
    fix_value,
    get_logger,
    kv,
    with_backoff,
)

log = get_logger("wva.prometheus")


@dataclass(frozen=True)
class Sample:
    labels: dict[str, str]
    value: float
    timestamp: float  # unix seconds


class PromAPI(Protocol):
    def query(self, promql: str) -> list[Sample]: ...


@dataclass
class PrometheusConfig:
    """Reference interfaces/types.go:30-47."""

    base_url: str = ""
    insecure_skip_verify: bool = False
    ca_cert_path: str = ""
    client_cert_path: str = ""
    client_key_path: str = ""
    server_name: str = ""
    bearer_token: str = ""
    token_path: str = ""

    @classmethod
    def from_env(cls) -> Optional["PrometheusConfig"]:
        """Reference internal/utils/tls.go:101-118."""
        base_url = os.environ.get("PROMETHEUS_BASE_URL", "")
        if not base_url:
            return None
        return cls(
            base_url=base_url,
            insecure_skip_verify=os.environ.get(
                "PROMETHEUS_TLS_INSECURE_SKIP_VERIFY", ""
            ).lower() == "true",
            ca_cert_path=os.environ.get("PROMETHEUS_CA_CERT_PATH", ""),
            client_cert_path=os.environ.get("PROMETHEUS_CLIENT_CERT_PATH", ""),
            client_key_path=os.environ.get("PROMETHEUS_CLIENT_KEY_PATH", ""),
            server_name=os.environ.get("PROMETHEUS_SERVER_NAME", ""),
            bearer_token=os.environ.get("PROMETHEUS_BEARER_TOKEN", ""),
            token_path=os.environ.get("PROMETHEUS_TOKEN_PATH", ""),
        )


def validate_tls_config(config: PrometheusConfig, allow_http: bool = False) -> None:
    """HTTPS-only enforcement (reference tls.go:63-97). `allow_http` exists
    for the in-cluster emulator/e2e path where TLS terminates elsewhere."""
    if not config.base_url:
        raise ValueError("Prometheus base URL is required")
    if config.base_url.startswith("https://"):
        pass
    elif config.base_url.startswith("http://"):
        if not allow_http:
            raise ValueError(
                f"Prometheus URL must use https:// scheme, got {config.base_url!r}; "
                "plain http is disabled outside emulation"
            )
    else:
        raise ValueError(f"invalid Prometheus URL {config.base_url!r}")
    if bool(config.client_cert_path) != bool(config.client_key_path):
        raise ValueError("client cert and key must both be set for mutual TLS")


class HTTPPromAPI:
    """requests-backed PromQL instant-query client."""

    def __init__(self, config: PrometheusConfig, allow_http: bool = False, timeout: float = 10.0):
        import requests

        validate_tls_config(config, allow_http=allow_http)
        self.config = config
        self._allow_http = allow_http
        self.timeout = timeout
        self._session = requests.Session()
        if config.insecure_skip_verify:
            self._session.verify = False
        elif config.ca_cert_path:
            self._session.verify = config.ca_cert_path
        if config.client_cert_path and config.client_key_path:
            self._session.cert = (config.client_cert_path, config.client_key_path)

    def clone(self) -> "HTTPPromAPI":
        """Fresh client over the same config with its OWN requests.Session.
        requests.Session is not documented thread-safe; any daemon thread
        querying concurrently with the reconcile loop (the demand-breakout
        probe) must hold its own connection pool, not share this one."""
        return HTTPPromAPI(self.config, allow_http=self._allow_http,
                           timeout=self.timeout)

    def _bearer(self) -> Optional[str]:
        """Direct token wins over a mounted token file (reference
        prometheus_transport.go:44-56)."""
        if self.config.bearer_token:
            return self.config.bearer_token
        if self.config.token_path:
            with open(self.config.token_path) as f:
                return f.read().strip()
        return None

    def _get(self, path: str, params: dict) -> dict:
        headers = {}
        token = self._bearer()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        resp = self._session.get(
            f"{self.config.base_url.rstrip('/')}{path}",
            params=params, headers=headers, timeout=self.timeout,
        )
        resp.raise_for_status()
        body = resp.json()
        if body.get("status") != "success":
            raise RuntimeError(f"prometheus query failed: {body}")
        return body.get("data", {})

    def query(self, promql: str) -> list[Sample]:
        data = self._get("/api/v1/query", {"query": promql})
        if data.get("resultType") != "vector":
            return []
        out = []
        for item in data.get("result", []):
            ts, val = item.get("value", [0, "nan"])
            out.append(
                Sample(
                    labels=dict(item.get("metric", {})),
                    value=fix_value(float(val)),
                    timestamp=float(ts),
                )
            )
        return out

    def query_range(self, promql: str, start_s: float, end_s: float,
                    step_s: float,
                    series_labels: Optional[dict] = None) -> list[Sample]:
        """Flat time series of ONE result series (the collector's
        aggregations always reduce to one) between start and end, one
        Sample per step — the profile fitter's data feed.

        A multi-series answer (label drift, duplicate jobs — and now a
        real possibility with the grouped fleet queries) is resolved
        deterministically: the series matching `series_labels` when
        given, else the one with the lexicographically smallest sorted
        label set — never whatever order the server happened to return —
        and the discarded series' labels are logged."""
        data = self._get("/api/v1/query_range", {
            "query": promql, "start": start_s, "end": end_s,
            "step": step_s,
        })
        if data.get("resultType") != "matrix" or not data.get("result"):
            return []
        results = data["result"]

        def label_key(entry: dict) -> list:
            return sorted(entry.get("metric", {}).items())

        series = min(results, key=label_key)
        if len(results) > 1:
            if series_labels:
                matching = [
                    entry for entry in results
                    if all(entry.get("metric", {}).get(k) == v
                           for k, v in series_labels.items())
                ]
                if matching:
                    series = min(matching, key=label_key)
            log.warning(
                "query_range returned %d series; selected %s, discarded %s "
                "(mis-scoped query? duplicate jobs?)",
                len(results), dict(series.get("metric", {})),
                [dict(entry.get("metric", {})) for entry in results
                 if entry is not series],
                extra=kv(query=promql[:200]),
            )
        labels = dict(series.get("metric", {}))
        # NaN is passed through RAW, unlike the instant query: a 0/0
        # window means 'unknown', and the fitter must be able to DROP it —
        # scrubbing to 0.0 here would feed zero-latency ghosts into the
        # regression
        return [
            Sample(labels=labels, value=float(val), timestamp=float(ts))
            for ts, val in series.get("values", [])
        ]


class GuardedPromAPI:
    """PromAPI behind a per-dependency CircuitBreaker (utils/backoff.py).

    While the breaker is open every query fails fast with
    CircuitOpenError instead of paying the transport timeout — the
    collector's error handling already treats any query exception as a
    PrometheusError condition, so callers need no special casing. The
    breaker is single-threaded by design: clone() returns an UNguarded
    clone of the inner client for daemon threads (their best-effort
    queries must not race the reconcile loop's breaker state).

    Every query runs inside a trace span (obs/trace.py; no-op outside a
    cycle trace) and, when an emitter is attached, feeds the
    inferno_dependency_latency_seconds histogram and the circuit-open
    fail-fast outcome of inferno_dependency_retries_total."""

    DEPENDENCY = "prometheus"

    def __init__(self, inner: PromAPI, breaker, emitter=None):
        self.inner = inner
        self.breaker = breaker
        self.emitter = emitter

    def _guarded(self, op: str, promql: str, fn):
        with obs_trace.span(f"prometheus.{op}", promql=promql[:200]):
            t0 = time.perf_counter()
            try:
                return self.breaker.call(fn)
            except CircuitOpenError:
                if self.emitter is not None:
                    self.emitter.emit_retry(self.DEPENDENCY, CIRCUIT_OPEN)
                raise
            finally:
                if self.emitter is not None:
                    self.emitter.emit_dependency_latency(
                        self.DEPENDENCY, time.perf_counter() - t0)

    def query(self, promql: str) -> list[Sample]:
        return self._guarded("query", promql,
                             lambda: self.inner.query(promql))

    def query_range(self, promql: str, start_s: float, end_s: float,
                    step_s: float,
                    series_labels: Optional[dict] = None) -> list[Sample]:
        def call():
            if series_labels is not None:
                return self.inner.query_range(promql, start_s, end_s,
                                              step_s,
                                              series_labels=series_labels)
            return self.inner.query_range(promql, start_s, end_s, step_s)

        return self._guarded("query_range", promql, call)

    def clone(self):
        clone = getattr(self.inner, "clone", None)
        return clone() if callable(clone) else self.inner


class FakePromAPI:
    """Test double keyed by exact query string (the reference's MockPromAPI
    pattern, test/utils/unitutils.go:138-243): unknown queries default to a
    single fresh sample so availability checks pass."""

    def __init__(self, default_value: float = 1.0, now=time.time):
        self.query_results: dict[str, list[Sample]] = {}
        self.query_errors: dict[str, Exception] = {}
        self.default_value = default_value
        self.queries_seen: list[str] = []
        self._now = now

    def set_result(self, promql: str, value: float, age_seconds: float = 0.0,
                   labels: dict | None = None) -> None:
        self.query_results[promql] = [
            Sample(labels=labels or {}, value=value, timestamp=self._now() - age_seconds)
        ]

    def add_result(self, promql: str, value: float, age_seconds: float = 0.0,
                   labels: dict | None = None) -> None:
        """APPEND a sample to a query's answer (grouped fleet queries
        return one sample per (model, namespace) group)."""
        self.query_results.setdefault(promql, []).append(
            Sample(labels=labels or {}, value=value,
                   timestamp=self._now() - age_seconds))

    def set_empty(self, promql: str) -> None:
        self.query_results[promql] = []

    def set_error(self, promql: str, exc: Exception) -> None:
        self.query_errors[promql] = exc

    def query(self, promql: str) -> list[Sample]:
        self.queries_seen.append(promql)
        if promql in self.query_errors:
            raise self.query_errors[promql]
        if promql in self.query_results:
            return self.query_results[promql]
        return [Sample(labels={}, value=self.default_value, timestamp=self._now())]


def validate_prometheus_api(prom: PromAPI, backoff=PROMETHEUS_BACKOFF, sleep=time.sleep) -> None:
    """Startup gate: the controller hard-fails without Prometheus
    (reference internal/utils/utils.go:390-410, cmd wiring
    variantautoscaling_controller.go:448-451)."""
    with_backoff(lambda: prom.query("up"), backoff=backoff, sleep=sleep)
