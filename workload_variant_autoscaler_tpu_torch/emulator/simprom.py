"""Sim-time Prometheus: answers the collector's queries from emulator
counters.

Plays the role of a real Prometheus server in the GPU/TPU-free closed loop
(the reference gets this from an actual in-cluster Prometheus scraping the
emulator; here the whole loop runs in simulated time). It snapshots the
emulator's cumulative counters on every scrape tick and evaluates the five
aggregate queries the collector issues — sum(rate(x[1m])) and
sum(rate(a))/sum(rate(b)) ratios — over the sim clock.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import deque

from ..collector import (
    MetricFamily,
    arrival_rate_query,
    avg_running_query,
    avg_waiting_query,
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
from ..collector.prometheus import Sample
from .metrics import PrometheusSink

RATE_WINDOW_S = 60.0


class SimPromAPI:
    """PromAPI over a snapshot history of PrometheusSink counters.

    Speaks whichever metric dialect the sink exports (the family defaults
    to the SINK's dialect, so the exported series and the answered queries
    agree by construction — not to the env selection, which describes the
    collector side and may differ in a mismatch test). For a dialect
    without an admission counter the demand query is evaluated the way a
    real Prometheus would: completion rate + clamped backlog derivative."""

    def __init__(self, sink: PrometheusSink, model: str, namespace: str,
                 family: MetricFamily | None = None, fault_plan=None):
        from ..collector import METRIC_FAMILIES

        self.sink = sink
        self.model = model
        self.namespace = namespace
        self.family = family or METRIC_FAMILIES[sink.family]
        self.history: deque[tuple[float, dict[str, float]]] = deque(maxlen=4096)
        self.now_s = 0.0
        # scheduled Prometheus misbehavior (faults.FaultPlan): every
        # answer passes through apply_prom_fault, and scrape() ticks the
        # plan's time axis with the sim clock — the same plan JSON the
        # chaos unit suite runs drives the closed loop
        self.fault_plan = fault_plan
        self._queries: dict[str, tuple] = {}
        self._register_queries()

    def _register_queries(self) -> None:
        m, ns, fam = self.model, self.namespace, self.family
        if fam.arrival_total is not None:
            demand = ("rate", fam.arrival_total)
        else:
            demand = ("demand", (fam.success_total, fam.queue_depth))
        self._queries = {
            true_arrival_rate_query(m, ns, fam): demand,
            arrival_rate_query(m, ns, fam): ("rate", fam.success_total),
            avg_prompt_tokens_query(m, ns, fam): (
                "ratio", (f"{fam.prompt_tokens}_sum",
                          f"{fam.prompt_tokens}_count")),
            avg_generation_tokens_query(m, ns, fam): (
                "ratio", (f"{fam.generation_tokens}_sum",
                          f"{fam.generation_tokens}_count")),
            avg_ttft_query(m, ns, fam): (
                "ratio", (f"{fam.ttft_seconds}_sum",
                          f"{fam.ttft_seconds}_count")),
            avg_itl_query(m, ns, fam): (
                "ratio", (f"{fam.tpot_seconds}_sum",
                          f"{fam.tpot_seconds}_count")),
        }
        # short-window demand variants (the controller's demand-breakout
        # probe queries with WVA_FAST_PROBE_WINDOW) are resolved
        # DYNAMICALLY in _eval by parsing the window out of the incoming
        # PromQL — any configured window just works; a whitelist here
        # would silently neuter unlisted windows (probe never kicks,
        # sizing falls back to 1m, no error)
        self._demand = demand
        if fam.running:
            self._queries[avg_running_query(m, ns, fam)] = ("avg", fam.running)
        if fam.queue_depth:
            self._queries[avg_waiting_query(m, ns, fam)] = (
                "avg", fam.queue_depth)
        # grouped fleet queries (collector.FleetLoadCollector): a
        # single-variant backend IS one (model, namespace) group, so the
        # fleet-wide aggregate evaluates to the same value as the
        # per-variant query — just answered under the grouped PromQL
        # string, with the demux labels on the sample. MultiPromAPI
        # concatenates the per-backend groups into the full fleet vector
        # exactly like one Prometheus TSDB would.
        self._queries[fleet_true_arrival_rate_query(fam)] = demand
        self._queries[fleet_arrival_rate_query(fam)] = (
            "rate", fam.success_total)
        self._queries[fleet_avg_prompt_tokens_query(fam)] = (
            "ratio", (f"{fam.prompt_tokens}_sum",
                      f"{fam.prompt_tokens}_count"))
        self._queries[fleet_avg_generation_tokens_query(fam)] = (
            "ratio", (f"{fam.generation_tokens}_sum",
                      f"{fam.generation_tokens}_count"))
        self._queries[fleet_avg_ttft_query(fam)] = (
            "ratio", (f"{fam.ttft_seconds}_sum",
                      f"{fam.ttft_seconds}_count"))
        self._queries[fleet_avg_itl_query(fam)] = (
            "ratio", (f"{fam.tpot_seconds}_sum",
                      f"{fam.tpot_seconds}_count"))

    # -- driven by the simulation ---------------------------------------

    def scrape(self, now_ms: float) -> None:
        self.now_s = now_ms / 1000.0
        if self.fault_plan is not None:
            self.fault_plan.tick(self.now_s)
        self.history.append((self.now_s, self.sink.counters()))

    def _faulted(self, promql: str, samples: list[Sample]) -> list[Sample]:
        if self.fault_plan is None:
            return samples
        from ..faults.inject import apply_prom_fault

        return apply_prom_fault(self.fault_plan, promql, samples)

    # -- PromAPI ---------------------------------------------------------

    def _present(self, series: str) -> bool:
        """A series 'exists' once the emulator has ever emitted it — like a
        real Prometheus, where rate() over an absent series returns an
        empty vector, not zero."""
        return bool(self.history) and series in self.history[-1][1]

    def _window(self, as_of: float | None = None,
                times: list[float] | None = None,
                window_s: float = RATE_WINDOW_S):
        """(t_now, latest, t_old, oldest) for the rate window ending at
        `as_of` (default: the newest scrape) — historical evaluation is
        what query_range replays. `times` lets range evaluation hoist the
        timestamp list instead of rebuilding it O(history) per step (the
        handler runs synchronously on the emulator's event loop)."""
        if len(self.history) < 2:
            return None
        if times is None:
            times = [t for t, _ in self.history]
        if as_of is None:
            j = len(self.history) - 1
        else:
            j = bisect_right(times, as_of) - 1
            if j < 1:
                return None
        t_now, latest = self.history[j]
        t_start = t_now - window_s
        i = max(bisect_left(times, t_start, 0, j) - 1, 0)
        t_old, oldest = self.history[i]
        if t_now <= t_old:
            return None
        return t_now, latest, t_old, oldest

    def _rate(self, series: str, as_of: float | None = None,
              times: list[float] | None = None,
              window_s: float = RATE_WINDOW_S) -> float:
        w = self._window(as_of, times, window_s)
        if w is None:
            return 0.0
        t_now, latest, t_old, oldest = w
        return max(latest.get(series, 0.0) - oldest.get(series, 0.0), 0.0) / (
            t_now - t_old
        )

    def _deriv(self, series: str, as_of: float | None = None,
               times: list[float] | None = None,
               window_s: float = RATE_WINDOW_S) -> float:
        """PromQL deriv(): per-second slope of a gauge over the window
        (signed — a draining backlog derives negative)."""
        w = self._window(as_of, times, window_s)
        if w is None:
            return 0.0
        t_now, latest, t_old, oldest = w
        return (latest.get(series, 0.0) - oldest.get(series, 0.0)) / (
            t_now - t_old
        )

    def _avg(self, series: str, as_of: float | None = None,
             times: list[float] | None = None) -> float | None:
        """PromQL avg_over_time() on a gauge: mean of the snapshots inside
        the window. None when no snapshot exists there — a timestamp
        before history began must read 'no data', never a fabricated
        value from some other point in time."""
        w = self._window(as_of, times)
        if w is None:
            return None
        t_now = w[0]
        if times is None:
            times = [t for t, _ in self.history]
        # bisect the window bounds instead of rescanning all snapshots
        # (this runs per range step on the emulator's event loop)
        lo = bisect_right(times, t_now - RATE_WINDOW_S)
        hi = bisect_right(times, t_now)
        if hi <= lo:
            return None
        vals = [self.history[i][1].get(series, 0.0) for i in range(lo, hi)]
        return sum(vals) / len(vals)

    def _eval(self, promql: str, as_of: float | None = None,
              times: list[float] | None = None):
        """Value of a registered query at a point in (scrape) time; None =
        series absent (empty vector)."""
        spec = self._queries.get(promql)
        if spec is None:
            spec = self._resolve_short_window(promql)
        if spec is None:
            return None
        kind, payload = spec
        if kind == "rate":
            if not self._present(payload):
                return None
            return self._rate(payload, as_of, times)
        if kind == "avg":
            if not self._present(payload):
                return None
            return self._avg(payload, as_of, times)
        if kind == "demand":
            success, queue = payload
            if not self._present(success):
                return None
            return self._rate(success, as_of, times) + max(
                self._deriv(queue, as_of, times)
                if self._present(queue) else 0.0,
                0.0)
        if kind == "rate_w":
            series, w_s = payload
            if not self._present(series):
                return None
            return self._rate(series, as_of, times, window_s=w_s)
        if kind == "demand_w":
            (success, queue), w_s = payload
            if not self._present(success):
                return None
            return self._rate(success, as_of, times, window_s=w_s) + max(
                self._deriv(queue, as_of, times, window_s=w_s)
                if self._present(queue) else 0.0,
                0.0)
        num, den = payload
        if not (self._present(num) and self._present(den)):
            return None
        den_rate = self._rate(den, as_of, times)
        # 0/0 is NaN in PromQL: both series exist but nothing completed in
        # the window — 'unknown', which the collector must not read as 0
        return (self._rate(num, as_of, times) / den_rate if den_rate > 0
                else float("nan"))

    _WINDOW_RE = None  # compiled lazily (class-level cache)

    def _resolve_short_window(self, promql: str):
        """Match a demand query over an ARBITRARY rate window: parse the
        window out of the incoming PromQL, re-render the canonical
        demand query with it, and compare. Whatever
        WVA_FAST_PROBE_WINDOW a scenario configures is answered with
        the same semantics as the 1m demand query, just over the
        shorter window. The resolution is cached in _queries."""
        import re

        if SimPromAPI._WINDOW_RE is None:
            SimPromAPI._WINDOW_RE = re.compile(r"\[(\d+)(ms|s|m|h)\]")
        m = SimPromAPI._WINDOW_RE.search(promql)
        if not m:
            return None
        w_str = m.group(1) + m.group(2)
        if promql not in (
            true_arrival_rate_query(self.model, self.namespace, self.family,
                                    window=w_str),
            fleet_true_arrival_rate_query(self.family, window=w_str),
        ):
            return None
        w_s = float(m.group(1)) * {"ms": 0.001, "s": 1.0,
                                   "m": 60.0, "h": 3600.0}[m.group(2)]
        d_kind, d_payload = self._demand
        spec = (d_kind + "_w", (d_payload, w_s))
        self._queries[promql] = spec
        return spec

    def query(self, promql: str) -> list[Sample]:
        labels = {"model_name": self.model, "namespace": self.namespace}
        if promql == "up":
            return [Sample(labels={}, value=1.0, timestamp=self.now_s)]
        if promql in (
            availability_query(self.model, self.namespace, self.family),
            availability_query(self.model, family=self.family),
            fleet_availability_query(self.family),
        ):
            if not self.history:
                return []
            return self._faulted(promql, [
                Sample(labels=labels,
                       value=self.history[-1][1].get(
                           self.family.success_total, 0.0),
                       timestamp=self.now_s)])
        value = self._eval(promql)
        if value is None:
            return self._faulted(promql, [])
        return self._faulted(
            promql, [Sample(labels=labels, value=value, timestamp=self.now_s)])

    def query_range(self, promql: str, start_s: float, end_s: float,
                    step_s: float) -> list[Sample]:
        """Evaluate a registered query at each step over the scrape
        history (the /api/v1/query_range the profile fitter feeds on)."""
        labels = {"model_name": self.model, "namespace": self.namespace}
        times = [t for t, _ in self.history]  # hoisted: O(history) once
        out: list[Sample] = []
        t = start_s
        while t <= end_s + 1e-9:
            value = self._eval(promql, as_of=t, times=times)
            if value is not None:
                out.append(Sample(labels=labels, value=value, timestamp=t))
            t += step_s
        return self._faulted(promql, out)


class MultiPromAPI:
    """One Prometheus over several emulated variants (multi-model closed
    loops, BASELINE configs 2/5): each backend answers only its own
    model's queries, so dispatch is concatenation — exactly how a real
    Prometheus serves per-model aggregations from one TSDB."""

    def __init__(self, backends: list[SimPromAPI]):
        if not backends:
            raise ValueError("MultiPromAPI needs at least one backend")
        keys = [(b.model, b.namespace) for b in backends]
        if len(set(keys)) != len(keys):
            # two backends for one (model, ns) would both answer that
            # model's queries and silently double-count its rates
            raise ValueError(f"duplicate (model, namespace) backends: {keys}")
        self.backends = list(backends)

    def scrape(self, now_ms: float) -> None:
        for b in self.backends:
            b.scrape(now_ms)

    def query(self, promql: str) -> list[Sample]:
        if promql == "up":
            return self.backends[0].query(promql)
        out: list[Sample] = []
        for b in self.backends:
            out.extend(b.query(promql))
        return out
