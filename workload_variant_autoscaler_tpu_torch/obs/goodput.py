"""GoodputMeter: sim/live-agnostic goodput & badput attribution.

The fleet-efficiency metric of "ML Fleet Efficiency with ML
Productivity Goodput" (PAPERS.md, arxiv 2502.06982):

    goodput = SLO-attained demand-seconds served
              ---------------------------------------
              chip-cost-seconds provisioned

decomposed tick by tick into badput buckets over the provisioned cost
(`useful`, `under-provisioned`, `over-provisioned`, `degradation-held`,
`actuation-lagged` — the GOODPUT_* vocabulary in `obs.decision`). The
meter was born inside the digital twin (`emulator/twin.py`); this
module is the extraction that lets the RUNNING controller score itself
with the exact same arithmetic:

- the twin drives `tick()` from ground-truth sim demand and emulated
  TTFT completions, one sim tick at a time;
- the live Reconciler drives `tick()` once per reconcile cycle from
  the loads/TTFT it observed, and `observe_cycle()` from what it just
  published — same class, same float-op order, so a scenario run with
  both attached produces IDENTICAL per-tick ledgers (pinned by
  `make goodput-live-smoke`).

The judging rule per tick: a variant is SLO-attained when its
provisioned replicas cover the replicas its own PUBLISHED capacity
envelope (`Reconciler.capacity_envelopes`) says the demand needs, AND
the observed TTFT of completions in the tick stays within the SLO — a
solver that under-sizes shows up empirically even if its envelope
claims health. Mis-provisioned cost is attributed to WHY the
controller was wrong: a degraded evidence rung bills degradation-held;
a correct decision still inside actuation lag bills actuation-lagged;
everything else is under-provisioned. Surplus on a healthy rung is
over-provisioned.

Ticks also feed a rolling window ring (`window_s`) so the live surface
(`/debug/goodput`, `controller goodput`, `inferno_goodput_fraction`)
answers "how useful was the fleet's spend lately", not only
since-boot. `flush()` stamps each reconcile interval's dominant badput
bucket onto that cycle's DecisionRecords through
`DecisionLog.annotate_goodput`, so `controller explain` answers "why
did cycle N lose goodput" from the audit trail alone.

Stdlib-only, like the rest of `obs/` — usable from the twin, the
controller, and offline analysis without dragging either's deps.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .decision import (
    GOODPUT_DEGRADED,
    GOODPUT_LAGGED,
    GOODPUT_OVER,
    GOODPUT_UNDER,
    GOODPUT_USEFUL,
)

# The degradation ladder's integer rungs, mirrored from
# controller.degradation.DegradationState (obs/ is stdlib-only and
# imports nothing outside the package; tests/test_goodput.py pins the
# alignment so the mirror cannot rot).
RUNG_HEALTHY = 0
RUNG_STREAM_DEGRADED = 1
RUNG_STALE_CACHE = 2
RUNG_LIMITED = 3
RUNG_HOLD = 4

RUNG_LABELS = {
    RUNG_HEALTHY: "healthy",
    RUNG_STREAM_DEGRADED: "stream-degraded",
    RUNG_STALE_CACHE: "stale-cache",
    RUNG_LIMITED: "limited",
    RUNG_HOLD: "hold",
}

# rungs whose mis-provision is charged to `degradation-held` (the
# controller flew on degraded EVIDENCE). `limited` deliberately stays
# out: an optimizer that cannot fit withdrawn capacity is
# capacity-bound, and its SLO misses read as `under-provisioned` — the
# bucket that answers "buy more chips", not "fix the telemetry".
# `stream-degraded` (the shed/lag-pressure rung PR 12 added) is in: a
# cycle sized while the ingest door was shedding flew on partial
# evidence, and charging its misses to under-provision/actuation-lag
# would mis-answer "buy more chips" for what is a telemetry storm
DEGRADED_RUNGS = ("stream-degraded", "stale-cache", "hold")

# rungs where a published ZERO is the stale-flap failure the guardrail
# forbids. Narrower than DEGRADED_RUNGS on purpose: stream-degraded
# cycles size on FRESH (admitted) pushes — a zero there is a sizing
# decision to judge by its badput, not a flap on absent evidence
STALE_ZERO_RUNGS = ("stale-cache", "hold")

DEGRADED_RUNG_INTS = frozenset(
    v for v, label in RUNG_LABELS.items() if label in DEGRADED_RUNGS)
STALE_ZERO_RUNG_INTS = frozenset(
    v for v, label in RUNG_LABELS.items() if label in STALE_ZERO_RUNGS)

# min_desired_after_publish sentinel: "never published a count yet"
UNPUBLISHED = 10**9


@dataclass(frozen=True)
class TickSample:
    """One variant's ground truth for one metering tick: the demand it
    faced, the TTFTs of completions inside the tick window, the
    replicas that billed, and (limited-mode only) the most replicas its
    generation pool could currently host."""

    demand_rps: float
    ttft_ms: tuple = ()
    replicas: int = 0
    pool_limit: Optional[int] = None


@dataclass
class VariantLedger:
    """One variant's goodput accounting + the published-state mirror
    the judging rule needs (envelope rate, desired count, rung).
    All cost accumulators are in "dollar-seconds" of provisioned
    cost; `interval_buckets` is the per-reconcile-interval slice,
    flushed into DecisionRecord annotations at each cycle boundary."""

    name: str
    namespace: str
    model: str = ""
    price_per_hour: float = 0.0
    slo_ttft_ms: float = 0.0
    # published-state mirror, maintained by observe_cycle()
    desired: int = 0            # last published replica count
    r_star: float = 0.0         # SLO-feasible req/s per replica (envelope)
    rung: int = RUNG_HEALTHY    # degradation rung governing the interval
    published_once: bool = False
    min_desired_after_publish: int = UNPUBLISHED
    scaled_to_zero_on_stale: bool = False
    # accumulators
    cost_s: float = 0.0
    demand_s: float = 0.0       # integral of ground-truth demand (req)
    slo_demand_s: float = 0.0   # the SLO-attained part of it
    buckets: dict = field(default_factory=dict)
    interval_buckets: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.name}:{self.namespace}"

    def add(self, bucket: str, cost: float) -> None:
        if cost <= 0.0:
            return
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + cost
        self.interval_buckets[bucket] = \
            self.interval_buckets.get(bucket, 0.0) + cost


class GoodputMeter:
    """The shared meter. Lifecycle per variant:

    1. `register()` once (idempotent metadata refresh) with the price
       and the TTFT SLO;
    2. `observe_cycle()` after every reconcile with what was published
       (desired counts + capacity envelopes + degradation rungs) — this
       maintains the mirror the judging rule reads;
    3. `tick()` with each interval's observed demand/TTFT/replicas —
       this is where cost lands in buckets;
    4. `flush()` at each cycle boundary to annotate the ended cycle's
       DecisionRecords and drain the interval buckets.

    A variant bills nothing until it has BOTH a published count and a
    positive envelope (warmup: nothing published to judge yet).
    """

    def __init__(self, window_s: float = 900.0) -> None:
        self.window_s = float(window_s)
        self._ledgers: dict[str, VariantLedger] = {}
        self._ticks: deque = deque()

    # ------------------------------------------------------------------
    # registration & access

    def register(self, name: str, namespace: str, *,
                 price_per_hour: float, slo_ttft_ms: float,
                 model: str = "") -> VariantLedger:
        """Create-or-refresh a variant's ledger. Refreshing updates the
        pricing/SLO metadata only — accounting never resets, so a live
        controller re-reading its ConfigMaps each cycle keeps one
        continuous ledger per variant."""
        key = f"{name}:{namespace}"
        led = self._ledgers.get(key)
        if led is None:
            led = VariantLedger(name=name, namespace=namespace)
            self._ledgers[key] = led
        if model:
            led.model = model
        led.price_per_hour = price_per_hour
        led.slo_ttft_ms = slo_ttft_ms
        return led

    def variant(self, name: str,
                namespace: Optional[str] = None) -> Optional[VariantLedger]:
        key = name if namespace is None else f"{name}:{namespace}"
        return self._ledgers.get(key)

    def variants(self) -> list[VariantLedger]:
        return list(self._ledgers.values())

    # ------------------------------------------------------------------
    # the metering core (the twin's arithmetic, verbatim)

    def tick(self, now_s: float, tick_s: float,
             samples: dict[str, TickSample]) -> None:
        """Bill one tick window. `samples` is keyed like the ledgers
        ("name:namespace"); a variant without a sample is skipped (it
        neither bills nor accrues demand this tick)."""
        tick_cost = 0.0
        tick_demand = 0.0
        tick_slo = 0.0
        tick_buckets: dict[str, float] = {}

        def put(led: VariantLedger, bucket: str, cost: float) -> None:
            if cost <= 0.0:
                return
            led.add(bucket, cost)
            tick_buckets[bucket] = tick_buckets.get(bucket, 0.0) + cost

        for key, led in self._ledgers.items():
            sample = samples.get(key)
            if sample is None:
                continue
            d = sample.demand_rps
            ttfts = sample.ttft_ms
            if not led.published_once or led.r_star <= 0.0:
                continue    # warmup: nothing published to judge yet
            n = sample.replicas
            price_s = led.price_per_hour / 3600.0
            cost = n * price_s * tick_s
            led.cost_s += cost
            tick_cost += cost
            if d > 0.0:
                led.demand_s += d * tick_s
                tick_demand += d * tick_s
            n_req = int(math.ceil(d / led.r_star)) if d > 0.0 else 0
            limit = sample.pool_limit
            latency_ok = (not ttfts or
                          sum(ttfts) / len(ttfts) <= led.slo_ttft_ms)
            if n >= n_req and latency_ok:
                if d > 0.0:
                    led.slo_demand_s += d * tick_s
                    tick_slo += d * tick_s
                put(led, GOODPUT_USEFUL, min(n, n_req) * price_s * tick_s)
                surplus = (n - n_req) * price_s * tick_s
                put(led, GOODPUT_DEGRADED if led.rung in DEGRADED_RUNG_INTS
                    else GOODPUT_OVER, surplus)
            else:
                # the whole provisioned cost served SLO-violating load:
                # attribute it to WHY the controller was wrong
                if led.rung in DEGRADED_RUNG_INTS:
                    bucket = GOODPUT_DEGRADED
                elif (n < n_req <= led.desired
                        and (limit is None or limit >= n_req)):
                    # the published decision was right and the pool could
                    # host it — pods were simply still starting. A pool
                    # that CANNOT host the right count is withdrawn
                    # capacity: under-provisioned, not lag
                    bucket = GOODPUT_LAGGED
                else:
                    bucket = GOODPUT_UNDER
                put(led, bucket, cost)

        self._ticks.append({"t": now_s, "cost": tick_cost,
                            "demand": tick_demand, "slo_demand": tick_slo,
                            "buckets": tick_buckets})
        horizon = now_s - self.window_s
        while self._ticks and self._ticks[0]["t"] < horizon:
            self._ticks.popleft()

    def observe_cycle(self, *, published: dict[str, int],
                      envelopes: dict[str, float],
                      rungs: dict[str, int],
                      cycle_rung: int = RUNG_HEALTHY) -> None:
        """Fold one reconcile's outcome into the judging mirror.
        `published` maps variant key -> the replica count the cycle
        wrote to status (variants the cycle did not decide are simply
        absent and keep their mirror); `envelopes` is
        `Reconciler.capacity_envelopes()`; `rungs` the per-variant
        degradation rungs; `cycle_rung` floors every variant's rung (a
        cycle that went limited or died into hold governs the whole
        interval even though no per-variant entry exists)."""
        for key, led in self._ledgers.items():
            led.rung = max(rungs.get(key, RUNG_HEALTHY), cycle_rung)
            if key not in published:
                continue
            desired = published[key]
            if desired > 0:
                led.desired = desired
                led.published_once = True
                led.min_desired_after_publish = min(
                    led.min_desired_after_publish, desired)
                cap = envelopes.get(key, 0.0)
                if cap > 0.0:
                    led.r_star = cap / desired
            elif led.published_once:
                # a published variant dropping to zero on a degraded rung
                # is the exact failure the stale-veto guardrail forbids
                if led.rung in STALE_ZERO_RUNG_INTS:
                    led.scaled_to_zero_on_stale = True
                led.min_desired_after_publish = 0

    def flush(self, ended_cycle: int,
              annotate: Optional[Callable] = None) -> dict[str, float]:
        """Drain every variant's interval buckets, stamping the ended
        cycle's dominant badput bucket onto its DecisionRecords via
        `annotate` (the `DecisionLog.annotate_goodput` signature).
        Returns the drained per-bucket cost totals across variants —
        the exact increment for `inferno_badput_cost_seconds_total`."""
        totals: dict[str, float] = {}
        for led in self._ledgers.values():
            buckets = led.interval_buckets
            led.interval_buckets = {}
            for b, c in buckets.items():
                totals[b] = totals.get(b, 0.0) + c
            if not buckets or ended_cycle <= 0:
                continue
            total = sum(buckets.values())
            badput = {b: c for b, c in buckets.items()
                      if b != GOODPUT_USEFUL}
            if badput and max(badput.values()) > 0.0:
                bucket = max(sorted(badput), key=lambda b: badput[b])
                share = badput[bucket] / total if total > 0 else 0.0
            else:
                bucket, share = GOODPUT_USEFUL, 1.0
            if annotate is not None:
                annotate(led.name, led.namespace, ended_cycle, bucket,
                         detail=f"{share:.0%} of {total:.4f} "
                                "$·s interval cost")
        return totals

    # ------------------------------------------------------------------
    # the read surface (rolling window)

    def ledger(self, window_s: Optional[float] = None) -> list[dict]:
        """The retained per-tick entries, oldest first — optionally
        re-clipped to the trailing `window_s` of the newest tick."""
        entries: Iterable[dict] = self._ticks
        if window_s is not None and self._ticks:
            horizon = self._ticks[-1]["t"] - window_s
            entries = (e for e in self._ticks if e["t"] >= horizon)
        return [dict(e, buckets=dict(e["buckets"])) for e in entries]

    def summary(self, window_s: Optional[float] = None) -> dict:
        """Windowed headline numbers: goodput fraction, attainment, and
        badput fractions over the retained (or re-clipped) ticks."""
        entries = self.ledger(window_s)
        cost = sum(e["cost"] for e in entries)
        demand = sum(e["demand"] for e in entries)
        slo_demand = sum(e["slo_demand"] for e in entries)
        buckets: dict[str, float] = {}
        for e in entries:
            for b, c in e["buckets"].items():
                buckets[b] = buckets.get(b, 0.0) + c
        useful = buckets.get(GOODPUT_USEFUL, 0.0)
        return {
            "window_s": self.window_s if window_s is None else window_s,
            "ticks": len(entries),
            "variants": len(self._ledgers),
            "cost_dollar_seconds": cost,
            "demand_seconds": demand,
            "slo_demand_seconds": slo_demand,
            "goodput_fraction": useful / cost if cost > 0.0 else 0.0,
            "slo_attainment": slo_demand / demand if demand > 0.0 else 1.0,
            "badput": ({b: c / cost for b, c in sorted(buckets.items())
                        if b != GOODPUT_USEFUL} if cost > 0.0 else {}),
        }

    def attainment_by_model(self) -> dict[tuple, float]:
        """Lifetime SLO attainment per (model, namespace) — the export
        shape of `inferno_slo_attainment_ratio`. Variants without a
        model id fall back to the variant name."""
        agg: dict[tuple, list] = {}
        for led in self._ledgers.values():
            pair = agg.setdefault((led.model or led.name, led.namespace),
                                  [0.0, 0.0])
            pair[0] += led.demand_s
            pair[1] += led.slo_demand_s
        return {k: (s / d if d > 0.0 else 1.0)
                for k, (d, s) in agg.items()}
