"""Injection hooks: apply a FaultPlan to live dependency calls.

Two mechanisms, one plan:

- `FaultyPromAPI` wraps ANY PromAPI (FakePromAPI, SimPromAPI, HTTPPromAPI)
  and corrupts/withholds answers per the plan. SimPromAPI also accepts
  `fault_plan=` directly (emulator/simprom.py) — same helper underneath.
- Kube faults are consulted inside InMemoryKube itself
  (`attach_fault_plan`, controller/kube.py): every verb passes through
  `_trip`, so plan-scheduled 409 storms / NotFound windows hit exactly
  where count-based `inject_fault` always has, and watch-drop windows
  swallow `_notify` events like a dropped ?watch=true stream.

`exception_for_kube_fault` is the single mapping from a scheduled kube
fault kind to the exception a real apiserver client would surface, so the
in-memory hook and any future RestKube-level wrapper cannot diverge.

Streaming-ingest faults (stream-flood / stream-corrupt-payload /
stream-clock-skew) are consulted by the harness that FEEDS the stream
(the twin's push_loads tick, the chaos tests' senders) rather than by
the core itself — the point is to batter the real door from outside, so
the shedding/quarantine defenses under test stay byte-identical to
production. `stream_flood_multiplier`, `corrupt_stream_body`, and
`skew_stream_timestamp` are those senders' single source of truth.
"""

from __future__ import annotations

import math
import random
import zlib

from ..collector.prometheus import PromAPI, Sample
from ..obs.trace import add_event
from . import plan as plan_mod
from .plan import FaultPlan, FaultRule


class InjectedTimeout(TimeoutError):
    """The scheduled Prometheus timeout (transport-level failure)."""


class InjectedKubeError(RuntimeError):
    """The scheduled generic kube transport failure."""


def exception_for_kube_fault(rule: FaultRule, verb: str,
                             kind: str) -> Exception:
    """The exception a real client surfaces for this fault kind."""
    from ..controller.kube import ConflictError, NotFoundError

    if rule.kind == plan_mod.KUBE_CONFLICT:
        return ConflictError(
            f"injected 409: {verb} {kind} lost a write race")
    if rule.kind == plan_mod.KUBE_NOT_FOUND:
        return NotFoundError(f"injected 404: {kind} vanished during {verb}")
    return InjectedKubeError(f"injected apiserver failure on {verb} {kind}")


def apply_prom_fault(plan: FaultPlan | None, promql: str,
                     samples: list[Sample]) -> list[Sample]:
    """Corrupt/withhold a query answer per the plan (shared by
    FaultyPromAPI and SimPromAPI's built-in hook). Raises on
    prom-timeout; returns the (possibly corrupted) samples otherwise."""
    if plan is None:
        return samples
    rule = plan.prom_fault(promql)
    if rule is None:
        return samples
    # a chaos run's trace must SHOW the scheduled fault, not just its
    # downstream symptoms (no-op outside an active cycle trace)
    add_event("fault-injected", dependency=plan_mod.DEP_PROMETHEUS,
              kind=rule.kind, match=rule.match, query=promql[:120])
    if rule.kind in (plan_mod.PROM_TIMEOUT, plan_mod.PROM_OUTAGE):
        # prom-outage-window is a correlated hard outage: the shared
        # window covers every query of every backend holding this plan,
        # so the whole fleet goes blind and recovers together
        raise InjectedTimeout(
            f"injected prometheus timeout for {promql[:80]!r}")
    if rule.kind == plan_mod.PROM_PARTIAL:
        return []  # series dropped from the scrape: empty vector
    if rule.kind == plan_mod.PROM_LABEL_DROP:
        # one variant's series vanish from the answer (its exporter died
        # mid-scrape) while the rest of a grouped vector stays intact
        want = rule.labels or {}
        return [s for s in samples
                if not all(s.labels.get(k) == v for k, v in want.items())]
    if rule.kind == plan_mod.PROM_NAN:
        if not samples:
            # the series must EXIST to carry a NaN (PromQL 0/0)
            samples = [Sample(labels={}, value=0.0, timestamp=plan.now_s)]
        return [Sample(labels=s.labels, value=math.nan,
                       timestamp=s.timestamp) for s in samples]
    # prom-clock-skew: the scrape pipeline lags — every sample's
    # timestamp slides into the past, which the staleness gate must read
    # as a broken scrape, not as fresh truth
    return [Sample(labels=s.labels, value=s.value,
                   timestamp=s.timestamp - rule.skew_s) for s in samples]


def stream_flood_multiplier(plan: FaultPlan | None, model: str,
                            ns: str) -> int:
    """How many times the sender should replay this group's push right
    now (1 = no flood). The multiplier rides the rule's labels
    ({"multiplier": N}, default 100) so one rule describes the whole
    flash crowd."""
    if plan is None:
        return 1
    rule = plan.stream_fault(plan_mod.STREAM_FLOOD, f"{model}:{ns}")
    if rule is None:
        return 1
    add_event("fault-injected", dependency=plan_mod.DEP_STREAM,
              kind=rule.kind, match=rule.match, target=f"{model}:{ns}")
    return rule.multiplier()


def corrupt_stream_body(plan: FaultPlan | None, body: bytes) -> bytes:
    """Shred a remote-write body per an active stream-corrupt-payload
    window: seeded bit flips (plus a guaranteed non-empty result, so an
    empty body still arrives broken). Deterministic per (plan.seed,
    body) — byte-identical chaos reruns are a suite invariant."""
    if plan is None:
        return body
    rule = plan.stream_fault(plan_mod.STREAM_CORRUPT)
    if rule is None:
        return body
    add_event("fault-injected", dependency=plan_mod.DEP_STREAM,
              kind=rule.kind, match=rule.match, bytes=len(body))
    rng = random.Random(
        ((plan.seed * 1_000_003) ^ zlib.crc32(body)) & 0xFFFFFFFF)
    out = bytearray(body or b"\x00")
    for _ in range(max(1, len(out) // 64)):
        out[rng.randrange(len(out))] ^= 1 << rng.randrange(8)
    return bytes(out)


def skew_stream_timestamp(plan: FaultPlan | None, model: str, ns: str,
                          ts_ms: float) -> float:
    """Shift a streamed sample timestamp `skew_s` into the FUTURE per an
    active stream-clock-skew window (a pushing ingester with a broken
    clock; the quarantine vet must refuse it, where prom-clock-skew's
    past shift tests the staleness gate instead)."""
    if plan is None:
        return ts_ms
    rule = plan.stream_fault(plan_mod.STREAM_CLOCK_SKEW, f"{model}:{ns}")
    if rule is None:
        return ts_ms
    add_event("fault-injected", dependency=plan_mod.DEP_STREAM,
              kind=rule.kind, match=rule.match, target=f"{model}:{ns}")
    return ts_ms + rule.skew_s * 1000.0


class FaultyPromAPI:
    """PromAPI wrapper consulting a FaultPlan on every query.

    Forwards query_range too (corrupting each step's samples) so the
    profile fitter path is injectable, and clone() (the reconciler's
    demand-probe thread) clones the inner client while SHARING the plan —
    a fault window covers every consumer of the dependency at once."""

    def __init__(self, inner: PromAPI, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def query(self, promql: str) -> list[Sample]:
        return apply_prom_fault(self.plan, promql, self.inner.query(promql))

    def query_range(self, promql: str, start_s: float, end_s: float,
                    step_s: float) -> list[Sample]:
        samples = self.inner.query_range(promql, start_s, end_s, step_s)
        return apply_prom_fault(self.plan, promql, samples)

    def clone(self) -> "FaultyPromAPI":
        clone = getattr(self.inner, "clone", None)
        return FaultyPromAPI(clone() if callable(clone) else self.inner,
                             self.plan)
