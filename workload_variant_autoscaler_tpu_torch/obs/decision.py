"""Immutable per-cycle decision records: WHY a variant got its replicas.

Every reconcile cycle, each variant's sizing decision is captured as a
`DecisionRecord`: the inputs the solve saw (arrival rate, token stats,
observed latencies, degradation rung, per-replica cost), the queueing
solve's proposed replica count, and every clamp applied on the way from
proposed to published (scale-down stabilization window, the
`WVA_MAX_REPLICA_STEP` bound, the stale-metrics scale-to-zero veto) —
each clamp with its before/after counts, so the published number is
reproducible from the record alone: `record.replay()` re-applies the
clamp chain and must land exactly on `published_replicas`.

Records are frozen dataclasses (an audit trail is append-only evidence,
never mutated after the fact) kept in a bounded `DecisionLog` ring
(`WVA_TRACE_DECISIONS` cycles' worth, default 256 records), served by
/debug/decisions (obs/debug.py) and rendered by `explain_text` (the
reference package's `controller explain` CLI; the port's process entry
point is a later slice).

Stdlib-only, no intra-repo imports (see obs/trace.py's import rule).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field, replace as _dc_replace
from typing import Callable, Optional

from .trace import _capacity_from_env

DEFAULT_DECISION_BUFFER = 256

# goodput-attribution buckets (obs/goodput.py's GoodputMeter, driven by
# both the twin and the live reconciler): where the chip-cost-seconds
# governed by this decision went. "" = not metered (no meter attached).
GOODPUT_USEFUL = "useful"
GOODPUT_UNDER = "under-provisioned"
GOODPUT_OVER = "over-provisioned"
GOODPUT_DEGRADED = "degradation-held"
GOODPUT_LAGGED = "actuation-lagged"
GOODPUT_BUCKETS = (GOODPUT_USEFUL, GOODPUT_UNDER, GOODPUT_OVER,
                   GOODPUT_DEGRADED, GOODPUT_LAGGED)

# outcome values
PUBLISHED = "published"    # a fresh allocation was published this cycle
HELD = "held"              # no usable evidence: published state frozen
LIMITED = "limited"        # optimize failed: conditions only, no new alloc

# clamp names (the actuation pipeline's guardrails, in application order)
CLAMP_STABILIZATION = "stabilization-window"
CLAMP_REPLICA_STEP = "replica-step"
CLAMP_STALE_VETO = "stale-scale-to-zero-veto"
CLAMP_TTFT_BACKPRESSURE = "ttft-backpressure"
CLAMP_DEGRADED_FREEZE = "degraded-scaleup-freeze"


@dataclass(frozen=True)
class Clamp:
    """One guardrail application: the count it saw and what it made it."""

    name: str
    before: int
    after: int
    detail: str = ""


@dataclass(frozen=True)
class DecisionInputs:
    """What the sizing saw for this variant this cycle."""

    arrival_rate_rpm: float = 0.0
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0
    avg_ttft_ms: float = 0.0
    avg_itl_ms: float = 0.0
    degradation: str = "healthy"   # ladder rung label (controller/degradation.py)
    cost_per_replica: float = 0.0
    current_replicas: int = 0
    prev_published: int = 0
    # which collection path produced the load inputs: "fleet" (demuxed
    # from the grouped fleet queries), "per-variant-repair" (labels
    # missing from the grouped result; single-variant queries) or
    # "stream" (a pushed load). "" on records predating the field.
    collection_mode: str = ""
    # how the sizing was produced (solver/incremental.py): "full" (every
    # lane re-solved — forced-full cycles and WVA_INCREMENTAL_SOLVE=off),
    # "incremental" (signature changed, this variant's lanes re-solved),
    # or "cached" (signature unchanged, cached allocations reused — the
    # kernel never saw this variant this cycle). "" on records that never
    # reached the analyze stage (held variants) or predate the field.
    solve_mode: str = ""


@dataclass(frozen=True)
class DecisionRecord:
    trace_id: str
    cycle: int
    ts: float
    variant: str
    namespace: str
    inputs: DecisionInputs
    accelerator: str = ""
    proposed_replicas: int = 0     # the queueing solve's answer, pre-clamp
    clamps: tuple[Clamp, ...] = ()
    published_replicas: int = 0
    outcome: str = PUBLISHED
    reason: str = ""               # for held/limited: why
    # per-cycle goodput attribution (GOODPUT_* buckets), stamped by the
    # fleet twin's meter AFTER the decision's interval has played out —
    # the one post-hoc annotation on the audit trail, applied by
    # wholesale record replacement (DecisionLog.annotate_goodput), never
    # by mutation. "" = unmetered.
    goodput_bucket: str = ""
    goodput_detail: str = ""

    def replay(self) -> int:
        """Re-derive the published count from the record alone: start at
        the proposed count and re-apply the clamp chain. Raises if the
        chain is inconsistent (a clamp's `before` not matching the
        running count) — an audit record that cannot reproduce its own
        answer is a bug, not a rendering detail."""
        count = self.proposed_replicas
        for clamp in self.clamps:
            if clamp.before != count:
                raise ValueError(
                    f"clamp chain broken at {clamp.name!r}: expected "
                    f"before={count}, recorded {clamp.before}")
            count = clamp.after
        return count

    def to_dict(self) -> dict:
        return asdict(self)


def record_from_dict(obj: dict) -> DecisionRecord:
    """Rebuild a record from its JSON form (the /debug/decisions payload
    or a saved dump) — the `explain` CLI's input path."""
    inputs = DecisionInputs(**(obj.get("inputs") or {}))
    clamps = tuple(Clamp(**c) for c in (obj.get("clamps") or []))
    known = {"trace_id", "cycle", "ts", "variant", "namespace",
             "accelerator", "proposed_replicas", "published_replicas",
             "outcome", "reason", "goodput_bucket", "goodput_detail"}
    kwargs = {k: v for k, v in obj.items() if k in known}
    return DecisionRecord(inputs=inputs, clamps=clamps, **kwargs)


def explain_text(record: DecisionRecord) -> str:
    """Human-readable reproduction of the published replica count from
    the record alone — the `explain` CLI's output."""
    i = record.inputs
    lines = [
        f"variant {record.variant} (namespace {record.namespace}) — "
        f"cycle {record.cycle}, trace {record.trace_id}",
        f"  outcome: {record.outcome}"
        + (f" ({record.reason})" if record.reason else ""),
        f"  degradation rung: {i.degradation}",
        *([f"  goodput: {record.goodput_bucket}"
           + (f" ({record.goodput_detail})" if record.goodput_detail
              else "")]
          if record.goodput_bucket else []),
        *([f"  collection path: {i.collection_mode}"]
          if i.collection_mode else []),
        *([f"  solve path: {i.solve_mode}"] if i.solve_mode else []),
        "  inputs:",
        f"    arrival rate:    {i.arrival_rate_rpm:.2f} req/min",
        f"    tokens in/out:   {i.avg_input_tokens:.1f} / "
        f"{i.avg_output_tokens:.1f}",
        f"    observed ttft/itl: {i.avg_ttft_ms:.2f} ms / "
        f"{i.avg_itl_ms:.2f} ms",
        f"    cost/replica:    {i.cost_per_replica:.2f}",
        f"    current replicas: {i.current_replicas}  "
        f"(previously published: {i.prev_published})",
    ]
    if record.outcome == PUBLISHED:
        lines.append(f"  queueing solve proposed: {record.proposed_replicas} "
                     f"replicas on {record.accelerator}")
        count = record.proposed_replicas
        for clamp in record.clamps:
            lines.append(f"  clamp {clamp.name}: {clamp.before} -> "
                         f"{clamp.after}"
                         + (f" ({clamp.detail})" if clamp.detail else ""))
            count = clamp.after
        if not record.clamps:
            lines.append("  no clamps applied")
        lines.append(f"  published: {count} replicas")
        if count != record.published_replicas:
            lines.append(f"  WARNING: record inconsistent — published field "
                         f"says {record.published_replicas}")
    else:
        lines.append(f"  published allocation frozen at "
                     f"{record.published_replicas} replicas")
    return "\n".join(lines)


class DecisionLog:
    """Bounded ring of DecisionRecords, newest last. Lock-guarded: the
    debug endpoint thread reads while the reconcile thread appends."""

    def __init__(self, capacity: Optional[int] = None,
                 now: Callable[[], float] = time.time):
        self.capacity = capacity or _capacity_from_env(
            "WVA_TRACE_DECISIONS", DEFAULT_DECISION_BUFFER)
        self.now = now
        self._records: deque[DecisionRecord] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(self, rec: DecisionRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def records(self, variant: str = "", namespace: str = "",
                limit: Optional[int] = None) -> list[DecisionRecord]:
        """Most-recent-first, optionally filtered by variant/namespace."""
        with self._lock:
            out = [r for r in self._records
                   if (not variant or r.variant == variant)
                   and (not namespace or r.namespace == namespace)]
        out.reverse()
        return out[:limit] if limit else out

    def latest(self, variant: str,
               namespace: str = "") -> Optional[DecisionRecord]:
        recs = self.records(variant, namespace, limit=1)
        return recs[0] if recs else None

    def snapshot(self, variant: str = "", namespace: str = "",
                 limit: Optional[int] = None) -> list[dict]:
        return [r.to_dict() for r in self.records(variant, namespace, limit)]

    def annotate_goodput(self, variant: str, namespace: str, cycle: int,
                         bucket: str, detail: str = "") -> bool:
        """Stamp a cycle's goodput attribution onto its record (the fleet
        twin meters an interval AFTER the decision that governed it was
        frozen). The record is REPLACED with an updated copy — records
        themselves stay immutable. Returns False when the cycle's record
        has already rotated out of the ring."""
        if bucket not in GOODPUT_BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r}; known: "
                             f"{list(GOODPUT_BUCKETS)}")
        with self._lock:
            for i in range(len(self._records) - 1, -1, -1):
                rec = self._records[i]
                if rec.variant == variant and rec.namespace == namespace \
                        and rec.cycle == cycle:
                    self._records[i] = _dc_replace(
                        rec, goodput_bucket=bucket, goodput_detail=detail)
                    return True
        return False


@dataclass
class DecisionBuilder:
    """Mutable per-variant scratchpad the reconciler fills as the cycle
    runs (inputs at prepare, proposal + clamps at publish), frozen into
    the immutable record at the end."""

    variant: str
    namespace: str
    inputs: DecisionInputs = field(default_factory=DecisionInputs)
    accelerator: str = ""
    proposed_replicas: int = 0
    clamps: list[Clamp] = field(default_factory=list)
    published_replicas: int = 0
    outcome: str = PUBLISHED
    reason: str = ""

    def clamp(self, name: str, before: int, after: int,
              detail: str = "") -> None:
        if before != after:
            self.clamps.append(Clamp(name, before, after, detail))

    def freeze(self, trace_id: str, cycle: int, ts: float) -> DecisionRecord:
        return DecisionRecord(
            trace_id=trace_id, cycle=cycle, ts=ts,
            variant=self.variant, namespace=self.namespace,
            inputs=self.inputs, accelerator=self.accelerator,
            proposed_replicas=self.proposed_replicas,
            clamps=tuple(self.clamps),
            published_replicas=self.published_replicas,
            outcome=self.outcome, reason=self.reason,
        )
