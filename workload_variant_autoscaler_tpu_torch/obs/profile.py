"""Per-cycle wall-clock attribution ledger: where did the cycle go.

The span tracer (obs/trace.py) records WHAT a cycle did; this module
answers WHERE THE TIME WENT, exactly. Each finished cycle trace is
folded into a `ProfileRecord` whose `buckets` dict partitions the
cycle's wall time — every millisecond lands in exactly one bucket:

- `stage:<name>`     Python orchestration inside that stage not covered
                     by any child span (per-variant loops, dict-shaped
                     domain objects — the fusion target of ROADMAP #3)
- `kube`             wall spent inside kube.* dependency spans
- `prometheus`       wall spent inside prometheus.* spans
- `solver`           wall spent inside solver.* spans
- `backoff.sleep`    retry-ladder sleeps, carved out of the dependency
                     span that paid them (from the `backoff-retry`
                     events with_backoff records)
- `gc`               the interpreter's gen-2 collections inside the
                     cycle (`GC_AUDIT`'s pauses, recorded as `gc` spans
                     under the span each one interrupted)
- `unattributed`     wall covered by NO span at all (gaps directly
                     under the cycle root)

Attribution is a sweep-line over the span intervals in the tracer's
perf timebase: at every instant the wall belongs to the DEEPEST active
span (ties — parallel fan-out siblings — split equally), so the
partition invariant `sum(buckets) == wall` holds exactly even when
WVA_COLLECT_FANOUT runs dependency calls concurrently. A span's
attributed share is its EXCLUSIVE time; its recorded duration is its
INCLUSIVE time — both are rendered by `controller profile`.

Alongside the ledger lives the device audit (`DEVICE_AUDIT`), fed by
the events the port really has: the one device-to-host readback of each
sizing group (`utils/device.readback`), the arena's host-to-device
column copies (`ops/arena.py`), and the first-use build and load of the
CUDA library (`ops/_build.py`, a compile of `bisect_kernel`). PyTorch
runs eagerly, so nothing ever counts as a retrace. The reconciler drains
the per-cycle delta onto `inferno_jit_compile_seconds{fn}` /
`inferno_host_device_transfers_total{direction}` (the series keep the
reference package's names). Beside it, the GC audit (`GC_AUDIT`) times
the interpreter's collections, drained per cycle onto
`inferno_gc_pause_seconds_total{generation}`.

`ResidualSampler` is the cheap stdlib fallback that itemizes the
residual Python time by caller (sys._current_frames sampled from a
daemon thread at WVA_PROFILE_SAMPLE_HZ); off by default, turned on by
`make bench-profile`.

Stdlib-only, no intra-repo imports outside obs/ (see obs/trace.py's
import rule).
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .trace import Span, Trace, _capacity_from_env, _current_span

DEFAULT_PROFILE_BUFFER = 64

UNATTRIBUTED = "unattributed"
BUCKET_SLEEP = "backoff.sleep"
# a gen-2 collection's pause, recorded after the cycle (GcAudit)
GC_SPAN = "gc"
# a collection stops every thread, so its pause owns its wall outright:
# deeper than any span, fan-out siblings included
_GC_DEPTH = 1 << 30
# the event name + attribute with_backoff records before each retry sleep
_SLEEP_EVENT = "backoff-retry"
_SLEEP_ATTR = "sleep_s"


def bucket_for(name: str) -> str:
    """Map a span name to its ledger bucket. The cycle root's own share
    (time no child span covers) is the unattributed residual."""
    if name == "reconcile":
        return UNATTRIBUTED
    if name.startswith("stage:"):
        return name
    if name.startswith("kube."):
        return "kube"
    if name.startswith("prometheus."):
        return "prometheus"
    if name.startswith("solver."):
        return "solver"
    return name


def _span_intervals(trace: Trace):
    """(span, start_ms, end_ms, depth) per span, relative to the root's
    start in the tracer's perf timebase, clipped to the root interval.
    Unfinished spans (a thread that never called finish) are treated as
    ending with the root."""
    root = trace.root
    if root is None or root.duration_ms is None:
        return None, []
    wall = root.duration_ms
    by_id: dict[str, Span] = {s.span_id: s for s in trace.spans}
    depths: dict[str, int] = {}

    def depth(sp: Span) -> int:
        d = depths.get(sp.span_id)
        if d is not None:
            return d
        parent = by_id.get(sp.parent_id) if sp.parent_id else None
        d = 0 if parent is None else depth(parent) + 1
        depths[sp.span_id] = d
        return d

    out = []
    for sp in trace.spans:
        start = (sp.start_perf - root.start_perf) * 1000.0
        dur = sp.duration_ms if sp.duration_ms is not None else wall
        end = start + dur
        start = min(max(start, 0.0), wall)
        end = min(max(end, start), wall)
        out.append((sp, start, end,
                    _GC_DEPTH if sp.name == GC_SPAN else depth(sp)))
    return root, out


def _attributed_shares(intervals, wall: float) -> list[float]:
    """Sweep-line exact partition: each elementary wall interval is
    owned by the deepest active span(s); parallel siblings at the same
    depth split it equally. Returns the per-span attributed (exclusive)
    milliseconds, summing to the wall up to float addition."""
    events = []   # (t, kind, idx): ends (0) sort before starts (1)
    for i, (_sp, start, end, _d) in enumerate(intervals):
        if end > start:
            events.append((start, 1, i))
            events.append((end, 0, i))
    events.sort(key=lambda e: (e[0], e[1]))
    shares = [0.0] * len(intervals)
    active: set[int] = set()
    prev = 0.0
    for t, kind, i in events:
        if t > prev and active:
            dmax = max(intervals[j][3] for j in active)
            owners = [j for j in active if intervals[j][3] == dmax]
            piece = (t - prev) / len(owners)
            for j in owners:
                shares[j] += piece
        if kind:
            active.add(i)
        else:
            active.discard(i)
        prev = t
    return shares


def _sleep_ms(sp: Span) -> float:
    """Backoff sleep recorded on this span by with_backoff's events."""
    total = 0.0
    for _off, name, attrs in sp.events:
        if name == _SLEEP_EVENT:
            try:
                total += float(attrs.get(_SLEEP_ATTR, 0.0))
            except (TypeError, ValueError):
                continue
    return total * 1000.0


def _aggregate_tree(trace: Trace, shares_by_id: dict[str, float]) -> dict:
    """Collapse the span tree into a name-merged rendering tree: sibling
    spans with the same name (the 512 per-variant kube calls) fold into
    one node carrying count / inclusive / exclusive sums. Children are
    sorted by name so the shape is deterministic under fan-out thread
    scheduling; with parallel siblings an inclusive sum may exceed the
    parent's inclusive wall (it sums span durations, not wall)."""
    root = trace.root
    if root is None:
        return {}
    children_of: dict[Optional[str], list[Span]] = {}
    known = {s.span_id for s in trace.spans}
    for sp in trace.spans:
        parent = sp.parent_id if sp.parent_id in known else None
        if sp is not root:
            children_of.setdefault(parent, []).append(sp)

    def node(sp: Span) -> dict:
        merged: dict[str, dict] = {}
        for child in children_of.get(sp.span_id, []):
            n = node(child)
            into = merged.get(n["name"])
            if into is None:
                merged[n["name"]] = n
            else:
                into["count"] += n["count"]
                into["inclusive_ms"] += n["inclusive_ms"]
                into["exclusive_ms"] += n["exclusive_ms"]
                into["children"] = _merge_children(
                    into["children"], n["children"])
        return {
            "name": sp.name,
            "count": 1,
            "inclusive_ms": sp.duration_ms or 0.0,
            "exclusive_ms": shares_by_id.get(sp.span_id, 0.0),
            "children": [merged[k] for k in sorted(merged)],
        }

    return node(root)


def _merge_children(a: list[dict], b: list[dict]) -> list[dict]:
    by_name = {n["name"]: dict(n) for n in a}
    for n in b:
        into = by_name.get(n["name"])
        if into is None:
            by_name[n["name"]] = dict(n)
        else:
            into["count"] += n["count"]
            into["inclusive_ms"] += n["inclusive_ms"]
            into["exclusive_ms"] += n["exclusive_ms"]
            into["children"] = _merge_children(into["children"],
                                              n["children"])
    return [by_name[k] for k in sorted(by_name)]


def _round_tree(node: dict) -> dict:
    return {
        "name": node["name"],
        "count": node["count"],
        "inclusive_ms": round(node["inclusive_ms"], 3),
        "exclusive_ms": round(node["exclusive_ms"], 3),
        "children": [_round_tree(c) for c in node.get("children", [])],
    }


@dataclass
class ProfileRecord:
    """One cycle's wall-clock attribution. `buckets` (incl. the
    `unattributed` residual) partitions `wall_ms` exactly; `python_ms`
    is the untraced-Python rollup (stage-exclusive + unattributed) —
    the headline, because it is the fusion target. `stream_scope` > 0
    marks a streaming micro-cycle (stream/core.py) and carries how many
    variants the event window covered; 0 = a full polled cycle."""

    trace_id: str
    cycle: int
    ts: float
    wall_ms: float
    buckets: dict[str, float]
    python_ms: float
    tree: dict
    residual_by_caller: dict[str, float] = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    stream_scope: int = 0

    @property
    def unattributed_ms(self) -> float:
        return self.buckets.get(UNATTRIBUTED, 0.0)

    @property
    def attributed_fraction(self) -> float:
        """Share of the wall landing in a NAMED bucket (everything but
        the unattributed residual); 1.0 for an empty (sim-time) cycle."""
        if self.wall_ms <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.unattributed_ms / self.wall_ms)

    def to_dict(self) -> dict:
        # the serialized buckets must STILL partition the serialized
        # wall exactly: round the named buckets, then re-derive the
        # residual from the rounded values instead of rounding it
        # independently (ten independently-rounded buckets drift a few
        # microseconds from the rounded wall)
        wall = round(self.wall_ms, 3)
        buckets = {k: round(v, 3) for k, v in sorted(self.buckets.items())
                   if k != UNATTRIBUTED}
        unattributed = max(round(wall - sum(buckets.values()), 3), 0.0)
        buckets[UNATTRIBUTED] = unattributed
        stage_ms = sum(v for k, v in buckets.items()
                       if k.startswith("stage:"))
        out = {
            "trace_id": self.trace_id,
            "cycle": self.cycle,
            "ts": round(self.ts, 3),
            "wall_ms": wall,
            "buckets": dict(sorted(buckets.items())),
            "unattributed_ms": unattributed,
            "attributed_fraction": round(self.attributed_fraction, 4),
            "python_ms": round(unattributed + stage_ms, 3),
            "tree": _round_tree(self.tree) if self.tree else {},
            "residual_by_caller": {
                k: round(v, 1)
                for k, v in sorted(self.residual_by_caller.items(),
                                   key=lambda kv: -kv[1])},
            "device": self.device,
        }
        # omitted on full cycles so their serialized shape is unchanged
        if self.stream_scope > 0:
            out["stream_scope"] = self.stream_scope
        return out


def build_record(trace: Trace, cycle: int, ts: float,
                 audit_delta: Optional[dict] = None,
                 residual: Optional[dict] = None,
                 ) -> Optional[ProfileRecord]:
    """Fold one finished cycle trace into its attribution record.
    Returns None when the trace has no finished root."""
    root, intervals = _span_intervals(trace)
    if root is None:
        return None
    wall = root.duration_ms or 0.0
    shares = _attributed_shares(intervals, wall)
    shares_by_id = {sp.span_id: share
                    for (sp, _s, _e, _d), share in zip(intervals, shares)}
    buckets: dict[str, float] = {}
    for (sp, _s, _e, _d), share in zip(intervals, shares):
        if sp is root:
            continue   # the root's own share IS the residual, added below
        sleep = min(_sleep_ms(sp), share)
        if sleep > 0.0:
            buckets[BUCKET_SLEEP] = buckets.get(BUCKET_SLEEP, 0.0) + sleep
            share -= sleep
        b = bucket_for(sp.name)
        buckets[b] = buckets.get(b, 0.0) + share
    # the residual absorbs the float-addition residue too, so the
    # partition invariant (sum(buckets) == wall) holds by construction
    named = sum(buckets.values())
    buckets[UNATTRIBUTED] = max(wall - named, 0.0)
    python_ms = buckets[UNATTRIBUTED] + sum(
        v for k, v in buckets.items() if k.startswith("stage:"))
    return ProfileRecord(
        trace_id=trace.trace_id, cycle=cycle, ts=ts, wall_ms=wall,
        buckets=buckets, python_ms=python_ms,
        tree=_aggregate_tree(trace, shares_by_id),
        residual_by_caller=dict(residual or {}),
        device=dict(audit_delta or {}),
        # the reconciler tags scoped micro-cycle roots with how many
        # variants the event window covered (stream/core.py wakes)
        stream_scope=int(root.attributes.get("stream_scope", 0) or 0),
    )


# -- device audit ------------------------------------------------------------


class DeviceAudit:
    """Process-wide compile / transfer counters, in the shape of the
    reference package's JAX audit (its keys, "retraces" included, which
    the port leaves empty: PyTorch has no trace to redo), fed by the
    port's readback, arena-pack and kernel-build choke points. Cheap and
    lock-guarded: note_transfer is a dict increment per copy. Transfers
    across a device mesh (the sharded fleet arena's uploads and
    scatters, the sharded decision's gather) are also tallied per shard
    count, as the reference's "sharded" tally is."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._transfers: dict[str, int] = {}
        self._sharded: dict[str, int] = {}
        self._compiles: list[tuple[str, float]] = []

    def note_compile(self, fn: str, seconds: float) -> None:
        with self._lock:
            self._compiles.append((fn, seconds))

    def note_transfer(self, direction: str, n: int = 1,
                      shards: int = 1) -> None:
        """direction: "h2d" (host arrays staged onto device), "d2h"
        (a sizing group's results pulled back to host) or "d2h-drift"
        (the drift watchdog's readings pulled back). Transfers that cross a
        sharded boundary pass shards > 1 and are also tallied under
        "<direction>@<shards>"."""
        with self._lock:
            self._transfers[direction] = \
                self._transfers.get(direction, 0) + n
            if shards > 1:
                key = f"{direction}@{shards}"
                self._sharded[key] = self._sharded.get(key, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "retraces": {},
                "transfers": dict(self._transfers),
                "sharded": dict(self._sharded),
                "compiles": list(self._compiles),
            }

    @staticmethod
    def delta(old: dict, new: dict) -> dict:
        """What happened between two snapshots: per-fn retrace counts,
        per-direction transfer counts, and the new compile events."""
        retraces = {
            fn: n - old.get("retraces", {}).get(fn, 0)
            for fn, n in new.get("retraces", {}).items()
            if n - old.get("retraces", {}).get(fn, 0) > 0}
        transfers = {
            d: n - old.get("transfers", {}).get(d, 0)
            for d, n in new.get("transfers", {}).items()
            if n - old.get("transfers", {}).get(d, 0) > 0}
        compiles = new.get("compiles", [])[len(old.get("compiles", [])):]
        out = {
            "retraces": retraces,
            "transfers": transfers,
            "compiles": [[fn, round(s, 4)] for fn, s in compiles],
        }
        sharded = {
            d: n - old.get("sharded", {}).get(d, 0)
            for d, n in new.get("sharded", {}).items()
            if n - old.get("sharded", {}).get(d, 0) > 0}
        # omitted when no mesh traffic occurred, so unsharded records
        # keep their exact shape
        if sharded:
            out["sharded"] = sharded
        return out


DEVICE_AUDIT = DeviceAudit()


# -- garbage-collection audit ------------------------------------------------


class GcAudit:
    """Process-wide pauses of the interpreter's garbage collector, from
    one `gc.callbacks` hook that the first Reconciler installs: seconds
    per generation, and for each gen-2 pause its start
    and end on `time.perf_counter` with the span that was current in the
    thread that set it off.

    Any allocation can set a collection off, inside any lock. So the hook
    does arithmetic on plain floats and one deque append, and nothing
    else: no lock, no tracer method, no Prometheus object (Tracer.begin
    and a counter's inc take threading.Locks, and a collection set off
    while one is held would deadlock on it). The interpreter runs one
    collection at a time, so each start pairs with its stop. The
    reconciler reads `totals()` and `gen2_pauses()` once per cycle. The
    newest `keep` gen-2 pauses are kept: a span one holds keeps its
    trace alive no longer than the trace ring (64 cycles by default)
    would at a pause a cycle."""

    def __init__(self, keep: int = 64) -> None:
        self.seconds = [0.0, 0.0, 0.0]
        self.pauses: deque = deque(maxlen=keep)   # (t0, t1, span) gen 2
        self._t0: Optional[float] = None
        self._span: Optional[Span] = None
        self.installed = False
        self._install_lock = threading.Lock()

    def hook(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._span = _current_span.get()
            self._t0 = time.perf_counter()
            return
        t1 = time.perf_counter()
        if self._t0 is None:
            return
        gen = info["generation"]
        self.seconds[gen] += t1 - self._t0
        if gen == 2:
            self.pauses.append((self._t0, t1, self._span))
        self._t0 = self._span = None

    def install(self) -> None:
        """Add the hook to gc.callbacks, once per process."""
        with self._install_lock:
            if not self.installed:
                self.installed = True
                gc.callbacks.append(self.hook)

    def totals(self) -> tuple:
        """Pause seconds per generation since the hook went in."""
        return tuple(self.seconds)

    def gen2_pauses(self) -> list:
        """The newest gen-2 pauses: (start, end, span or None)."""
        return list(self.pauses)


GC_AUDIT = GcAudit()


# -- residual sampler --------------------------------------------------------


class ResidualSampler:
    """Cheap stdlib sampling profiler for ONE thread: a daemon thread
    wakes at `hz` and records the target thread's innermost in-package
    frame (`file.py:function`). `stop()` converts sample counts into
    estimated milliseconds (count x period) — the itemization of the
    ledger's residual Python time by caller. Wall-clock based, so keep
    it off (the default) in sim-time runs."""

    def __init__(self, hz: float, thread_id: Optional[int] = None,
                 package_hint: str = "workload_variant_autoscaler_tpu_torch"):
        self.period_s = 1.0 / max(hz, 0.1)
        self.thread_id = thread_id if thread_id is not None \
            else threading.get_ident()
        self.package_hint = package_hint
        self._counts: dict[str, int] = {}
        # single-writer in practice (only the sampler thread mutates),
        # but stop() may read while a last tick is in flight
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _caller_of(self, frame) -> Optional[str]:
        while frame is not None:
            fn = frame.f_code.co_filename
            if self.package_hint in fn and not fn.endswith("profile.py"):
                return f"{os.path.basename(fn)}:{frame.f_code.co_name}"
            frame = frame.f_back
        return None

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            caller = self._caller_of(frame)
            if caller is not None:
                with self._lock:
                    self._counts[caller] = self._counts.get(caller, 0) + 1

    def start(self) -> "ResidualSampler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="wva-profile-sampler")
        self._thread.start()
        return self

    def stop(self) -> dict[str, float]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._lock:
            counts = dict(self._counts)
        return {caller: count * self.period_s * 1000.0
                for caller, count in counts.items()}


# -- the bounded record ring -------------------------------------------------


class Profiler:
    """Bounded ring of ProfileRecords (`WVA_PROFILE_BUFFER` cycles,
    default 64), one per reconcile cycle, served by /debug/profile and
    the `controller profile` CLI. Owns the per-cycle device-audit delta
    bookkeeping against the process-wide DEVICE_AUDIT."""

    def __init__(self, capacity: Optional[int] = None,
                 audit: Optional[DeviceAudit] = None):
        self.capacity = capacity or _capacity_from_env(
            "WVA_PROFILE_BUFFER", DEFAULT_PROFILE_BUFFER)
        self.audit = audit or DEVICE_AUDIT
        self._records: deque[ProfileRecord] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_audit = self.audit.snapshot()

    def observe(self, trace: Trace, cycle: int, ts: float,
                residual: Optional[dict] = None) -> Optional[ProfileRecord]:
        snap = self.audit.snapshot()
        audit_delta = DeviceAudit.delta(self._last_audit, snap)
        self._last_audit = snap
        rec = build_record(trace, cycle, ts, audit_delta=audit_delta,
                           residual=residual)
        if rec is not None:
            with self._lock:
                self._records.append(rec)
        return rec

    def records(self, limit: Optional[int] = None) -> list[ProfileRecord]:
        """Most-recent-first snapshot of the ring."""
        with self._lock:
            out = list(self._records)
        out.reverse()
        return out[:limit] if limit else out

    def find(self, cycle: int) -> Optional[ProfileRecord]:
        with self._lock:
            for rec in self._records:
                if rec.cycle == cycle:
                    return rec
        return None

    def snapshot(self, limit: Optional[int] = None,
                 cycle: Optional[int] = None) -> list[dict]:
        if cycle is not None:
            rec = self.find(cycle)
            return [rec.to_dict()] if rec is not None else []
        return [r.to_dict() for r in self.records(limit)]


# -- text rendering (shared by `controller profile` and `explain --trace`) ---


def render_tree(tree: dict, wall_ms: Optional[float] = None) -> str:
    """Text flamegraph of the (aggregated) span tree with exclusive and
    inclusive columns. Works off the JSON form, so the CLI renders
    /debug/profile payloads and saved dumps alike."""
    if not tree:
        return "(no spans)"
    wall = wall_ms if wall_ms is not None else tree.get("inclusive_ms", 0.0)
    rows: list[tuple[str, str, str, str, str]] = []

    def walk(node: dict, indent: int) -> None:
        name = "  " * indent + node["name"]
        count = str(node.get("count", 1))
        incl = node.get("inclusive_ms", 0.0)
        excl = node.get("exclusive_ms", 0.0)
        pct = f"{excl / wall * 100.0:5.1f}%" if wall > 0 else "    -"
        rows.append((name, count, f"{incl:10.3f}", f"{excl:10.3f}", pct))
        for child in node.get("children", []):
            walk(child, indent + 1)

    walk(tree, 0)
    width = max(len(r[0]) for r in rows)
    lines = [f"{'span':<{width}}  {'count':>5}  {'incl ms':>10}  "
             f"{'excl ms':>10}  {'excl%':>6}"]
    for name, count, incl, excl, pct in rows:
        lines.append(f"{name:<{width}}  {count:>5}  {incl}  {excl}  {pct}")
    return "\n".join(lines)


def render_profile(rec: dict) -> str:
    """Full `controller profile` rendering of one ProfileRecord dict:
    the bucket ledger, the flamegraph, the device audit, and the
    sampled residual itemization when present."""
    wall = rec.get("wall_ms", 0.0)
    scope = rec.get("stream_scope", 0)
    lines = [
        f"cycle {rec.get('cycle')} trace {rec.get('trace_id')} — "
        f"wall {wall:.3f} ms, attributed "
        f"{rec.get('attributed_fraction', 0.0) * 100.0:.1f}% "
        f"(python orchestration {rec.get('python_ms', 0.0):.3f} ms)"
        + (f" — streaming micro-cycle, scope {scope} variant(s)"
           if scope else ""),
        "",
        "bucket ledger (exclusive wall; sums to the cycle wall exactly):",
    ]
    buckets = rec.get("buckets", {})
    width = max([len(b) for b in buckets] + [len("bucket")])
    for name, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        pct = f"{ms / wall * 100.0:5.1f}%" if wall > 0 else "    -"
        lines.append(f"  {name:<{width}}  {ms:10.3f} ms  {pct}")
    lines += ["", render_tree(rec.get("tree", {}), wall_ms=wall)]
    audit = rec.get("device", {})
    if audit:
        retraces = audit.get("retraces", {}) or "none"
        transfers = audit.get("transfers", {}) or "none"
        lines += ["",
                  f"device audit: retraces {retraces}, "
                  f"transfers {transfers}, "
                  f"compiles {audit.get('compiles', []) or 'none'}"]
    residual = rec.get("residual_by_caller", {})
    if residual:
        lines += ["", "residual itemization (sampled, estimated ms):"]
        for caller, ms in sorted(residual.items(),
                                 key=lambda kv: -kv[1])[:15]:
            lines.append(f"  {caller}  ~{ms:.0f} ms")
    return "\n".join(lines)
