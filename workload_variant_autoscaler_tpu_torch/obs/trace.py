"""Lightweight span tracer for the reconcile pipeline (no OpenTelemetry).

One reconcile cycle = one trace. The reconciler opens a root span per
cycle; stage spans, dependency-call spans (kube verbs, Prometheus
queries), and the solver solve nest under it via a contextvar, so a log
line emitted anywhere inside the cycle can stamp the cycle's `trace_id`
(utils/logging.py reads `current_trace_id()` at format time) and an
operator can answer "what did cycle N actually do, and where did the
time go" from ONE structure instead of a log grep.

Deliberately tiny and dependency-free:

- IDs come from a per-tracer counter, not wall-clock randomness — the
  chaos suite's determinism rule (tests/test_chaos.py) applies to traces
  too: the same scripted run produces the same span tree.
- Spans carry attributes (set once) and events (timestamped append-only
  marks: retries, backoff sleeps, breaker transitions, injected faults).
- Finished traces land in a bounded ring buffer (`WVA_TRACE_BUFFER`,
  default 64 cycles) served by /debug/traces (obs/debug.py).
- Module-level helpers (`add_event`, `set_attribute`, `span`) no-op when
  no span is active, so instrumented code paths (utils/backoff.py,
  faults/inject.py, the solver) need no tracer plumbed through and cost
  one contextvar read when tracing is idle.

This module must stay stdlib-only and import nothing from the package:
utils/logging.py imports it at module load, so any intra-repo import
here would be a cycle.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

DEFAULT_TRACE_BUFFER = 64

_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("wva_current_span", default=None)


def current_span() -> Optional["Span"]:
    """The innermost active span in this thread/context, or None."""
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    sp = _current_span.get()
    return sp.trace_id if sp is not None else None


def current_span_id() -> Optional[str]:
    sp = _current_span.get()
    return sp.span_id if sp is not None else None


def add_event(name: str, **attrs: Any) -> None:
    """Append a timestamped event to the active span (no-op outside a
    trace). Instrumented leaf code (backoff ladders, breakers, fault
    hooks) calls this without holding a tracer."""
    sp = _current_span.get()
    if sp is not None:
        sp.event(name, **attrs)


def set_attribute(key: str, value: Any) -> None:
    """Set an attribute on the active span (no-op outside a trace)."""
    sp = _current_span.get()
    if sp is not None:
        sp.set(**{key: value})


def span(name: str, **attrs: Any):
    """Child span under the ACTIVE tracer, as a context manager — lets
    modules that hold no Tracer reference (solver, collector) open spans
    that nest correctly. A no-op context when no trace is active."""
    sp = _current_span.get()
    if sp is None or sp.tracer is None:
        return _NullSpanContext()
    return sp.tracer.span(name, **attrs)


class _NullSpanContext:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


class Span:
    """One timed operation. Mutable while open, frozen by `finish()`;
    events are (offset_ms_from_span_start, name, attrs) triples."""

    def __init__(self, tracer: "Tracer", trace: "Trace", name: str,
                 trace_id: str, span_id: str, parent_id: Optional[str],
                 attrs: dict):
        self.tracer = tracer
        self.trace = trace
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_unix = tracer.now()
        self.duration_ms: Optional[float] = None  # None while open
        self.attributes: dict = dict(attrs)
        self.events: list[tuple[float, str, dict]] = []
        self.status = "ok"
        self.error = ""
        # duration clock reading at span start, in the tracer's perf
        # timebase (seconds) — the attribution ledger (obs/profile.py)
        # places spans on a common timeline with it
        self.start_perf = tracer.perf()
        self._token: Optional[contextvars.Token] = None
        self._ended = False

    def set(self, **attrs: Any) -> "Span":
        self.attributes.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        offset_ms = (self.tracer.perf() - self.start_perf) * 1000.0
        self.events.append((round(offset_ms, 3), name, attrs))

    def finish(self, error: Optional[BaseException] = None) -> None:
        """End the span, deactivate it, and record an error status when
        the wrapped operation raised. Idempotent."""
        if self._ended:
            return
        self._ended = True
        self.duration_ms = (self.tracer.perf() - self.start_perf) * 1000.0
        if error is not None:
            self.status = "error"
            self.error = f"{type(error).__name__}: {error}"
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None

    def cancel(self) -> None:
        """Deactivate and DROP the span from its trace (a speculative
        span that turned out to cover nothing, e.g. the stage slot after
        the last stage mark)."""
        if self._ended:
            return
        self._ended = True
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self.trace.remove(self)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": round(self.start_unix, 3),
            "duration_ms": (round(self.duration_ms, 3)
                            if self.duration_ms is not None else None),
            "status": self.status,
            "error": self.error,
            "attributes": dict(self.attributes),
            "events": [{"offset_ms": off, "name": name, **attrs}
                       for off, name, attrs in self.events],
        }


class Trace:
    """One cycle's span tree, in span-start order (the root first)."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []

    def add(self, sp: Span) -> None:
        self.spans.append(sp)

    def remove(self, sp: Span) -> None:
        try:
            self.spans.remove(sp)
        except ValueError:
            pass

    @property
    def root(self) -> Optional[Span]:
        return self.spans[0] if self.spans else None

    def find_spans(self, name_prefix: str = "") -> list[Span]:
        return [s for s in self.spans if s.name.startswith(name_prefix)]

    def events(self, name: str = "") -> list[tuple[str, str, dict]]:
        """All events across spans as (span_name, event_name, attrs),
        optionally filtered by event name."""
        out = []
        for sp in self.spans:
            for _off, ev_name, attrs in sp.events:
                if not name or ev_name == name:
                    out.append((sp.name, ev_name, attrs))
        return out

    def to_dict(self) -> dict:
        root = self.root
        return {
            "trace_id": self.trace_id,
            "root": root.name if root else "",
            "start_unix": round(root.start_unix, 3) if root else None,
            "duration_ms": (round(root.duration_ms, 3)
                            if root and root.duration_ms is not None
                            else None),
            "status": root.status if root else "ok",
            "spans": [s.to_dict() for s in self.spans],
        }


def _capacity_from_env(env: str, default: int) -> int:
    raw = os.environ.get(env, "")
    try:
        cap = int(raw)
    except ValueError:
        return default
    return cap if cap > 0 else default


class Tracer:
    """Span factory + bounded ring of finished (and in-flight) traces.

    `now` is injectable (sim-time tests); span/trace IDs are drawn from a
    counter so scripted chaos runs trace identically across reruns. The
    ring is guarded by a lock: the debug endpoint thread snapshots while
    the reconcile thread appends.

    `perf` is the DURATION clock. By default a tracer on wall time uses
    `time.perf_counter` (monotonic, high resolution), but a tracer whose
    `now` was injected derives durations from that same clock — a
    twin/sim-time run (emulator/twin.py) records sim durations, not the
    host's wall time, so rerunning the same scenario produces
    byte-identical span durations."""

    def __init__(self, capacity: Optional[int] = None,
                 now: Callable[[], float] = time.time,
                 perf: Optional[Callable[[], float]] = None):
        self.capacity = capacity or _capacity_from_env(
            "WVA_TRACE_BUFFER", DEFAULT_TRACE_BUFFER)
        self.now = now
        if perf is None:
            perf = time.perf_counter if now is time.time else now
        self.perf = perf
        self._traces: deque[Trace] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def _next_id(self, prefix: str) -> str:
        # locked: fanned-out dependency calls (utils/concurrency.py)
        # open spans from worker threads concurrently. Single-threaded
        # runs keep fully deterministic counters; under fan-out the
        # ASSIGNMENT ORDER follows scheduling, but the span TREE
        # (parent/child links, names, attributes) is unchanged.
        with self._lock:
            self._seq += 1
            return f"{prefix}{self._seq:08x}"

    def begin(self, name: str, **attrs: Any) -> Span:
        """Open and ACTIVATE a span; the caller must finish() (or
        cancel()) it. A span opened with no active parent starts a new
        trace in the ring. A parent belonging to a DIFFERENT tracer is
        ignored (a leaked never-finished span from another tracer must
        not graft this tracer's spans onto a foreign trace)."""
        parent = _current_span.get()
        if parent is not None and parent.tracer is not self:
            parent = None
        if parent is None:
            trace = Trace(self._next_id("t"))
            with self._lock:
                self._traces.append(trace)
            trace_id, parent_id = trace.trace_id, None
        else:
            trace = parent.trace
            trace_id, parent_id = parent.trace_id, parent.span_id
        sp = Span(self, trace, name, trace_id, self._next_id("s"),
                  parent_id, attrs)
        with self._lock:
            trace.add(sp)
        sp._token = _current_span.set(sp)
        return sp

    def span(self, name: str, **attrs: Any) -> "_SpanContext":
        """Context-manager form of begin()/finish(); records a raised
        exception as the span's error status and re-raises."""
        return _SpanContext(self, name, attrs)

    # -- ring access (debug endpoints, tests) -----------------------------

    def traces(self, limit: Optional[int] = None) -> list[Trace]:
        """Most-recent-first snapshot of the ring."""
        with self._lock:
            out = list(self._traces)
        out.reverse()
        return out[:limit] if limit else out

    def find(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            for tr in self._traces:
                if tr.trace_id == trace_id:
                    return tr
        return None

    def snapshot(self, limit: Optional[int] = None) -> list[dict]:
        return [tr.to_dict() for tr in self.traces(limit)]


class _SpanContext:
    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        self._span = self._tracer.begin(self._name, **self._attrs)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None:
            self._span.finish(error=exc)
        return False
