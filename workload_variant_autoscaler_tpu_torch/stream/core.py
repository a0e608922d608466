"""The streaming reconcile core: event-driven decisions, not per-tick.

The polled loop looks at the fleet once per `GLOBAL_OPT_INTERVAL`; the
fused solve made the looking cost ~15 ms, so end-to-end reaction time
is dominated by WAITING (ROADMAP item 2). This core replaces waiting
with ingest:

1. **Continuous ingest.** Metric deltas arrive pushed (the Prometheus
   remote-write endpoint in stream/ingest.py) or via the streamed-scrape
   fallback poller, and fold into a per-(model, namespace) store — and
   into the reconciler's LoadCache, so the degradation ladder rides the
   same last-known-good evidence either way.
2. **Signature change detection.** The `WVA_SOLVE_EPSILON` quantizer
   (solver/incremental.py) is repurposed as the change detector: a load
   whose quantized signature equals the last solved one is noise and is
   dropped at the door; a flipped signature enqueues exactly the
   affected variants onto the debounced work queue (stream/queue.py).
3. **Scoped micro-cycles.** The consumer drains the queue and drives
   `Reconciler.reconcile(scope=..., stream_loads=...)`: a cycle over
   just the flipped variants, fed from the stream store (zero
   Prometheus round-trips), solved through a resident arena
   (`StreamState.stream_arena`) whose buffers stay resident on the
   device between micro-cycles, published with merge semantics on the wholesale-replaced series.
   Full-fleet passes are demoted to the `GLOBAL_OPT_INTERVAL` backstop
   (plus watch kicks and escalations) — the polled `run_forever` loop
   is now just one consumer of this engine, and `WVA_STREAM=off`
   restores it byte-for-byte.

Scoped solving is sound when per-variant decisions are separable —
always true in unlimited mode (each variant independently picks its
best allocation). In limited mode capacity couples variants, so every
event batch ESCALATES to a full pass (still debounced, still
event-driven — only the scope widens), and concurrent escalations
COALESCE into one pending backstop pass so a flood costs one full
cycle, not N.

Streaming under fire (docs/robustness.md, "Streaming fault matrix"):
the core survives three failure families the happy path ignores.

- **Overload.** The ingest store is capped (`WVA_STREAM_MAX_GROUPS`)
  and the queue depth-bounded (`WVA_STREAM_MAX_QUEUE`); refused events
  are METERED on `inferno_stream_shed_total{reason}` and folded into a
  full-pass request, never silently lost. Sustained storms widen the
  debounce window adaptively (up to `WVA_STREAM_MAX_DEBOUNCE_MS`, with
  hysteresis back down), and an escalation valve — queue saturation or
  a pending event older than `WVA_STREAM_LAG_BUDGET_MS` — coalesces
  the whole backlog into ONE backstop full pass instead of churning
  scoped micro-cycles. Every such transition surfaces as the
  `stream-degraded` rung on the degradation ladder.
- **Poisoned input.** Semantically-poisoned observations (NaN/inf,
  negative loads, out-of-order or far-future sample timestamps) are
  quarantined at the door; repeated poison trips a per-source
  `CircuitBreaker` (`WVA_STREAM_QUARANTINE_THRESHOLD`), closing the
  push door (HTTP 429) while the `ScrapePoller` fallback covers the
  fleet until the breaker half-opens.
- **Crash.** After each cycle the core checkpoints its resident state
  (`WVA_STREAM_CHECKPOINT`, stream/checkpoint.py): a restart restores
  the snapshot, the cross-cycle decision state, and the consumed
  signatures, resuming SCOPED operation without a decision flap.
  Corrupt or stale (`WVA_STREAM_CHECKPOINT_MAX_AGE_S`) checkpoints are
  discarded — metered, cold full pass, exactly today's behavior.

Observability: every ingested delta counts on
`inferno_stream_events_total{source}`; every refused one on
`inferno_stream_shed_total{reason}`; every consumed change observes
load-change-seen -> allocation-published wall time on
`inferno_stream_lag_seconds`. Each micro-cycle is its own flight-
recorder trace (a `reconcile` root span carrying `stream_scope`), so
`/debug/traces` shows per-event mini-traces between backstop cycles.

Thread contract: `observe_load`/`ingest_fields`/`ingest_push`/
`note_kick` may be called from any thread (ingest WSGI workers, the
scrape poller, watch listeners); everything they touch is behind
`self._lock` or the queue's own lock (wvalint WVL404 enforces this
package-wide; WVL405 additionally demands a visible bound on every
container a stream class grows in a loop). `process_once`/`run` belong
to the single consumer thread, which is the only thread that ever
calls into the Reconciler.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..collector import CollectedLoad
from ..metrics import (
    CHECKPOINT_DISCARD_CORRUPT,
    CHECKPOINT_DISCARD_STALE,
    CHECKPOINT_RESTORE,
    CHECKPOINT_SAVE,
    LANE_COALESCED,
    LANE_FULL,
    LANE_SCOPED,
    SHED_QUARANTINE_NAN,
    SHED_QUARANTINE_NEGATIVE,
    SHED_QUARANTINE_TIMESTAMP,
    SHED_QUEUE_FULL,
    SHED_STALE_MARKER,
    SHED_STORE_FULL,
    SOURCE_BACKSTOP,
    SOURCE_REMOTE_WRITE,
    SOURCE_SCRAPE,
    SOURCE_WATCH,
)
from ..solver.incremental import quantize, quantize_batch, solve_epsilon
from ..utils import get_logger, knob, kv, parse_float_or
from ..utils.backoff import CircuitBreaker
from .checkpoint import CheckpointError, load_checkpoint, save_checkpoint
from .pushdown import CounterLedger, LedgerQuarantine
from .queue import DebouncedQueue
from .state import FleetSnapshot, StreamState

log = get_logger("wva.stream")

# trailing-edge coalescing window: long enough that one kubectl apply /
# one remote-write request's burst rides a single wake, short enough
# that it stays a small fraction of the <100 ms reaction target
DEFAULT_DEBOUNCE_MS = 25.0
# fallback cadence when a backstop cycle raised before publishing an
# interval (mirrors controller.reconciler.DEFAULT_INTERVAL_SECONDS)
FALLBACK_INTERVAL_S = 60.0

# overload / quarantine / checkpoint knob defaults (each overridable by
# env or operator ConfigMap; docs/user-guide/configuration.md)
DEFAULT_MAX_GROUPS = 4096.0       # WVA_STREAM_MAX_GROUPS
DEFAULT_MAX_QUEUE = 1024.0        # WVA_STREAM_MAX_QUEUE
DEFAULT_MAX_BODY_BYTES = 1048576.0   # WVA_STREAM_MAX_BODY_BYTES (1 MiB)
DEFAULT_LAG_BUDGET_MS = 5000.0    # WVA_STREAM_LAG_BUDGET_MS
DEFAULT_MAX_DEBOUNCE_MS = 250.0   # WVA_STREAM_MAX_DEBOUNCE_MS
DEFAULT_STORM_EVENTS = 256.0      # WVA_STREAM_STORM_EVENTS
DEFAULT_QUARANTINE_THRESHOLD = 8.0   # WVA_STREAM_QUARANTINE_THRESHOLD
DEFAULT_CHECKPOINT_MAX_AGE_S = 120.0  # WVA_STREAM_CHECKPOINT_MAX_AGE_S
# hard literal ceilings backing the knob-derived caps: whatever the
# ConfigMap says, no stream container outgrows these (wvalint WVL405)
HARD_MAX_GROUPS = 65536
HARD_MAX_QUEUE = 65536
# ingest-store lock stripes: at 10k series/s the single store lock is
# the contention point (every WSGI worker serializing per group); 16
# stripes keep P(collision) low at the worker counts WSGI servers run
# while the per-stripe dicts stay cache-friendly
N_STRIPES = 16
# a pushed sample stamped further than this into the future is poison
# (a skewed sender clock would otherwise pin "newest wins" forever)
FAR_FUTURE_SLACK_S = 60.0

_LOAD_FIELDS = ("arrival_rate_rpm", "avg_input_tokens",
                "avg_output_tokens", "avg_ttft_ms", "avg_itl_ms")
# a load is solvable once the sizing inputs exist; latency series are
# advisory (status/drift display) and default to the last seen value
_REQUIRED_FIELDS = ("arrival_rate_rpm", "avg_input_tokens",
                    "avg_output_tokens")

# stream-pressure causes that are not 1:1 with a shed reason
PRESSURE_LAG_BUDGET = "lag-budget"
PRESSURE_FLOOD = "flood"
PRESSURE_LIMITED_COALESCE = "limited-coalesce"


class ShedError(RuntimeError):
    """An event refused at the ingest door; `reason` is the
    inferno_stream_shed_total label value already metered for it."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


@dataclass
class _Accum:
    """Per-(model, namespace) ingest accumulator: the latest value of
    each load field, plus the signature the solver last consumed."""

    fields: dict = field(default_factory=dict)
    updated_at: float = 0.0
    consumed_sig: Optional[tuple] = None
    # newest admitted sample wall-clock timestamp (ms; 0 = never
    # stamped) — the out-of-order quarantine baseline
    sample_ts_ms: float = 0.0

    def load(self) -> Optional[CollectedLoad]:
        if any(f not in self.fields for f in _REQUIRED_FIELDS):
            return None
        return CollectedLoad(
            arrival_rate_rpm=self.fields["arrival_rate_rpm"],
            avg_input_tokens=self.fields["avg_input_tokens"],
            avg_output_tokens=self.fields["avg_output_tokens"],
            avg_ttft_ms=self.fields.get("avg_ttft_ms", 0.0),
            avg_itl_ms=self.fields.get("avg_itl_ms", 0.0),
        )


@dataclass(frozen=True)
class _Plan:
    """One claimed unit of consumer work."""

    kind: str                      # "full" | "scoped" | "drop"
    source: str = SOURCE_BACKSTOP
    events: dict = field(default_factory=dict)   # (model, ns) -> Pending
    scope: frozenset = frozenset()
    loads: dict = field(default_factory=dict)    # full_name -> load
    # a pool-scoped limited-mode micro-cycle: the scope is CLOSED under
    # the snapshot's pool-connected components, so the reconciler may
    # run the greedy against the snapshot capacity (state.py)
    limited: bool = False


class _StripedStore:
    """The ingest store, hash-striped by (model, namespace) group so
    concurrent WSGI workers land on different locks. Single-key reads
    (`get`/`in`/`[]`) lock their stripe internally; read-modify-write
    sequences take `lock_at(stripe_of(key))` and operate on the bare
    `map_at` dict — the batch door acquires each touched stripe ONCE
    for a whole request. `len()` is a lock-free sum of stripe sizes
    (each `len` read is atomic in CPython; the store cap tolerates a
    transiently approximate total)."""

    __slots__ = ("_locks", "_maps")

    def __init__(self):
        self._locks = tuple(threading.Lock() for _ in range(N_STRIPES))
        self._maps = tuple({} for _ in range(N_STRIPES))

    def stripe_of(self, key) -> int:
        return hash(key) % N_STRIPES

    def lock_at(self, idx: int):
        return self._locks[idx]

    def map_at(self, idx: int) -> dict:
        return self._maps[idx]

    def lock_for(self, key):
        return self._locks[hash(key) % N_STRIPES]

    def map_for(self, key) -> dict:
        return self._maps[hash(key) % N_STRIPES]

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def __contains__(self, key) -> bool:
        with self.lock_for(key):
            return key in self.map_for(key)

    def __getitem__(self, key):
        with self.lock_for(key):
            return self.map_for(key)[key]

    def get(self, key, default=None):
        with self.lock_for(key):
            return self.map_for(key).get(key, default)

    def items(self) -> list:
        """Stripe-by-stripe snapshot of every (key, accum) pair."""
        out: list = []
        for lock, m in zip(self._locks, self._maps):
            with lock:
                out.extend(m.items())
        return out

    def clear(self) -> None:
        for lock, m in zip(self._locks, self._maps):
            with lock:
                m.clear()


class StreamCore:
    """Long-lived consumer driving the Reconciler from pushed events.
    One per Reconciler; owns the reconciler's `StreamState`."""

    def __init__(self, reconciler, debounce_s: Optional[float] = None,
                 clock=None):
        self.rec = reconciler
        self.emitter = reconciler.emitter
        self.state: StreamState = reconciler.state
        # scheduling clock (debounce windows, the backstop deadline, lag
        # measurement): the reconciler's MONOTONIC clock, not its wall
        # clock — a sim-time `now` (twin, chaos tests) must not freeze
        # the production consumer loop. Sim-time callers inject their
        # own clock here and call process_once() synchronously.
        self.clock = clock or reconciler.monotonic
        if debounce_s is None:
            debounce_s = self._knob("WVA_STREAM_DEBOUNCE_MS",
                                    DEFAULT_DEBOUNCE_MS) / 1000.0
        self.queue = DebouncedQueue(debounce_s=debounce_s,
                                    clock=self.clock,
                                    max_pending=self._max_queue())
        self._lock = threading.Lock()
        self._store = _StripedStore()
        # raw-counter pushdown ledger (stream/pushdown.py); gated by
        # WVA_STREAM_PUSHDOWN at the ingest layer
        self.pushdown = CounterLedger()
        self._next_full_deadline: Optional[float] = None
        self._scrape_targets: tuple = ()
        # pre-cycle hook (the goodput twin advances its FaultPlan here)
        self._on_cycle_start = None
        # -- streaming-under-fire state (all guarded by self._lock) ----
        # adaptive debounce ladder: base is the configured window, the
        # effective window doubles under storms and halves back down
        self._base_debounce_s = self.queue.debounce_s
        self._debounce_s = self.queue.debounce_s
        # the pressure cause the NEXT cycle will be marked with (the
        # stream-degraded rung); set by ingest threads and the valve,
        # consumed by the consumer at _execute
        self._pressure: Optional[str] = None
        # limited-mode escalation coalescing: the clock reading of the
        # last EVENT-escalated full pass — the first escalation after
        # quiet runs immediately; follow-ups inside the lag budget ride
        # one pending backstop pass
        self._last_escalation_at: Optional[float] = None
        self._deferred: dict = {}            # (model, ns) -> Pending
        # per-source quarantine breakers (utils/backoff.py)
        self._breakers: dict[str, CircuitBreaker] = {}
        self._poller_thread = None
        # failures the consumer logs and survives (a cycle, a consumer
        # iteration, a checkpoint save): counted so a caller can tell a
        # kernel fault inside a micro-cycle from a quiet fleet
        self.failures = {"cycle": 0, "consumer": 0, "checkpoint_save": 0}
        self._maybe_restore()

    # -- knobs ------------------------------------------------------------

    def _knob(self, key: str, default: float) -> float:
        return parse_float_or(
            knob(key, self.rec.state.last_operator_cm), default)

    def _knob_str(self, key: str, default: str = "") -> str:
        return knob(key, self.rec.state.last_operator_cm) or default

    def _epsilon(self) -> float:
        return solve_epsilon(self.rec.state.last_operator_cm)

    def _limited_mode(self) -> bool:
        snap = self.state.snapshot
        cm = snap.operator_cm if snap is not None else {}
        return cm.get("WVA_LIMITED_MODE", "").lower() == "true"

    def _max_groups(self) -> int:
        cap = self._knob("WVA_STREAM_MAX_GROUPS", DEFAULT_MAX_GROUPS)
        return int(min(max(cap, 1.0), HARD_MAX_GROUPS))

    def _max_queue(self) -> int:
        cap = self._knob("WVA_STREAM_MAX_QUEUE", DEFAULT_MAX_QUEUE)
        return int(min(max(cap, 1.0), HARD_MAX_QUEUE))

    def max_body_bytes(self) -> int:
        """Request-body cap for POST /api/v1/write (the 413 threshold;
        read by the ingest middleware)."""
        return int(max(self._knob("WVA_STREAM_MAX_BODY_BYTES",
                                  DEFAULT_MAX_BODY_BYTES), 1024.0))

    def _lag_budget_s(self) -> float:
        ms = self._knob("WVA_STREAM_LAG_BUDGET_MS", DEFAULT_LAG_BUDGET_MS)
        return max(ms, 0.0) / 1000.0

    def pushdown_enabled(self) -> bool:
        """WVA_STREAM_PUSHDOWN: `off` ignores raw-counter series at the
        door (the rule-based contract, byte-for-byte); `auto` (default)
        and `on` derive loads from whatever raw counters arrive."""
        mode = self._knob_str("WVA_STREAM_PUSHDOWN", "auto").strip().lower()
        return mode not in ("off", "false", "0", "disabled")

    # -- quarantine (any thread) ------------------------------------------

    def _breaker(self, source: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(source)
            if br is None:
                threshold = int(max(self._knob(
                    "WVA_STREAM_QUARANTINE_THRESHOLD",
                    DEFAULT_QUARANTINE_THRESHOLD), 1.0))
                br = CircuitBreaker(f"stream-{source}",
                                    failure_threshold=threshold,
                                    reset_after_s=FALLBACK_INTERVAL_S,
                                    clock=self.clock)
                self._breakers[source] = br
            return br

    def source_quarantined(self, source: str) -> bool:
        """True while `source`'s breaker is OPEN (cooldown not yet
        elapsed): the push door answers 429 and the ScrapePoller
        fallback covers the fleet. Once the cooldown elapses the
        breaker reads half-open and one probe is admitted again."""
        with self._lock:
            br = self._breakers.get(source)
        if br is None:
            return False
        return br.state_code() == CircuitBreaker.STATE_CODES[
            CircuitBreaker.OPEN]

    def _vet(self, fields: dict, ts_ms: float,
             now_wall: float) -> Optional[str]:
        """Store-free semantic quarantine verdict for one observation,
        or None if clean. ts_ms is the sample's wall-clock stamp (0 =
        unstamped, e.g. the scrape path — timestamp checks skipped).
        The out-of-order check needs the store's baseline and runs
        inside the batch door's stripe phase instead."""
        for k, v in fields.items():
            if k not in _LOAD_FIELDS:
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                return SHED_QUARANTINE_NAN
            if v != v or v in (float("inf"), float("-inf")):
                return SHED_QUARANTINE_NAN
            if v < 0.0:
                return SHED_QUARANTINE_NEGATIVE
        if ts_ms and ts_ms / 1000.0 > now_wall + FAR_FUTURE_SLACK_S:
            return SHED_QUARANTINE_TIMESTAMP
        return None

    # -- ingest (any thread) ----------------------------------------------

    def _signature(self, load: CollectedLoad) -> tuple:
        """The change detector: the solve inputs snapped to the same
        relative-epsilon buckets the incremental engine sizes on, so
        'unchanged' here means 'the solver would see the same inputs'."""
        eps = self._epsilon()
        return (quantize(load.arrival_rate_rpm, eps),
                round(quantize(load.avg_input_tokens, eps)),
                round(quantize(load.avg_output_tokens, eps)))

    def observe_load(self, model: str, namespace: str,
                     load: CollectedLoad, source: str = SOURCE_SCRAPE,
                     t: Optional[float] = None) -> bool:
        """Fold one complete load observation into the store; enqueue
        the (model, namespace) group when its signature flipped.
        Returns True when a change was enqueued."""
        return self.ingest_fields(
            model, namespace,
            {f: getattr(load, f) for f in _LOAD_FIELDS},
            source=source, t=t)

    def ingest_fields(self, model: str, namespace: str, fields: dict,
                      source: str = SOURCE_REMOTE_WRITE,
                      t: Optional[float] = None) -> bool:
        """Partial-update ingest (remote-write requests may carry any
        subset of the load series). Counts one event per call; a
        signature flip arms the debounced queue. Never raises: a
        quarantined or shed observation reads as 'no change' (the shed
        counter and the breaker still record it — use ingest_push for
        the raising variant the HTTP door needs)."""
        try:
            return self.ingest_push(model, namespace, fields,
                                    source=source, t=t)
        except ShedError:
            return False

    def ingest_push(self, model: str, namespace: str, fields: dict,
                    ts_ms: float = 0.0,
                    source: str = SOURCE_REMOTE_WRITE,
                    t: Optional[float] = None) -> bool:
        """The vetted ingest door: quarantines poisoned observations
        and sheds past the store/queue caps, raising ShedError with the
        metered reason. Returns True when a change was enqueued."""
        reason, changed = self.ingest_batch(
            [(model, namespace, fields, ts_ms)], source=source, t=t)[0]
        if reason is not None:
            raise ShedError(reason, f"{model}/{namespace}: {reason}")
        return changed

    def ingest_batch(self, entries: list,
                     source: str = SOURCE_REMOTE_WRITE,
                     t: Optional[float] = None) -> list:
        """One whole request through the door in three phases: (1)
        store-free vetting plus ONE vectorized epsilon-quantization over
        every entry's samples, (2) one acquisition per touched store
        stripe to fold the groups in and detect signature flips, (3)
        metering and a single batched queue offer. `entries` is
        [(model, namespace, fields, ts_ms), ...]; returns per-entry
        (shed_reason | None, changed) in input order — shed entries are
        already metered (quarantine verdicts feed the source breaker,
        overload sheds raise stream pressure and request a full pass)."""
        now = self.clock() if t is None else t
        breaker = self._breaker(source)
        results: list = [(None, False)] * len(entries)
        now_wall = self.rec.now()
        cap = self._max_groups()
        # phase 1: vet + vectorized quantize (no store locks)
        todo: list = []               # (i, key, clean_fields, ts_ms)
        flat: list = []               # the quantizer's input batch
        spans: dict[int, int] = {}    # entry index -> offset into flat
        for i, (model, ns, fields, ts_ms) in enumerate(entries):
            reason = self._vet(fields, ts_ms, now_wall)
            if reason is not None:
                results[i] = (reason, False)
                continue
            clean = {k: float(v) for k, v in fields.items()
                     if k in _LOAD_FIELDS}
            if all(f in clean for f in _REQUIRED_FIELDS):
                spans[i] = len(flat)
                flat.extend(clean[f] for f in _REQUIRED_FIELDS)
            todo.append((i, (model, ns), clean, float(ts_ms or 0.0)))
        q = quantize_batch(flat, self._epsilon())
        presig = {i: (q[off], round(q[off + 1]), round(q[off + 2]))
                  for i, off in spans.items()}
        # phase 2: one striped acquisition per touched stripe
        by_stripe: dict[int, list] = {}
        for item in todo:
            by_stripe.setdefault(
                self._store.stripe_of(item[1]), []).append(item)
        flips: list = []
        for idx, items in by_stripe.items():
            with self._store.lock_at(idx):
                m = self._store.map_at(idx)
                for i, key, clean, ts_ms in items:
                    acc = m.get(key)
                    if acc is not None and ts_ms and acc.sample_ts_ms \
                            and ts_ms < acc.sample_ts_ms:
                        results[i] = (SHED_QUARANTINE_TIMESTAMP, False)
                        continue
                    if acc is None:
                        if len(self._store) >= min(cap, HARD_MAX_GROUPS):
                            results[i] = (SHED_STORE_FULL, False)
                            continue
                        acc = _Accum()
                        m[key] = acc
                    acc.fields.update(clean)
                    acc.updated_at = now
                    if ts_ms:
                        acc.sample_ts_ms = max(acc.sample_ts_ms, ts_ms)
                    sig = presig.get(i)
                    if sig is None:
                        load = acc.load()
                        sig = (self._signature(load)
                               if load is not None else None)
                    changed = sig is not None and sig != acc.consumed_sig
                    if changed:
                        flips.append((key, source))
                    results[i] = (None, changed)
        # phase 3: metering + ONE batched queue offer (no store locks)
        for reason, _changed in results:
            if reason is None:
                continue
            if reason == SHED_STORE_FULL:
                # the observation is lost but not silently: metered,
                # and a full pass (which re-collects everything) is
                # requested so decisions still converge
                self._shed_overload(reason, source, now)
            else:
                self.emitter.emit_stream_shed(reason)
                breaker.record_failure()
        for reason, _changed in results:
            if reason is None:
                self.emitter.emit_stream_event(source)
                breaker.record_success()
        for _rejected in self.queue.offer_many(flips, t=now):
            # queue at depth cap: the store holds the data, only the
            # scoped wake is lost — coalesce into a full-pass request
            self._shed_overload(SHED_QUEUE_FULL, source, now)
        return results

    def ingest_raw(self, model: str, namespace: str, points: list,
                   source: str = SOURCE_REMOTE_WRITE) -> dict:
        """Advance the raw-counter pushdown ledger for one group
        (stream/pushdown.py): `points` is [(role, fingerprint, value,
        ts_ms), ...]. Returns the derived load fields (possibly empty —
        first sight of an origin series is baseline only); staleness
        markers are accounted on the shed counter but do NOT fail the
        group. Raises ShedError — metered, breaker-recorded — when the
        ledger quarantines the batch."""
        breaker = self._breaker(source)
        try:
            fields, stale = self.pushdown.advance(
                model, namespace, points, self.rec.now())
        except LedgerQuarantine as e:
            self.emitter.emit_stream_shed(e.reason)
            breaker.record_failure()
            raise ShedError(e.reason, str(e)) from e
        for _ in range(stale):
            self.emitter.emit_stream_shed(SHED_STALE_MARKER)
        return fields

    def _shed_overload(self, reason: str, source: str,
                       now: float) -> None:
        """Meter one overload shed, raise stream pressure (the next
        cycle lands on the stream-degraded rung), and fold the lost
        work into a coalesced full-pass request."""
        self.emitter.emit_stream_shed(reason)
        with self._lock:
            self._pressure = reason
        self.queue.request_full(source, t=now)

    def note_kick(self, source: str = SOURCE_WATCH) -> None:
        """A watch event / probe kick: a debounced full-fleet pass."""
        self.emitter.emit_stream_event(source)
        self.queue.request_full(source)

    # -- the consumer (single thread) -------------------------------------

    def on_cycle_start(self, hook) -> None:
        with self._lock:
            self._on_cycle_start = hook

    def _scope_for(self, events: dict) -> tuple[frozenset, dict]:
        """Map drained (model, namespace) events to the variants they
        size, with the store's current loads; marks the drained
        signatures consumed."""
        snap = self.state.snapshot
        mapping: dict[tuple, list[str]] = {}
        if snap is not None:
            for key, va in snap.vas.items():
                mapping.setdefault(
                    (va.spec.model_id, va.namespace), []).append(key)
        scope: set[str] = set()
        loads: dict[str, CollectedLoad] = {}
        for group in events:
            with self._store.lock_for(group):
                acc = self._store.map_for(group).get(group)
                load = acc.load() if acc is not None else None
                if load is not None:
                    acc.consumed_sig = self._signature(load)
            for vkey in mapping.get(group, ()):
                scope.add(vkey)
                if load is not None:
                    loads[vkey] = load
        return frozenset(scope), loads

    def _mark_consumed(self, events: dict) -> None:
        """A full pass re-collects everything: every drained group's
        current signature is now the solved one."""
        for group in events:
            with self._store.lock_for(group):
                acc = self._store.map_for(group).get(group)
                load = acc.load() if acc is not None else None
                if load is not None:
                    acc.consumed_sig = self._signature(load)

    def _absorb_cycle_loads(self, t_start: float) -> None:
        """Fold the loads a full pass actually sized on into the ingest
        store as consumed signatures — a scrape sweep (or push) that
        matches what was just solved must read as 'unchanged'. Entries a
        push updated DURING the pass are left alone: the push is newer
        truth and its event is still pending."""
        loads = dict(self.state.cycle_loads)
        cap = self._max_groups()
        for group, load in loads.items():
            with self._store.lock_for(group):
                m = self._store.map_for(group)
                acc = m.get(group)
                if acc is None:
                    if len(self._store) >= min(cap, HARD_MAX_GROUPS):
                        continue
                    acc = _Accum()
                    m[group] = acc
                elif acc.updated_at > t_start:
                    continue
                acc.fields.update(
                    {f: getattr(load, f) for f in _LOAD_FIELDS})
                acc.updated_at = t_start
                solvable = acc.load()
                if solvable is not None:
                    acc.consumed_sig = self._signature(solvable)
        # bound the store under push abuse / model churn: groups the
        # fleet no longer sizes (absent from every full pass) age
        # out after two backstop intervals without a fresh push
        horizon = t_start - 2.0 * FALLBACK_INTERVAL_S
        for idx in range(N_STRIPES):
            with self._store.lock_at(idx):
                m = self._store.map_at(idx)
                for group in [g for g, acc in m.items()
                              if g not in loads
                              and acc.updated_at < horizon]:
                    del m[group]

    def _merge_deferred_locked(self, events: dict) -> dict:
        """Fold the limited-mode deferral buffer into a full plan's
        drained events (earliest observation wins — the lag histogram
        must measure from the FIRST moment a change was visible).
        Caller holds self._lock."""
        merged = dict(self._deferred)
        for key, pending in events.items():
            prev = merged.get(key)
            if prev is None or pending.t_observed < prev.t_observed:
                merged[key] = pending
        self._deferred = {}
        return merged

    def _defer_events_locked(self, events: dict) -> None:
        """Buffer a limited-mode drain for the ONE coalesced escalation
        pass. Caller holds self._lock. Bounded: past the queue cap the
        extra keys only lose their lag samples — the coalesced full
        pass re-collects every group regardless."""
        for key, pending in events.items():
            prev = self._deferred.get(key)
            if prev is not None:
                if pending.t_observed < prev.t_observed:
                    self._deferred[key] = pending
            elif len(self._deferred) < min(self._max_queue(),
                                           HARD_MAX_QUEUE):
                self._deferred[key] = pending

    def _adapt_debounce(self, n_events: int) -> None:
        """Adaptive debounce ladder: a drain at/over the storm
        threshold doubles the window (up to WVA_STREAM_MAX_DEBOUNCE_MS);
        a drain at half the threshold or less halves it back toward the
        configured base. The asymmetric thresholds are the hysteresis —
        a storm hovering at the boundary cannot make the window flap."""
        if n_events <= 0:
            return
        storm = int(max(self._knob("WVA_STREAM_STORM_EVENTS",
                                   DEFAULT_STORM_EVENTS), 1.0))
        ceil_s = max(self._knob("WVA_STREAM_MAX_DEBOUNCE_MS",
                                DEFAULT_MAX_DEBOUNCE_MS), 0.0) / 1000.0
        with self._lock:
            cur = self._debounce_s
            if n_events >= storm:
                new = min(max(cur * 2.0, self._base_debounce_s),
                          max(ceil_s, self._base_debounce_s))
                widened = True
            elif n_events * 2 <= storm:
                new = max(cur / 2.0, self._base_debounce_s)
                widened = False
            else:
                return
            if new == cur:
                return
            self._debounce_s = new
            if widened:
                self._pressure = PRESSURE_FLOOD
        self.queue.set_window(new)
        self.emitter.emit_stream_debounce_ms(new * 1000.0)

    def _claim_scoped_limited(self, drained) -> Optional[_Plan]:
        """Limited-mode micro-cycle over the flipped variants' pool
        components. Capacity couples variants only through shared chip
        pools, and pool-connected components partition the fleet
        (solver/greedy.pool_components): a component solved against the
        full capacity view is exact, because no variant outside it can
        touch its chips. So a drain whose flipped variants all sit in
        known components with observed loads re-solves ONLY those
        components. Any gap — no snapshot components, no frozen
        capacity, a variant without a component or a member without a
        load, or the expansion reaching the whole fleet — returns None
        and falls through to the escalation/coalescing ladder."""
        snap = self.state.snapshot
        if snap is None or not snap.pool_components or not snap.capacity:
            return None
        mapping: dict[tuple, list] = {}
        for vkey, va in snap.vas.items():
            mapping.setdefault(
                (va.spec.model_id, va.namespace), []).append(vkey)
        flipped: set[str] = set()
        for group in drained.events:
            flipped.update(mapping.get(group, ()))
        if not flipped:
            # events for models outside the fleet: nothing to solve
            return _Plan(kind="drop", events=dict(drained.events))
        expanded: set[str] = set()
        for vkey in flipped:
            members = snap.pool_components.get(vkey)
            if members is None:
                return None
            expanded.update(members)
        if len(expanded) >= len(snap.vas):
            # cross-component storm touched every pool: a scoped pass
            # would be a full pass minus the coalescing valve — escalate
            return None
        loads: dict[str, CollectedLoad] = {}
        for vkey in expanded:
            va = snap.vas.get(vkey)
            if va is None:
                return None
            group = (va.spec.model_id, va.namespace)
            with self._store.lock_for(group):
                acc = self._store.map_for(group).get(group)
                load = acc.load() if acc is not None else None
            if load is None:
                # a coupled member the stream has never sized: the
                # component cannot be re-solved exactly — full pass
                return None
            loads[vkey] = load
        self._mark_consumed(drained.events)
        return _Plan(kind="scoped", events=dict(drained.events),
                     scope=frozenset(expanded), loads=loads,
                     limited=True)

    def _claim(self) -> Optional[_Plan]:
        now = self.clock()
        with self._lock:
            deadline = self._next_full_deadline
        if self.state.snapshot is None or deadline is None \
                or now >= deadline:
            drained = self.queue.drain(now, force=True)
            source = (drained.full.source if drained.full is not None
                      else SOURCE_BACKSTOP)
            with self._lock:
                events = self._merge_deferred_locked(drained.events)
            return _Plan(kind="full", source=source, events=events)
        # escalation valve: a saturated queue or a pending event older
        # than the lag budget means scoped micro-cycles are losing the
        # race — coalesce the whole backlog into ONE backstop full pass
        depth, oldest_age, _ = self.queue.stats(now)
        budget = self._lag_budget_s()
        saturated = depth >= self._max_queue()
        lag_blown = depth > 0 and budget > 0.0 and oldest_age >= budget
        if saturated or lag_blown:
            drained = self.queue.drain(now, force=True)
            source = (drained.full.source if drained.full is not None
                      else SOURCE_BACKSTOP)
            with self._lock:
                self._pressure = (SHED_QUEUE_FULL if saturated
                                  else PRESSURE_LAG_BUDGET)
                events = self._merge_deferred_locked(drained.events)
            return _Plan(kind="full", source=source, events=events)
        drained = self.queue.drain(now)
        if not drained:
            return None
        self._adapt_debounce(len(drained.events))
        if drained.full is not None or self._limited_mode():
            if drained.full is None:
                # pool-scoped limited mode: if every flipped variant's
                # pool-connected component is known, loaded, and smaller
                # than the fleet, re-solve just those components —
                # O(changed component), not O(fleet)
                plan = self._claim_scoped_limited(drained)
                if plan is not None:
                    self.emitter.emit_stream_limited(LANE_SCOPED)
                    return plan
            source = (drained.full.source if drained.full is not None
                      else SOURCE_BACKSTOP)
            with self._lock:
                coalesce = (drained.full is None
                            and self._last_escalation_at is not None
                            and budget > 0.0
                            and now - self._last_escalation_at < budget)
                if coalesce:
                    # limited-mode storm: an escalated pass just ran —
                    # defer this drain onto ONE pending backstop pass
                    # at the lag-budget horizon instead of churning N
                    self._defer_events_locked(drained.events)
                    horizon = self._last_escalation_at + budget
                    if horizon < deadline:
                        self._next_full_deadline = horizon
                    self._pressure = PRESSURE_LIMITED_COALESCE
                    events = None
                else:
                    if drained.full is None:
                        # an event-escalated limited-mode pass anchors
                        # the coalescing window
                        self._last_escalation_at = now
                    events = self._merge_deferred_locked(drained.events)
            if drained.full is None:
                self.emitter.emit_stream_limited(
                    LANE_COALESCED if events is None else LANE_FULL)
            if events is None:
                return None
            return _Plan(kind="full", source=source, events=events)
        scope, loads = self._scope_for(drained.events)
        if not scope:
            # events for models outside the fleet: nothing to solve
            return _Plan(kind="drop", events=drained.events)
        return _Plan(kind="scoped", events=drained.events, scope=scope,
                     loads=loads)

    def _execute(self, plan: _Plan):
        if plan.kind == "drop":
            return None
        with self._lock:
            hook = self._on_cycle_start
            pressure, self._pressure = self._pressure, None
        if hook is not None:
            hook()
        # the cycle serving a pressured backlog is marked: the
        # reconciler folds this into the degradation ladder as the
        # stream-degraded rung (visible on DecisionRecords too)
        with self._lock:
            self.state.stream_pressure = pressure
        result = None
        delay = FALLBACK_INTERVAL_S
        t_start = self.clock()
        try:
            if plan.kind == "full":
                if plan.source == SOURCE_BACKSTOP:
                    self.emitter.emit_stream_event(SOURCE_BACKSTOP)
                result = self.rec.reconcile()
                delay = result.requeue_after
            else:
                if plan.limited:
                    # tell the reconciler the scope is closed under pool
                    # components: it may keep the limited gate down and
                    # solve against the snapshot's frozen capacity
                    with self._lock:
                        self.state.scope_pool_closed = True
                try:
                    result = self.rec.reconcile(scope=plan.scope,
                                                stream_loads=plan.loads)
                finally:
                    if plan.limited:
                        with self._lock:
                            self.state.scope_pool_closed = False
        except Exception as e:  # noqa: BLE001 — run_forever's catch, here
            log.error("stream cycle failed",
                      extra=kv(kind=plan.kind, error=str(e)))
            self._count_failure("cycle")
        with self._lock:
            self.state.stream_pressure = None
        if plan.kind == "full":
            now = self.clock()
            with self._lock:
                self._next_full_deadline = now + max(delay, 0.0)
                snap = self.state.snapshot
                self._scrape_targets = tuple(sorted(
                    {(va.spec.model_id, va.namespace)
                     for va in snap.vas.values()})) if snap else ()
            if result is not None:
                self._absorb_cycle_loads(t_start)
            self._mark_consumed(plan.events)
        if result is not None and plan.events:
            self._observe_lag(plan, result, t_start)
        if result is not None:
            self._maybe_checkpoint()
        return result

    def _count_failure(self, kind: str) -> None:
        with self._lock:
            self.failures[kind] += 1

    def _observe_lag(self, plan: _Plan, result, t_start: float) -> None:
        """load-change observed -> allocation published, per drained
        group whose variants the cycle actually processed; for the same
        groups, the wait in the queue (observed -> the start, `t_start`,
        of the cycle that served it), so lag = wait + service."""
        now = self.clock()
        snap = self.state.snapshot
        published = set(result.processed)
        for group, pending in plan.events.items():
            model, ns = group
            keys = ([k for k, va in snap.vas.items()
                     if va.spec.model_id == model and va.namespace == ns]
                    if snap is not None else [])
            if plan.kind == "full" or any(k in published for k in keys):
                self.emitter.emit_stream_queue_wait(
                    max(t_start - pending.t_observed, 0.0))
                self.emitter.emit_stream_lag(
                    max(now - pending.t_observed, 0.0))

    # -- warm-restart checkpoint (consumer thread) ------------------------

    def _checkpoint_path(self) -> str:
        return self._knob_str("WVA_STREAM_CHECKPOINT")

    def _checkpoint_payload(self) -> dict:
        st = self.state
        snap = st.snapshot
        now = self.clock()
        with self._lock:
            deadline = self._next_full_deadline
        # monotonic readings do not survive a restart: persist AGES
        # relative to now, re-anchored on the restoring clock
        # (items() snapshots stripe by stripe under the stripe locks)
        store = [[m, ns, dict(acc.fields),
                  max(now - acc.updated_at, 0.0), acc.sample_ts_ms,
                  (list(acc.consumed_sig)
                   if acc.consumed_sig is not None else None)]
                 for (m, ns), acc in self._store.items()]
        from ..controller.crd import va_to_dict
        return {
            "taken_at": self.rec.now(),
            "backstop_remaining_s": (max(deadline - now, 0.0)
                                     if deadline is not None else None),
            "snapshot": None if snap is None else {
                "operator_cm": dict(snap.operator_cm),
                "accelerator_cm": snap.accelerator_cm,
                "service_class_cm": dict(snap.service_class_cm),
                "interval_s": snap.interval_s,
                "taken_at": snap.taken_at,
                "vas": {key: va_to_dict(va)
                        for key, va in snap.vas.items()},
                "capacity": dict(snap.capacity),
                "pool_components": {k: sorted(v) for k, v in
                                    snap.pool_components.items()},
            },
            "cross_cycle": {
                "cycle_index": st.cycle_index,
                "recommendations": {k: [list(p) for p in v]
                                    for k, v in st.recommendations.items()},
                "drift_strikes": dict(st.drift_strikes),
                "tpu_util_misses": {k: list(v)
                                    for k, v in st.tpu_util_misses.items()},
                "probe_targets": {k: list(v)
                                  for k, v in st.probe_targets.items()},
                "last_operator_cm": dict(st.last_operator_cm),
                "shared_ns_warned": list(st.shared_ns_warned),
                "last_capacity": dict(st.last_capacity),
            },
            "merged": {name: [[list(k), v]
                              for k, v in getattr(st, name).items()]
                       for name in ("power", "conditions", "drift",
                                    "rungs")},
            "store": store,
        }

    def _maybe_checkpoint(self) -> None:
        path = self._checkpoint_path()
        if not path:
            return
        try:
            save_checkpoint(path, self._checkpoint_payload())
        except Exception as e:  # noqa: BLE001 — checkpointing is best-effort
            log.warning("stream checkpoint save failed",
                        extra=kv(error=str(e)))
            self._count_failure("checkpoint_save")
            return
        self.emitter.emit_stream_checkpoint(CHECKPOINT_SAVE)

    def _maybe_restore(self) -> None:
        """Warm restart: called once from __init__. Every failure mode
        degrades to exactly the cold-start behavior the core had before
        checkpoints existed — metered, logged, never raised."""
        path = self._checkpoint_path()
        if not path or not os.path.exists(path):
            return
        try:
            payload = load_checkpoint(path)
        except CheckpointError as e:
            log.warning("stream checkpoint discarded",
                        extra=kv(reason="corrupt", error=str(e)))
            self.emitter.emit_stream_checkpoint(CHECKPOINT_DISCARD_CORRUPT)
            return
        max_age = max(self._knob("WVA_STREAM_CHECKPOINT_MAX_AGE_S",
                                 DEFAULT_CHECKPOINT_MAX_AGE_S), 0.0)
        age = self.rec.now() - float(payload.get("taken_at") or 0.0)
        if age < 0.0 or age > max_age:
            log.warning("stream checkpoint discarded",
                        extra=kv(reason="stale", age_s=round(age, 3)))
            self.emitter.emit_stream_checkpoint(CHECKPOINT_DISCARD_STALE)
            return
        try:
            self._apply_checkpoint(payload)
        except Exception as e:  # noqa: BLE001 — a bad checkpoint must not block startup
            log.warning("stream checkpoint discarded",
                        extra=kv(reason="unusable", error=str(e)))
            self.emitter.emit_stream_checkpoint(CHECKPOINT_DISCARD_CORRUPT)
            return
        log.info("stream checkpoint restored",
                 extra=kv(age_s=round(age, 3)))
        self.emitter.emit_stream_checkpoint(CHECKPOINT_RESTORE)

    def _apply_checkpoint(self, payload: dict) -> None:
        from ..controller.crd import va_from_dict
        st = self.state
        snap_d = payload.get("snapshot")
        snapshot = None
        if snap_d is not None:
            snapshot = FleetSnapshot(
                operator_cm=dict(snap_d["operator_cm"]),
                accelerator_cm=snap_d["accelerator_cm"],
                service_class_cm=dict(snap_d["service_class_cm"]),
                interval_s=float(snap_d["interval_s"]),
                vas={key: va_from_dict(obj)
                     for key, obj in snap_d["vas"].items()},
                taken_at=float(snap_d["taken_at"]),
                capacity={str(k): int(v) for k, v in
                          snap_d.get("capacity", {}).items()},
                pool_components={str(k): frozenset(v) for k, v in
                                 snap_d.get("pool_components",
                                            {}).items()},
            )
        cc = payload.get("cross_cycle", {})
        merged = payload.get("merged", {})
        store_rows = payload.get("store", [])
        remaining = payload.get("backstop_remaining_s")
        # parse-before-mutate: everything above raised already if the
        # payload is structurally wrong; from here on it is all-or-most
        st.snapshot = snapshot
        st.cycle_index = int(cc.get("cycle_index", 0))
        st.recommendations = {k: [tuple(p) for p in v]
                              for k, v in
                              cc.get("recommendations", {}).items()}
        st.drift_strikes = {k: int(v)
                            for k, v in cc.get("drift_strikes", {}).items()}
        st.tpu_util_misses = {k: tuple(v) for k, v in
                              cc.get("tpu_util_misses", {}).items()}
        st.probe_targets = {k: (str(v[0]), float(v[1])) for k, v in
                            cc.get("probe_targets", {}).items()}
        st.last_operator_cm = dict(cc.get("last_operator_cm", {}))
        st.shared_ns_warned = tuple(cc.get("shared_ns_warned", ()))
        st.last_capacity = {k: int(v)
                            for k, v in cc.get("last_capacity", {}).items()}
        for name in ("power", "conditions", "drift", "rungs"):
            setattr(st, name,
                    {tuple(k): v for k, v in merged.get(name, [])})
        now = self.clock()
        for idx in range(N_STRIPES):
            with self._store.lock_at(idx):
                self._store.map_at(idx).clear()
        for row in store_rows:
            if len(self._store) >= HARD_MAX_GROUPS:
                break
            model, ns, fields, age_s, ts_ms, sig = row
            key = (str(model), str(ns))
            with self._store.lock_for(key):
                self._store.map_for(key)[key] = _Accum(
                    fields={str(k): float(v) for k, v in fields.items()},
                    updated_at=now - max(float(age_s), 0.0),
                    sample_ts_ms=float(ts_ms),
                    consumed_sig=(tuple(sig) if sig is not None
                                  else None),
                )
        with self._lock:
            if remaining is not None:
                self._next_full_deadline = now + max(float(remaining), 0.0)
            self._scrape_targets = tuple(sorted(
                {(va.spec.model_id, va.namespace)
                 for va in snapshot.vas.values()})) if snapshot else ()

    def process_once(self) -> list:
        """Drain-and-execute until nothing is actionable. Synchronous —
        the sim-time twin and the unit tests drive this directly; the
        production thread loops it in run(). Returns the cycles' results."""
        results = []
        while True:
            plan = self._claim()
            if plan is None:
                return results
            result = self._execute(plan)
            if result is not None:
                results.append(result)
            if plan.kind == "drop":
                return results

    def run(self, stop: threading.Event) -> None:
        """The production consumer loop: process, then sleep until the
        earliest of (debounce window closing, backstop deadline), woken
        immediately by the first offer after idle. Joins the scrape
        poller on the way out — no thread outlives the stop event."""
        from .ingest import ScrapePoller

        poller = ScrapePoller(self, stop)
        thread = poller.start()
        with self._lock:
            self._poller_thread = thread
        while not stop.is_set():
            try:
                self.process_once()
            except Exception as e:  # noqa: BLE001 — consumer must not die
                log.error("stream consumer iteration failed",
                          extra=kv(error=str(e)))
                self._count_failure("consumer")
            now = self.clock()
            with self._lock:
                deadline = self._next_full_deadline
            deadlines = [d for d in (deadline, self.queue.next_deadline())
                         if d is not None]
            timeout = (min(deadlines) - now) if deadlines else 0.5
            if self.queue.wait(min(max(timeout, 0.01), 0.5)):
                # an offer landed: sleep out the remainder of its window
                # (the wake flag stays set until the queue drains, so
                # pace on `stop` to avoid a busy loop)
                nd = self.queue.next_deadline()
                if nd is not None:
                    stop.wait(min(max(nd - self.clock(), 0.0), 0.5))
        if thread is not None:
            thread.join(timeout=5.0)

    def scrape_targets(self) -> tuple:
        with self._lock:
            return self._scrape_targets
