"""Retry, deadline, and circuit-breaker primitives for control-plane calls.

Equivalent of the reference's wait.Backoff wrappers (the Go reference's
internal/utils/utils.go:31-104) — a handful of presets and a retry helper
that distinguishes terminal from transient errors — extended with the two
mechanisms the reference leaves to controller-runtime:

- `Deadline`: a per-cycle retry budget. A reconcile cycle that spends its
  whole interval inside nested backoff loops is pure badput (PAPERS.md,
  ML Productivity Goodput): the cycle must FAIL, land in a documented
  degraded state, and let the next cycle run, rather than spin.
- `CircuitBreaker`: per-dependency failure isolation. When Prometheus or
  the apiserver is down, every cycle re-paying a full backoff per call
  turns one outage into N*steps sleeps; the breaker fails fast while
  open and re-probes with a single half-open call.
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

from ..obs.trace import add_event

T = TypeVar("T")

# with_backoff observer events / retry-counter outcomes
# (inferno_dependency_retries_total{outcome=...})
RETRY = "retry"              # transient failure, another attempt scheduled
EXHAUSTED = "exhausted"      # backoff steps spent, last error propagates
DEADLINE = "deadline"        # cycle budget spent, DeadlineExceeded raised
CIRCUIT_OPEN = "circuit-open"  # breaker open, call failed fast


class TerminalError(Exception):
    """Not worth retrying (e.g. NotFound on a get, Invalid on an update)."""


class DeadlineExceeded(Exception):
    """The retry budget for this cycle is spent: stop, don't spin."""


@dataclass(frozen=True)
class Backoff:
    duration: float  # initial sleep, seconds
    factor: float = 2.0
    jitter: float = 0.0
    steps: int = 5


# Presets (reference utils.go:33-55)
STANDARD_BACKOFF = Backoff(duration=0.1, factor=2.0, jitter=0.1, steps=5)
RECONCILE_BACKOFF = Backoff(duration=0.5, factor=2.0, steps=5)
PROMETHEUS_BACKOFF = Backoff(duration=5.0, factor=2.0, jitter=0.1, steps=6)  # ~5 min


class Deadline:
    """Wall-clock budget shared by every retry loop in one reconcile
    cycle. `clock` is injectable so sim-time tests stay deterministic."""

    def __init__(self, budget_s: float = math.inf,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._start = clock()
        self.budget_s = budget_s

    @classmethod
    def unlimited(cls) -> "Deadline":
        return cls(math.inf)

    def elapsed(self) -> float:
        return self._clock() - self._start

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


def with_backoff(
    fn: Callable[[], T],
    backoff: Backoff = STANDARD_BACKOFF,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    deadline: Optional[Deadline] = None,
    observer: Optional[Callable[..., None]] = None,
) -> T:
    """Run fn with jittered exponential backoff. TerminalError propagates
    immediately; other exceptions retry until steps are exhausted, then the
    last one propagates.

    rng: jitter source (None = the module-level random). Injecting a
    seeded Random makes retry timing reproducible — the chaos suite's
    no-wall-clock-randomness rule.
    deadline: per-cycle budget. When the budget is spent — or cannot
    cover the next sleep — DeadlineExceeded is raised (chained to the
    last transient error) instead of sleeping past it: a cycle must fail
    visibly rather than eat its whole interval retrying.
    observer: ladder telemetry hook, `observer(event, **fields)` with
    event one of RETRY/EXHAUSTED/DEADLINE — how the reconciler feeds the
    inferno_dependency_retries_total counter without this module knowing
    about metrics. Every event is also recorded on the active trace span
    (obs/trace.py; no-op outside a trace), so a cycle's trace shows each
    retry and how long its backoff slept.
    """
    rand = rng.random if rng is not None else random.random

    def note(event: str, **fields) -> None:
        add_event(f"backoff-{event}", **fields)
        if observer is not None:
            observer(event, **fields)

    delay = backoff.duration
    last: Exception | None = None
    for step in range(backoff.steps):
        if deadline is not None and deadline.expired():
            note(DEADLINE, attempt=step, error=str(last))
            raise DeadlineExceeded(
                f"cycle budget {deadline.budget_s:.1f}s spent before the "
                "call could be attempted"
            ) from last
        try:
            return fn()
        except TerminalError:
            raise
        except Exception as e:  # noqa: BLE001 - transient by contract
            last = e
            if step == backoff.steps - 1:
                break
            d = delay
            if backoff.jitter > 0:
                d += delay * backoff.jitter * rand()
            if deadline is not None and d > deadline.remaining():
                note(DEADLINE, attempt=step, error=str(last))
                raise DeadlineExceeded(
                    f"next retry sleep {d:.2f}s exceeds the remaining "
                    f"cycle budget {max(deadline.remaining(), 0.0):.2f}s"
                ) from last
            note(RETRY, attempt=step, sleep_s=round(d, 4), error=str(e))
            sleep(d)
            delay *= backoff.factor
    assert last is not None
    note(EXHAUSTED, attempt=backoff.steps - 1, error=str(last))
    raise last


class CircuitOpenError(Exception):
    """The dependency's breaker is open: failing fast, not calling."""

    def __init__(self, dependency: str, retry_in_s: float):
        self.dependency = dependency
        self.retry_in_s = retry_in_s
        super().__init__(
            f"circuit for {dependency!r} is open; next probe in "
            f"{max(retry_in_s, 0.0):.1f}s"
        )


class CircuitBreaker:
    """Per-dependency circuit breaker: closed -> open after
    `failure_threshold` consecutive failures, half-open after
    `reset_after_s` (one probe: success closes, failure re-opens).

    TerminalError does NOT count as a dependency failure — a NotFound is
    the dependency answering correctly — and propagates untouched.
    `clock` is injectable (sim time). State transitions are guarded by a
    lock (the WVA_COLLECT_FANOUT workers call kube/prometheus through
    the shared breakers concurrently); the wrapped call itself runs
    OUTSIDE the lock, so the breaker never serializes the fan-out. Under
    concurrency more than one half-open probe may slip through before
    the first records its outcome — a bounded overshoot, not a
    correctness issue.

    `on_transition(name, old_state, new_state)` fires on every state
    change (under the lock — keep it fast, as the reconciler's
    log-and-emit hook is); each transition is also recorded on the
    active trace span, so a cycle's trace shows exactly when a
    dependency's circuit opened, half-opened, or closed.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    # stable numeric encoding for the inferno_circuit_state gauge
    STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, name: str, failure_threshold: int = 3,
                 reset_after_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str, str], None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self.on_transition = on_transition
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._lock = threading.RLock()

    def _set_state_locked(self, state: str) -> None:
        # caller holds self._lock (the *_locked naming convention the
        # lint gate's WVL401 lock-discipline check recognises)
        if state == self.state:
            return
        old, self.state = self.state, state
        add_event("breaker-transition", dependency=self.name,
                  from_state=old, to_state=state)
        if self.on_transition is not None:
            self.on_transition(self.name, old, state)

    def state_code(self) -> int:
        # report what the NEXT call would see: an open breaker whose
        # cooldown has elapsed is effectively half-open
        with self._lock:
            state = self.state
            if state == self.OPEN and \
                    self._clock() - self._opened_at >= self.reset_after_s:
                state = self.HALF_OPEN
            return self.STATE_CODES[state]

    def _open_locked(self) -> None:
        self._set_state_locked(self.OPEN)
        self._opened_at = self._clock()

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._set_state_locked(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == self.HALF_OPEN or \
                    self.consecutive_failures >= self.failure_threshold:
                self._open_locked()

    def call(self, fn: Callable[[], T]) -> T:
        with self._lock:
            if self.state == self.OPEN:
                waited = self._clock() - self._opened_at
                if waited < self.reset_after_s:
                    add_event("breaker-open-fast-fail",
                              dependency=self.name,
                              retry_in_s=round(
                                  self.reset_after_s - waited, 3))
                    raise CircuitOpenError(self.name,
                                           self.reset_after_s - waited)
                self._set_state_locked(self.HALF_OPEN)  # one probe goes through
        try:
            result = fn()
        except TerminalError:
            # the dependency responded; a terminal verdict is not an
            # availability failure, and must not trip the breaker
            self.record_success()
            raise
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result
