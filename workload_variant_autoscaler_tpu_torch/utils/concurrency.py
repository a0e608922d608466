"""Bounded deterministic fan-out for per-variant dependency calls.

The fleet-scale collection work (grouped PromQL, one-LIST kube
snapshots) removes the O(variants) READ traffic from the reconcile
cycle, but a residue of unavoidably per-variant calls remains: status
writes and fresh-gets in `_apply`, ownerReference patches, per-namespace
TPU-utilization probes. Run sequentially they re-impose O(V) wall time
on every cycle; this module fans them out over a small thread pool
(`WVA_COLLECT_FANOUT` workers) with the properties the rest of the
pipeline depends on:

- **Submission-order results.** `fanout()` returns one (result, error)
  pair per task, in the order the tasks were given — callers iterate
  their variant list and get answers aligned with it, whatever order
  the pool completed them in.
- **Per-task error capture.** A task that raises yields its exception
  in its slot; one failing variant never aborts its siblings (the same
  isolation the sequential loops had via per-variant try/except).
- **Trace propagation.** Every task runs inside a COPY of the caller's
  contextvars context, so spans opened by the task (the `kube.<verb>`
  spans from `_kube_call`, `prometheus.query` spans) nest under the
  span active at submission time and the fanned-out cycle still renders
  as ONE trace (obs/trace.py).
- **Inline degenerate path.** `workers <= 1` (or a single task) runs on
  the calling thread in submission order — `WVA_COLLECT_FANOUT=1` is a
  strict-determinism escape hatch for scheduling-sensitive scenarios
  (e.g. probabilistic FaultPlans, whose per-rule RNG draws follow call
  order).

Deadline/breaker integration comes for free: tasks go through the same
`_kube_call`/GuardedPromAPI wrappers as before, `Deadline` is read-only
after construction, and `CircuitBreaker` is lock-guarded (see
utils/backoff.py), so the budget and per-dependency failure isolation
hold across worker threads.
"""

from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, TypeVar

from .knobs import knob

T = TypeVar("T")

FANOUT_ENV = "WVA_COLLECT_FANOUT"
DEFAULT_FANOUT_WORKERS = 8


def fanout_workers(cm: Optional[dict] = None) -> int:
    """The configured fan-out width: WVA_COLLECT_FANOUT env first, then
    the operator ConfigMap (standard knob precedence), default 8;
    values below 1 clamp to 1 (sequential)."""
    try:
        workers = int(float(knob(FANOUT_ENV, cm)))
    except ValueError:
        return DEFAULT_FANOUT_WORKERS
    return max(workers, 1)


def fanout(
    tasks: Sequence[Callable[[], T]],
    workers: int = DEFAULT_FANOUT_WORKERS,
    label: str = "fanout",
) -> list[tuple[Optional[T], Optional[BaseException]]]:
    """Run `tasks` with at most `workers` threads; returns one
    (result, error) pair per task in SUBMISSION order. Exactly one of
    the pair is non-None (a task returning None reads as (None, None)).
    Each task executes in a copy of the submitting thread's contextvars
    context (active trace span included)."""
    if not tasks:
        return []

    def bind(fn: Callable[[], T]):
        # the context is copied on the SUBMITTING thread — worker
        # threads start with an empty context and would otherwise lose
        # the cycle's active span
        ctx = contextvars.copy_context()

        def run() -> tuple[Optional[T], Optional[BaseException]]:
            try:
                return ctx.run(fn), None
            except BaseException as e:  # noqa: BLE001 - captured per task
                return None, e

        return run

    bound = [bind(fn) for fn in tasks]
    if workers <= 1 or len(bound) == 1:
        return [run() for run in bound]
    with ThreadPoolExecutor(max_workers=min(workers, len(bound)),
                            thread_name_prefix=f"wva-{label}") as pool:
        futures = [pool.submit(run) for run in bound]
        return [f.result() for f in futures]
