"""Discrete-event TPU serving emulator.

Role model: the reference's vLLM emulator (the Go reference's
tools/vllm-emulator/vllm_model.py) — an OpenAI-compatible fake server whose
`vllm:*` metrics feed the autoscaler in a GPU/TPU-free loop. This rebuild
is TPU-shaped and *batch-aware*: iteration time follows the same fitted
linear models the analyzer uses,

    decode(b) = alpha + beta * b          (msec per output token)
    prefill(b) = gamma + delta * in_tokens * b

so closed-loop convergence tests exercise the analyzer against a workload
that actually behaves like its model (the reference's emulator uses a
constant 50 ms decode step instead, server.py:22-33). Memory is HBM per
slice with a KV-cache budget; admission respects max batch + KV headroom
and waiting requests queue FIFO (continuous batching).

The core engine is single-threaded and event-driven in *simulated time* —
no sleeps — so a full ShareGPT-style ramp runs in milliseconds of wall
clock. `emulator.server` wraps the same engine for real-time HTTP serving.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import get_logger

log = get_logger("wva.emulator")


@dataclass
class SliceModelConfig:
    """One (model x slice shape) serving configuration."""

    model_name: str
    slice_name: str = "v5e-1"
    alpha: float = 6.973       # msec
    beta: float = 0.027
    gamma: float = 5.2
    delta: float = 0.1
    max_batch_size: int = 64
    hbm_gb: float = 16.0       # per slice
    usable_ratio: float = 0.8
    model_size_gb: float = 8.0
    kv_mb_per_token: float = 0.5

    def decode_ms(self, batch: int) -> float:
        return self.alpha + self.beta * batch

    def prefill_ms(self, in_tokens: int, batch: int) -> float:
        if in_tokens <= 0:
            return 0.0
        return self.gamma + self.delta * in_tokens * batch

    @property
    def kv_budget_mb(self) -> float:
        return self.hbm_gb * 1024.0 * self.usable_ratio - self.model_size_gb * 1024.0


@dataclass
class Request:
    req_id: int
    in_tokens: int
    out_tokens: int
    arrival_ms: float
    admitted_ms: float = -1.0
    prefill_remaining_ms: float = 0.0
    first_token_ms: float = -1.0
    tokens_out: int = 0
    finished_ms: float = -1.0
    on_finish: Optional[Callable[["Request"], None]] = None

    @property
    def kv_tokens(self) -> int:
        return self.in_tokens + self.tokens_out

    @property
    def ttft_ms(self) -> float:
        return self.first_token_ms - self.arrival_ms

    @property
    def e2e_ms(self) -> float:
        return self.finished_ms - self.arrival_ms


class Replica:
    """One serving replica on one slice: continuous batching over a running
    set bounded by max batch and KV memory, FIFO waiting queue."""

    def __init__(self, config: SliceModelConfig, sink: "MetricsSink",
                 reroute: Optional[Callable[["Request", float], None]] = None):
        self.config = config
        self.sink = sink
        self.running: list[Request] = []
        self.waiting: list[Request] = []
        self.draining = False
        # where evicted work goes when this replica is draining and will
        # never re-admit it (Fleet.dispatch); None = standalone replica
        self.reroute = reroute

    # -- memory ----------------------------------------------------------

    def kv_used_mb(self) -> float:
        return sum(r.kv_tokens for r in self.running) * self.config.kv_mb_per_token

    def _fits(self, req: Request) -> bool:
        if len(self.running) + 1 > self.config.max_batch_size:
            return False
        # headroom for the incoming context + one token for everyone
        needed = (req.kv_tokens + len(self.running) + 1) * self.config.kv_mb_per_token
        return self.kv_used_mb() + needed <= self.config.kv_budget_mb

    # -- queue management ------------------------------------------------

    def enqueue(self, req: Request, now_ms: float, *, fresh: bool = True) -> None:
        if fresh:
            self.sink.on_arrival(req)
        if not self.waiting and self._fits(req):
            self._admit(req, now_ms)
        else:
            self.waiting.append(req)
        self.sink.set_queue_sizes(len(self.running), len(self.waiting))

    def _admit(self, req: Request, now_ms: float) -> None:
        req.admitted_ms = now_ms
        batch = len(self.running) + 1
        req.prefill_remaining_ms = self.config.prefill_ms(req.in_tokens, batch)
        self.running.append(req)

    def _admit_waiting(self, now_ms: float) -> None:
        while self.waiting and self._fits(self.waiting[0]):
            self._admit(self.waiting.pop(0), now_ms)

    def evict_if_needed(self, now_ms: float = 0.0) -> None:
        """KV pressure: move the newest running request back to the queue
        head (mirrors the reference's tail eviction, vllm_model.py:402-413).
        A draining replica will never re-admit, so its victims reroute to
        the fleet instead of stranding in a queue nobody serves."""
        while (
            self.running
            and self.kv_used_mb() + len(self.running) * self.config.kv_mb_per_token
            > self.config.kv_budget_mb
        ):
            victim = self.running.pop()
            victim.prefill_remaining_ms = 0.0
            if self.draining and self.reroute is not None:
                self.reroute(victim, now_ms)
            else:
                self.waiting.insert(0, victim)

    # -- the decode iteration --------------------------------------------

    def busy(self) -> bool:
        return bool(self.running)

    def step(self, now_ms: float) -> float:
        """Run one decode iteration; returns its duration in msec."""
        batch = len(self.running)
        if batch == 0:
            return 0.0
        dt = self.config.decode_ms(batch)
        finished: list[Request] = []
        for req in self.running:
            if req.prefill_remaining_ms > 0:
                req.prefill_remaining_ms -= dt
                if req.prefill_remaining_ms > 0:
                    continue
                # prefill (or post-eviction recompute) just completed
                if req.first_token_ms < 0:
                    req.first_token_ms = now_ms + dt + req.prefill_remaining_ms
                    self.sink.on_first_token(req)
                    req.tokens_out = max(req.tokens_out, 1)
            else:
                req.tokens_out += 1
                self.sink.on_token(dt)
            if req.tokens_out >= req.out_tokens:
                req.finished_ms = now_ms + dt
                finished.append(req)
        for req in finished:
            self.running.remove(req)
            self.sink.on_finish(req)
            if req.on_finish is not None:
                req.on_finish(req)
        self.evict_if_needed(now_ms + dt)
        if not self.draining:
            self._admit_waiting(now_ms + dt)
        self.sink.set_queue_sizes(len(self.running), len(self.waiting))
        self.sink.set_kv_usage(self.kv_used_mb() / max(self.config.kv_budget_mb, 1e-9))
        return dt


class MetricsSink:
    """Abstract observation hooks; implemented by emulator.metrics
    (prometheus series) and by in-test recorders."""

    def on_arrival(self, req: Request) -> None: ...
    def on_first_token(self, req: Request) -> None: ...
    def on_token(self, dt_ms: float) -> None: ...
    def on_finish(self, req: Request) -> None: ...
    def set_queue_sizes(self, running: int, waiting: int) -> None: ...
    def set_kv_usage(self, frac: float) -> None: ...


class _FleetSink(MetricsSink):
    """Per-replica sink wrapper: forwards event hooks unchanged but
    republishes the queue/KV gauges as fleet-wide totals (a lone replica
    would otherwise overwrite them with just its own counts)."""

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    def on_arrival(self, req: Request) -> None:
        self._fleet.sink.on_arrival(req)

    def on_first_token(self, req: Request) -> None:
        self._fleet.sink.on_first_token(req)

    def on_token(self, dt_ms: float) -> None:
        self._fleet.sink.on_token(dt_ms)

    def on_finish(self, req: Request) -> None:
        self._fleet.sink.on_finish(req)

    def set_queue_sizes(self, running: int, waiting: int) -> None:
        f = self._fleet
        everyone = f.all_replicas()
        f.sink.set_queue_sizes(
            sum(len(r.running) for r in everyone),
            sum(len(r.waiting) for r in everyone) + len(f.gateway_backlog),
        )

    def set_kv_usage(self, frac: float) -> None:
        f = self._fleet
        everyone = f.all_replicas()
        budget = len(everyone) * f.config.kv_budget_mb
        used = sum(r.kv_used_mb() for r in everyone)
        f.sink.set_kv_usage(used / budget if budget > 0 else 0.0)


class Fleet:
    """N replicas behind least-loaded dispatch, resizable at runtime (the
    autoscaler's actuation surface in closed-loop tests)."""

    def __init__(self, config: SliceModelConfig, sink: MetricsSink, replicas: int = 1):
        self.config = config
        self.sink = sink
        self._replica_sink = _FleetSink(self)
        self._reroute = lambda req, now_ms: self.dispatch(req, now_ms, fresh=False)
        self.replicas: list[Replica] = [
            Replica(config, self._replica_sink, self._reroute)
            for _ in range(replicas)
        ]
        self.draining_replicas: list[Replica] = []
        # requests that arrived while scaled to zero: held at the "gateway"
        # (llm-d queues ahead of the backends; arrivals must stay visible
        # to the autoscaler or scale-from-zero has no trigger)
        self.gateway_backlog: list[Request] = []

    def size(self) -> int:
        return len(self.replicas)

    def all_replicas(self) -> list[Replica]:
        """Active + draining — everything that still needs decode steps."""
        return self.replicas + self.draining_replicas

    def set_replicas(self, n: int, now_ms: float) -> None:
        n = max(n, 0)
        if n > len(self.replicas):
            # scale-up can reuse a draining replica's weights immediately
            # (pod not gone yet) — reactivate before creating fresh ones
            while self.draining_replicas and len(self.replicas) < n:
                r = self.draining_replicas.pop()
                r.draining = False
                self.replicas.append(r)
            while len(self.replicas) < n:
                self.replicas.append(
                    Replica(self.config, self._replica_sink, self._reroute)
                )
            self._rebalance_waiting(now_ms)
        if n < len(self.replicas):
            # graceful drain, like a terminating vLLM pod behind llm-d:
            # retire the emptiest replicas; their running requests finish
            # in place (decode progress is never recomputed), their queued
            # requests move to the survivors
            self.replicas.sort(
                key=lambda r: len(r.running) + len(r.waiting), reverse=True
            )
            retire = self.replicas[n:]
            self.replicas = self.replicas[:n]
            for r in retire:
                r.draining = True
                backlog, r.waiting = r.waiting, []
                if r.running:
                    self.draining_replicas.append(r)
                for req in backlog:
                    self.dispatch(req, now_ms, fresh=False)

    def reap_drained(self) -> None:
        """Forget draining replicas that have finished their work."""
        self.draining_replicas = [
            r for r in self.draining_replicas if r.running or r.waiting
        ]

    def _rebalance_waiting(self, now_ms: float) -> None:
        """Spread not-yet-admitted (waiting) requests across all replicas.
        Models llm-d's shared gateway queue: queued work hasn't started
        anywhere, so new replicas take their share immediately."""
        backlog, self.gateway_backlog = self.gateway_backlog, []
        for r in self.replicas:
            backlog.extend(r.waiting)
            r.waiting = []
        backlog.sort(key=lambda q: q.arrival_ms)
        for req in backlog:
            self.dispatch(req, now_ms, fresh=False)

    def dispatch(self, req: Request, now_ms: float, *, fresh: bool = True) -> None:
        if fresh:
            self.sink.on_arrival(req)
        if not self.replicas:
            # scaled to zero: hold at the gateway until capacity returns
            self.gateway_backlog.append(req)
            self._replica_sink.set_queue_sizes(0, 0)
            return
        target = min(self.replicas, key=lambda r: len(r.running) + len(r.waiting))
        target.enqueue(req, now_ms, fresh=False)


@dataclass(order=True)
class _Event:
    at_ms: float
    seq: int
    kind: str = field(compare=False)
    payload: object = field(compare=False, default=None)


class Simulation:
    """Event loop in simulated time: arrivals (from a load generator) and
    per-replica decode iterations.

    Drives one fleet or several (multi-variant closed loops, BASELINE
    configs 2/5): pass a list of fleets and give each load generator its
    own target via `submit(req, fleet=...)`."""

    def __init__(self, fleet: Fleet | list[Fleet], seed: int = 0):
        self.fleets: list[Fleet] = (
            list(fleet) if isinstance(fleet, (list, tuple)) else [fleet]
        )
        if not self.fleets:
            raise ValueError("Simulation needs at least one fleet")
        self.now_ms = 0.0
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.rng = random.Random(seed)
        self._replica_busy: set[int] = set()  # id(replica)

    @property
    def fleet(self) -> Fleet:
        """The single-fleet view (first fleet) for existing callers."""
        return self.fleets[0]

    def schedule(self, delay_ms: float, kind: str, payload=None) -> None:
        heapq.heappush(
            self._heap, _Event(self.now_ms + delay_ms, next(self._seq), kind, payload)
        )

    def submit(self, req: Request, fleet: Optional[Fleet] = None) -> None:
        (fleet or self.fleets[0]).dispatch(req, self.now_ms)
        self.kick()

    def kick(self) -> None:
        """Ensure every replica with work has a step event scheduled (call
        after externally resizing/rebalancing the fleet)."""
        self._kick_replicas()

    def _all_replicas(self) -> list[Replica]:
        if len(self.fleets) == 1:
            return self.fleets[0].all_replicas()
        return [r for f in self.fleets for r in f.all_replicas()]

    def _kick_replicas(self) -> None:
        for replica in self._all_replicas():
            if replica.busy() and id(replica) not in self._replica_busy:
                self._replica_busy.add(id(replica))
                self.schedule(0.0, "step", replica)

    def run_until(self, t_ms: float, on_tick=None, tick_ms: float = 1000.0) -> None:
        next_tick = (self.now_ms // tick_ms + 1) * tick_ms
        while self._heap and self._heap[0].at_ms <= t_ms:
            if on_tick is not None and self._heap[0].at_ms >= next_tick:
                self.now_ms = next_tick
                on_tick(self.now_ms)
                next_tick += tick_ms
                continue
            ev = heapq.heappop(self._heap)
            self.now_ms = ev.at_ms
            if ev.kind == "step":
                replica = ev.payload
                if replica not in self._all_replicas():
                    self._replica_busy.discard(id(replica))
                    continue
                dt = replica.step(self.now_ms)
                if replica.busy():
                    self.schedule(dt, "step", replica)
                else:
                    self._replica_busy.discard(id(replica))
                    for f in self.fleets:
                        f.reap_drained()
                if replica.draining:
                    # eviction under drain reroutes work to replicas that
                    # may be idle — make sure they get a step event
                    self._kick_replicas()
            elif ev.kind == "arrival":
                self.submit(ev.payload)
            elif ev.kind == "call":
                ev.payload(self.now_ms)
        # drain ticks up to t_ms even when idle
        if on_tick is not None:
            while next_tick <= t_ms:
                self.now_ms = next_tick
                on_tick(self.now_ms)
                next_tick += tick_ms
        self.now_ms = max(self.now_ms, t_ms)
