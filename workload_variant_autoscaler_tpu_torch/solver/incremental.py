"""Incremental steady-state solve engine: signature-gated re-solving.

Counterpart of the reference package's `solver/incremental.py` (the flat
engine). Analyze + optimize becomes O(changed variants):

1. **Input signatures.** Every variant's solve inputs (quantized load,
   relative epsilon `WVA_SOLVE_EPSILON`; SLO target, profile
   coefficients, candidate-accelerator catalog entries, server bounds,
   degradation rung) fold into a per-variant signature. An unchanged
   signature reuses last cycle's cached per-candidate allocations and
   skips those lanes, the zero-load fast path included.
2. **Resident candidate arena** (ops/arena.py, attached to the System):
   the changed sub-batch is packed into persistent bucketed buffers.
3. **Warm-started greedy** (solver/greedy.py `solve_greedy_warm`): the
   capacity-aware solve seeds from the previous cycle's choices and
   recomputes only the chip pools touched by changed variants, falling
   back to a full solve whenever capacity, the candidate set, the
   cycle's degradation rung or the engine configuration changes, and
   unconditionally every `full_every` cycles.

Correctness contract: an incremental cycle publishes the allocations a
from-scratch solve over the same (quantized) inputs publishes, bit for
bit. The quantizer is a pure function, a lane's decision does not depend
on the batch around it, and cached entries are exact solve outputs whose
values are re-derived against the live current allocation each cycle.

Load quantization is the one deliberate semantic of incremental mode:
sizing consumes load snapped to a relative-epsilon bucket (default 2%),
which makes "unchanged" a stable property under jitter.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

from ..models import System
from ..models.allocation import replica_demand
from ..models.spec import OptimizerSpec, ServerLoadSpec
from ..models.system import fused_solve_enabled
from ..ops.arena import CandidateArena
from .solver import WarmStart

log = logging.getLogger("wva.solver.incremental")

DEFAULT_EPSILON = 0.02
DEFAULT_FULL_EVERY = 32

# solve_mode values per variant
SOLVE_FULL = "full"              # every lane re-solved from scratch
SOLVE_INCREMENTAL = "incremental"  # changed variant, lanes re-solved
SOLVE_CACHED = "cached"          # unchanged signature, lanes skipped
SOLVE_MODES = (SOLVE_FULL, SOLVE_INCREMENTAL, SOLVE_CACHED)


def quantize(value: float, epsilon: float) -> float:
    """Snap a positive value to a relative-epsilon log bucket. Pure:
    equal buckets always produce the equal representative, so the
    signature and the solve consume the same number. epsilon <= 0 (or a
    non-positive value) passes through untouched."""
    if epsilon <= 0 or value <= 0 or not math.isfinite(value):
        return value
    step = math.log1p(epsilon)
    return math.exp(round(math.log(value) / step) * step)


@lru_cache(maxsize=1 << 16)
def _quantized_load(arrival_rate: float, avg_in_tokens: int,
                    avg_out_tokens: int, epsilon: float) -> ServerLoadSpec:
    # ServerLoadSpec is frozen, so the memoized instance can be shared by
    # every server that lands in the same bucket
    return ServerLoadSpec(
        arrival_rate=quantize(arrival_rate, epsilon),
        avg_in_tokens=int(round(quantize(avg_in_tokens, epsilon))),
        avg_out_tokens=int(round(quantize(avg_out_tokens, epsilon))),
    )


def quantize_load(load: Optional[ServerLoadSpec],
                  epsilon: float) -> Optional[ServerLoadSpec]:
    """Quantized view of a server load: arrival rate and token means
    snapped to epsilon buckets (token means re-rounded to ints, the
    spec's type). Zero/negative components pass through, so the
    zero-load fast path and the invalid-load guards see exact values."""
    if load is None or epsilon <= 0:
        return load
    return _quantized_load(load.arrival_rate, load.avg_in_tokens,
                           load.avg_out_tokens, epsilon)


@dataclass
class SolveStats:
    """One cycle's incremental-solve telemetry."""

    full: bool
    reason: str = ""
    lanes_solved: int = 0
    lanes_skipped: int = 0
    modes: dict = field(default_factory=dict)  # mode -> variant count
    # the hierarchical engine's telemetry (solver/hierarchy.py); zeros
    # on the flat engine, so consumers need no isinstance
    shards: int = 0         # super-shards in this cycle's partition
    shards_solved: int = 0  # shards that dispatched any lanes
    restored: bool = False  # first cycle after a warm checkpoint restore


class IncrementalSolveEngine:
    """Persistent (across cycles) signature cache + arena + warm-start
    state. Single-threaded by design: one reconcile loop calls it."""

    def __init__(self, epsilon: float = DEFAULT_EPSILON,
                 full_every: int = DEFAULT_FULL_EVERY):
        self.epsilon = epsilon
        self.full_every = max(int(full_every), 0)
        self.arena = CandidateArena()
        self._cycle = 0
        # server name -> signature of the lane inputs the cache entry
        # was solved from, and the pristine allocation clones themselves
        self._lane_sigs: dict[str, tuple] = {}
        self._alloc_cache: dict[str, dict] = {}
        # committed at finish_cycle: the last COMPLETED solve's state
        self._prev_choice: dict = {}
        self._prev_pools: dict[str, tuple] = {}
        self._prev_value_sigs: dict[str, tuple] = {}
        self._prev_solve_sig: Optional[tuple] = None
        self._prev_complete = False
        # scratch between calculate() and finish_cycle()
        self._pending_value_sigs: dict[str, tuple] = {}
        self._pending_solve_sig: Optional[tuple] = None
        self._analyze_sig: Optional[tuple] = None
        self._changed_for_solver: frozenset = frozenset()
        self._warm_ok = False
        self.solve_modes: dict[str, str] = {}
        self.last_stats: Optional[SolveStats] = None

    # -- signatures -------------------------------------------------------

    @staticmethod
    def _candidate_entries(system: System, server) -> tuple:
        model = system.models.get(server.model_name)
        out = []
        for acc_name in sorted(server.candidate_accelerators(
                system.accelerators)):
            acc = system.accelerators[acc_name]
            profile = model.profile(acc_name) if model is not None else None
            # the per-candidate cost rate is an epilogue input of the
            # fused decision, named so a cost or slices-per-replica
            # change can never ride a cached lane
            cost_rate = (acc.spec.cost * model.num_instances(acc_name)
                         if model is not None else 0.0)
            out.append((acc_name, acc.spec, profile, cost_rate))
        return tuple(out)

    def _lane_signature(self, system: System, server,
                        ttft_percentile: Optional[float],
                        rung: str) -> tuple:
        svc = system.service_classes.get(server.service_class_name)
        target = svc.target(server.model_name) if svc is not None else None
        load = server.load
        pinned = (server.cur_allocation.accelerator
                  if server.keep_accelerator and server.cur_allocation
                  else "")
        # the aggregate demand is an epilogue input of the fused
        # decision, so the signature names it explicitly
        demand = (replica_demand(load.arrival_rate,
                                 target.slo_tps if target else 0.0,
                                 load.avg_out_tokens)
                  if load is not None and target is not None else None)
        return (
            server.model_name,
            server.service_class_name,
            svc.priority if svc is not None else None,
            target,
            server.min_num_replicas,
            server.max_batch_size,
            server.keep_accelerator,
            pinned,
            ((load.arrival_rate, load.avg_in_tokens, load.avg_out_tokens)
             if load is not None else None),
            demand,
            rung,
            ttft_percentile,
            self._candidate_entries(system, server),
        )

    @staticmethod
    def _value_signature(server) -> Optional[tuple]:
        cur = server.cur_allocation
        if cur is None:
            return None
        return (cur.accelerator, cur.num_replicas, cur.cost)

    @staticmethod
    def _solve_signature(system: System, optimizer_spec: OptimizerSpec,
                         cycle_rung: str) -> tuple:
        return (
            optimizer_spec,
            tuple(sorted(system.capacity.items())),
            frozenset(system.servers),
            cycle_rung,
        )

    # -- the analyze step -------------------------------------------------

    def calculate(self, system: System, *, backend: str,
                  ttft_percentile: Optional[float] = None,
                  optimizer_spec: Optional[OptimizerSpec] = None,
                  rungs: Optional[dict] = None,
                  cycle_rung: str = "healthy") -> SolveStats:
        """Signature-gated replacement for System.calculate: restores
        cached candidate allocations for unchanged variants, sizes only
        the changed sub-batch (through the resident arena), and
        refreshes the cache. Also precomputes the warm-start decision
        the optimize stage consumes via warm_start()."""
        self._cycle += 1
        rungs = rungs or {}
        optimizer_spec = optimizer_spec or OptimizerSpec()

        # quantized load is the solve's input (module docstring), applied
        # before signatures so bucket-stable jitter reads as unchanged
        for server in system.servers.values():
            server.load = quantize_load(server.load, self.epsilon)

        # the fused-solve knob rides the analyze signature: flipping
        # WVA_FUSED_SOLVE mid-run forces a full re-solve. The two slots
        # after the backend hold the reference package's mesh size and
        # lane-mesh flag; the port runs unsharded.
        analyze_sig = (backend, None, False, ttft_percentile,
                       fused_solve_enabled())
        solve_sig = self._solve_signature(system, optimizer_spec, cycle_rung)

        full = False
        reason = ""
        if self._cycle == 1 or not self._lane_sigs:
            full, reason = True, "first cycle"
        elif self.full_every and (self._cycle - 1) % self.full_every == 0:
            full, reason = True, \
                f"forced (WVA_SOLVE_FULL_EVERY={self.full_every})"
        elif self._analyze_sig != analyze_sig:
            full, reason = True, "backend/mesh/percentile changed"
        self._analyze_sig = analyze_sig

        lane_sigs = {
            name: self._lane_signature(system, server, ttft_percentile,
                                       rungs.get(name, "healthy"))
            for name, server in system.servers.items()
        }
        self._pending_value_sigs = {
            name: self._value_signature(server)
            for name, server in system.servers.items()
        }

        system.arena = self.arena
        if full:
            system.calculate(backend=backend,
                             ttft_percentile=ttft_percentile)
            self._alloc_cache = {}
            self._lane_sigs = {}
            for name, server in system.servers.items():
                self._lane_sigs[name] = lane_sigs[name]
                self._alloc_cache[name] = {
                    acc: alloc.clone()
                    for acc, alloc in server.all_allocations.items()}
            self.solve_modes = dict.fromkeys(system.servers, SOLVE_FULL)
            self._changed_for_solver = frozenset(system.servers)
            self._warm_ok = False
            stats = SolveStats(full=True, reason=reason,
                               lanes_solved=system.last_solve_lanes,
                               lanes_skipped=0,
                               modes={SOLVE_FULL: len(system.servers)})
        else:
            changed = {
                name for name in system.servers
                if self._lane_sigs.get(name) != lane_sigs[name]
                or name not in self._alloc_cache
            }
            skipped_lanes = 0
            for name, server in system.servers.items():
                if name in changed:
                    continue
                skipped_lanes += self._restore(system, server,
                                               self._alloc_cache[name])
            system.calculate(backend=backend,
                             ttft_percentile=ttft_percentile,
                             only=changed)
            for name in changed:
                server = system.servers[name]
                self._lane_sigs[name] = lane_sigs[name]
                self._alloc_cache[name] = {
                    acc: alloc.clone()
                    for acc, alloc in server.all_allocations.items()}
            self.solve_modes = {
                name: (SOLVE_INCREMENTAL if name in changed
                       else SOLVE_CACHED)
                for name in system.servers
            }
            # the solver additionally treats value-only drift (current
            # allocation moved, so transition penalties moved) as change
            value_changed = {
                name for name in system.servers
                if self._prev_value_sigs.get(name)
                != self._pending_value_sigs[name]
            }
            self._changed_for_solver = frozenset(changed | value_changed)
            self._warm_ok = (self._prev_complete
                             and self._prev_solve_sig == solve_sig)
            stats = SolveStats(
                full=False,
                reason=("capacity/candidate-set/rung changed"
                        if not self._warm_ok and self._prev_complete
                        else ""),
                lanes_solved=system.last_solve_lanes,
                lanes_skipped=skipped_lanes,
                modes={SOLVE_INCREMENTAL: len(changed),
                       SOLVE_CACHED: len(system.servers) - len(changed)})
        self._pending_solve_sig = solve_sig
        self.last_stats = stats
        if stats.full:
            log.debug("full solve: reason=%s lanes=%d", reason,
                      stats.lanes_solved)
        return stats

    @staticmethod
    def _restore(system: System, server, cached: dict) -> int:
        """Rehydrate a server's candidate allocations from pristine
        cache clones, re-deriving values against the LIVE current
        allocation, exactly the epilogue a fresh solve would run
        (value=cost, then the transition penalty when a current
        allocation exists). Returns the number of lanes skipped."""
        server.all_allocations = {}
        for acc_name, alloc in cached.items():
            a = alloc.clone()
            a.value = a.cost
            system._value_and_store(server, acc_name, a)
        return len(cached)

    # -- the optimize step ------------------------------------------------

    def warm_start(self) -> Optional[WarmStart]:
        """WarmStart for this cycle's greedy solve, or None when a full
        solve is required (first/forced-full cycle, a failed previous
        cycle, or a capacity / candidate-set / degradation-rung
        change)."""
        if not self._warm_ok:
            return None
        return WarmStart(prev=self._prev_choice,
                         changed=self._changed_for_solver,
                         prev_pools=self._prev_pools)

    def finish_cycle(self, system: System) -> None:
        """Commit a COMPLETED solve as the next cycle's warm-start seed.
        Never called on a failed cycle (note_failure), so a half-run
        cycle can't poison the seed."""
        self._prev_choice = {
            name: server.allocation.clone()
            for name, server in system.servers.items()
            if server.allocation is not None
        }
        pools: dict[str, tuple] = {}
        for name, server in system.servers.items():
            chips = set()
            for alloc in server.all_allocations.values():
                acc = system.accelerators.get(alloc.accelerator)
                if acc is not None:
                    chips.add(acc.chip)
            pools[name] = tuple(sorted(chips))
        self._prev_pools = pools
        self._prev_value_sigs = dict(self._pending_value_sigs)
        self._prev_solve_sig = self._pending_solve_sig
        self._prev_complete = True
        # bound memory under fleet churn: drop cache entries for
        # variants that left the fleet
        live = set(system.servers)
        for stale in [n for n in self._lane_sigs if n not in live]:
            del self._lane_sigs[stale]
            self._alloc_cache.pop(stale, None)

    def note_failure(self) -> None:
        """The optimize stage failed: the published solution no longer
        corresponds to this cycle's inputs, so the next cycle must not
        warm-start from it."""
        self._prev_complete = False
