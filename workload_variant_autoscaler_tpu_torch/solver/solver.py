"""Allocation assignment solvers.

Counterpart of the reference package's `solver/solver.py` (the Go
reference's pkg/solver/solver.go). Two modes:
- unlimited: per-server argmin over candidate allocations (separable
  objective; value = transition penalty, so the solution is cost-minimal
  and switch-averse);
- limited: capacity-aware list scheduling over finite chip pools, in
  `greedy.py`, warm-started from the previous cycle when the
  incremental engine hands over a `WarmStart`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..models import (
    Allocation,
    AllocationDiff,
    SaturationPolicy,
    System,
    allocation_diff,
)
from ..models.spec import OptimizerSpec
from .greedy import solve_greedy, solve_greedy_warm


@dataclass(frozen=True)
class WarmStart:
    """Previous-cycle solve state for the warm-started greedy
    (solver/incremental.py builds one only when its invariants hold:
    completed previous solve, same candidate set, same capacity view).

    prev: server name -> the Allocation chosen last cycle (pristine
    clones; greedy clones again before mutating). changed: servers whose
    solver-visible inputs (candidates, values, load signature) changed.
    prev_pools: server name -> chip pools its candidates drew on last
    cycle, so a candidate set that LEFT a pool still marks it touched."""

    prev: dict[str, Allocation]
    changed: frozenset
    prev_pools: dict[str, tuple] = field(default_factory=dict)


class Solver:
    def __init__(self, optimizer_spec: OptimizerSpec):
        self.spec = optimizer_spec
        self.current_allocation: dict[str, Allocation] = {}
        self.diff_allocation: dict[str, AllocationDiff] = {}

    def solve(self, system: System, warm: Optional[WarmStart] = None) -> None:
        """Snapshot current allocations, dispatch by mode, compute diffs
        (reference solver.go:32-59). `warm` seeds the greedy mode from
        the previous cycle's solution, recomputing only the chip pools
        touched by changed servers; the unlimited mode is separable
        per-server host arithmetic, so it always runs in full."""
        self.current_allocation = {
            name: server.cur_allocation
            for name, server in system.servers.items()
            if server.cur_allocation is not None
        }

        if self.spec.unlimited:
            self.solve_unlimited(system)
        elif warm is not None:
            solve_greedy_warm(
                system,
                SaturationPolicy.parse(self.spec.saturation_policy),
                prev=warm.prev,
                changed=warm.changed,
                prev_pools=warm.prev_pools,
                delayed_best_effort=self.spec.delayed_best_effort,
            )
        else:
            solve_greedy(
                system,
                SaturationPolicy.parse(self.spec.saturation_policy),
                delayed_best_effort=self.spec.delayed_best_effort,
            )

        self.diff_allocation = {}
        for name, server in system.servers.items():
            diff = allocation_diff(self.current_allocation.get(name), server.allocation)
            if diff is not None:
                self.diff_allocation[name] = diff

    def solve_unlimited(self, system: System) -> None:
        """Per-server min-value candidate (reference solver.go:63-79)."""
        for server in system.servers.values():
            server.remove_allocation()
            best: Optional[Allocation] = None
            for alloc in server.all_allocations.values():
                if best is None or alloc.value < best.value:
                    best = alloc
            if best is not None:
                server.set_allocation(best)
