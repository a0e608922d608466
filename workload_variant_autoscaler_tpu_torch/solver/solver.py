"""Allocation assignment solver.

Counterpart of the reference package's `solver/solver.py` (the Go
reference's pkg/solver/solver.go) in unlimited mode: the per-server
argmin over candidate allocations (separable objective; value =
transition penalty, so the solution is cost-minimal and switch-averse).
The capacity-aware greedy of limited mode waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

from ..models import Allocation, AllocationDiff, System, allocation_diff
from ..models.spec import OptimizerSpec


class Solver:
    def __init__(self, optimizer_spec: OptimizerSpec):
        self.spec = optimizer_spec
        self.current_allocation: dict[str, Allocation] = {}
        self.diff_allocation: dict[str, AllocationDiff] = {}

    def solve(self, system: System) -> None:
        """Snapshot current allocations, solve, compute diffs."""
        if not self.spec.unlimited:
            raise NotImplementedError(
                "limited mode (the capacity-aware greedy) is not ported yet; "
                "use OptimizerSpec(unlimited=True)")
        self.current_allocation = {
            name: server.cur_allocation
            for name, server in system.servers.items()
            if server.cur_allocation is not None
        }
        self.solve_unlimited(system)
        self.diff_allocation = {}
        for name, server in system.servers.items():
            diff = allocation_diff(self.current_allocation.get(name), server.allocation)
            if diff is not None:
                self.diff_allocation[name] = diff

    def solve_unlimited(self, system: System) -> None:
        """Per-server min-value candidate."""
        for server in system.servers.values():
            server.remove_allocation()
            best: Optional[Allocation] = None
            for alloc in server.all_allocations.values():
                if best is None or alloc.value < best.value:
                    best = alloc
            if best is not None:
                server.set_allocation(best)
