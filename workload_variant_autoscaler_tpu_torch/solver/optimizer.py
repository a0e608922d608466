"""Optimizer facade: timed solve + post-solve accounting (counterpart of
the reference package's `solver/optimizer.py`). The facade carries the
system explicitly, so several optimizations can run side by side."""

from __future__ import annotations

import time
from typing import Optional

from ..models import System
from ..models.spec import OptimizerSpec
from .solver import Solver


class Optimizer:
    def __init__(self, spec: OptimizerSpec):
        self.spec = spec
        self.solver: Optional[Solver] = None
        self.solution_time_msec: float = 0.0

    def optimize(self, system: System) -> None:
        if self.spec is None:
            raise ValueError("missing optimizer spec")
        self.solver = Solver(self.spec)
        start = time.perf_counter()
        self.solver.solve(system)
        self.solution_time_msec = (time.perf_counter() - start) * 1000.0


class Manager:
    """Optimize + accumulate per-generation chip usage."""

    def __init__(self, system: System, optimizer: Optimizer):
        self.system = system
        self.optimizer = optimizer

    def optimize(self) -> None:
        self.optimizer.optimize(self.system)
        self.system.allocate_by_type()
