"""Solvers: unlimited (per-variant argmin) + greedy capacity-aware list
scheduling with saturation policies, the Optimizer/Manager facade, and
the incremental steady-state engine (signature-gated re-solving)."""

from .solver import Solver, WarmStart
from .greedy import solve_greedy, solve_greedy_warm
from .incremental import (
    SOLVE_CACHED,
    SOLVE_FULL,
    SOLVE_INCREMENTAL,
    SOLVE_MODES,
    IncrementalSolveEngine,
    SolveStats,
    quantize,
    quantize_load,
)
from .optimizer import Manager, Optimizer

__all__ = [
    "IncrementalSolveEngine",
    "Manager",
    "Optimizer",
    "SOLVE_CACHED",
    "SOLVE_FULL",
    "SOLVE_INCREMENTAL",
    "SOLVE_MODES",
    "Solver",
    "SolveStats",
    "WarmStart",
    "quantize",
    "quantize_load",
    "solve_greedy",
    "solve_greedy_warm",
]
