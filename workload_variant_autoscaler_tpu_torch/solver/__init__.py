"""Solvers: unlimited (per-variant argmin) + greedy capacity-aware list
scheduling with saturation policies, the Optimizer/Manager facade, the
incremental steady-state engine (signature-gated re-solving) and the
hierarchical engine over it (super-shards, staggered forced-full, warm
restart from a checkpoint)."""

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
from .hierarchy import HierarchicalSolveEngine, sig_digest
from .optimizer import Manager, Optimizer

__all__ = [
    "HierarchicalSolveEngine",
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
    "sig_digest",
    "solve_greedy",
    "solve_greedy_warm",
]
