"""Allocation solvers (unlimited mode) and the optimizer facade."""

from .optimizer import Manager, Optimizer
from .solver import Solver

__all__ = ["Manager", "Optimizer", "Solver"]
