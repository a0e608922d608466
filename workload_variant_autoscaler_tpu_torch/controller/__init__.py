"""The controller's pieces ported so far: the reconciler's solve-engine
selection (`controller/reconciler.py`)."""

from .reconciler import SolveEngineSelector

__all__ = ["SolveEngineSelector"]
