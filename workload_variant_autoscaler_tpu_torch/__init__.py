"""PyTorch + CUDA port of the autoscaler's analyze + optimize path.

The reference is the JAX package `workload_variant_autoscaler_tpu`; this
package imports nothing of it (nor of JAX). Entry points run on the card
(`cuda`) unless the caller passes `device="cpu"`; the SLO-sizing
bisection runs as the CUDA kernels of `ops/bisect_kernel.py`. The
steady-state cycle goes through `IncrementalSolveEngine`; limited mode
(`OptimizerSpec(unlimited=False)`) runs the capacity-aware greedy.
"""

from .models import System, spec_from_reference
from .solver import IncrementalSolveEngine, Manager, Optimizer

__all__ = ["IncrementalSolveEngine", "Manager", "Optimizer", "System",
           "spec_from_reference"]
