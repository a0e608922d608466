"""PyTorch + CUDA port of the autoscaler's analyze + optimize path.

The reference is the JAX package `workload_variant_autoscaler_tpu`; this
package imports nothing of it (nor of JAX). Entry points run on the card
(`cuda`) unless the caller passes `device="cpu"`; the SLO-sizing
bisection runs as the CUDA kernels of `ops/bisect_kernel.py`. The
steady-state cycle goes through `IncrementalSolveEngine`, or, for fleets
of `WVA_HIER_MIN_VARIANTS` variants and more, `HierarchicalSolveEngine`
(which engine a controller runs is chosen by
`controller.select_solve_engine`); limited mode
(`OptimizerSpec(unlimited=False)`) runs the capacity-aware greedy.
"""

from .models import System, spec_from_reference
from .solver import (
    HierarchicalSolveEngine,
    IncrementalSolveEngine,
    Manager,
    Optimizer,
)

__all__ = ["HierarchicalSolveEngine", "IncrementalSolveEngine", "Manager",
           "Optimizer", "System", "spec_from_reference"]
