"""The reconciler's solve-engine selection.

Counterpart of the engine-selection seam of the reference package's
`controller/reconciler.py` (`Reconciler._solve_knob`,
`_incremental_solve_enabled`, `_hier_solve_mode`, `_solve_engine`; the
methods keep those names). The rest of the reconciler is not ported yet;
it will own one `SolveEngineSelector` and ask it for the cycle's engine.

Knobs, each read from the environment first and then from the operator
ConfigMap's mapping:

- `WVA_INCREMENTAL_SOLVE` (default on): `off` means no engine (a full
  solve every cycle).
- `WVA_HIER_SOLVE`: `auto` (default) is the hierarchical engine with the
  `WVA_HIER_MIN_VARIANTS` floor below which it delegates to the flat
  path; `on` forces the two-level path at any fleet size; `off` is the
  flat `IncrementalSolveEngine` itself, not a subclass.
- `WVA_SOLVE_EPSILON`, `WVA_SOLVE_FULL_EVERY`, `WVA_HIER_SHARD_VARIANTS`,
  `WVA_HIER_MIN_VARIANTS`, `WVA_ARENA_CHECKPOINT` (a path; empty = no
  checkpoint), `WVA_ARENA_CHECKPOINT_EVERY`,
  `WVA_ARENA_CHECKPOINT_MAX_AGE_S`.

A change of any knob rebuilds the engine, so the next cycle runs full,
which is what a changed quantization requires.
"""

from __future__ import annotations

import os
from typing import Optional

from ..solver.hierarchy import (
    DEFAULT_CHECKPOINT_EVERY,
    DEFAULT_CHECKPOINT_MAX_AGE_S,
    DEFAULT_MIN_VARIANTS,
    DEFAULT_SHARD_TARGET,
    HierarchicalSolveEngine,
)
from ..solver.incremental import (
    DEFAULT_EPSILON,
    DEFAULT_FULL_EVERY,
    IncrementalSolveEngine,
)
from ..utils import parse_float_or

_OFF = ("off", "false", "0", "disabled")
_ON = ("on", "true", "1", "enabled")


class SolveEngineSelector:
    """Holds the last operator ConfigMap mapping and the current engine,
    and hands out the engine the knobs ask for (see module docstring)."""

    def __init__(self, operator_cm: Optional[dict] = None,
                 engine: Optional[IncrementalSolveEngine] = None):
        self.operator_cm = dict(operator_cm or {})
        self.engine = engine

    def _solve_knob(self, key: str, operator_cm=None) -> str:
        return (os.environ.get(key)
                or (operator_cm if operator_cm is not None
                    else self.operator_cm).get(key)
                or "")

    def _incremental_solve_enabled(self, operator_cm=None) -> bool:
        """WVA_INCREMENTAL_SOLVE: signature-gated steady-state solving
        (default on)."""
        raw = self._solve_knob("WVA_INCREMENTAL_SOLVE", operator_cm)
        return raw.strip().lower() not in _OFF

    def _hier_solve_mode(self, operator_cm=None) -> str:
        """WVA_HIER_SOLVE as one of "auto", "on", "off"."""
        raw = self._solve_knob("WVA_HIER_SOLVE",
                               operator_cm).strip().lower()
        if raw in _OFF:
            return "off"
        if raw in _ON:
            return "on"
        return "auto"

    def _solve_engine(self, operator_cm=None
                      ) -> Optional[IncrementalSolveEngine]:
        """The cycle's incremental solve engine, or None when disabled.
        The current engine is kept while its knobs stand; a changed knob
        builds a new one."""
        if not self._incremental_solve_enabled(operator_cm):
            self.engine = None
            return None
        epsilon = parse_float_or(
            self._solve_knob("WVA_SOLVE_EPSILON", operator_cm),
            DEFAULT_EPSILON)
        full_every = int(parse_float_or(
            self._solve_knob("WVA_SOLVE_FULL_EVERY", operator_cm),
            DEFAULT_FULL_EVERY))
        if epsilon < 0:
            epsilon = DEFAULT_EPSILON
        engine = self.engine
        mode = self._hier_solve_mode(operator_cm)
        if mode == "off":
            if engine is None \
                    or type(engine) is not IncrementalSolveEngine \
                    or engine.epsilon != epsilon \
                    or engine.full_every != max(full_every, 0):
                engine = IncrementalSolveEngine(epsilon=epsilon,
                                                full_every=full_every)
                self.engine = engine
            return engine
        shard_target = max(int(parse_float_or(
            self._solve_knob("WVA_HIER_SHARD_VARIANTS", operator_cm),
            DEFAULT_SHARD_TARGET)), 1)
        min_variants = (0 if mode == "on" else max(int(parse_float_or(
            self._solve_knob("WVA_HIER_MIN_VARIANTS", operator_cm),
            DEFAULT_MIN_VARIANTS)), 0))
        ckpt_path = self._solve_knob("WVA_ARENA_CHECKPOINT",
                                     operator_cm).strip()
        ckpt_every = max(int(parse_float_or(
            self._solve_knob("WVA_ARENA_CHECKPOINT_EVERY", operator_cm),
            DEFAULT_CHECKPOINT_EVERY)), 1)
        ckpt_age = parse_float_or(
            self._solve_knob("WVA_ARENA_CHECKPOINT_MAX_AGE_S",
                             operator_cm),
            DEFAULT_CHECKPOINT_MAX_AGE_S)
        if engine is None \
                or type(engine) is not HierarchicalSolveEngine \
                or engine.epsilon != epsilon \
                or engine.full_every != max(full_every, 0) \
                or engine.shard_target != shard_target \
                or engine.min_variants != min_variants \
                or (engine.checkpoint_path or "") != ckpt_path \
                or engine.checkpoint_every != ckpt_every \
                or engine.checkpoint_max_age_s != ckpt_age:
            engine = HierarchicalSolveEngine(
                epsilon=epsilon, full_every=full_every,
                shard_target=shard_target, min_variants=min_variants,
                checkpoint_path=ckpt_path or None,
                checkpoint_every=ckpt_every,
                checkpoint_max_age_s=ckpt_age)
            self.engine = engine
        return engine
