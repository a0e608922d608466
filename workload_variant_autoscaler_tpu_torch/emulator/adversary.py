"""Adversarial scenario search: red-team the goodput twin.

A deterministic seeded perturb-and-select optimizer over the typed,
bounded parameter space in `scenarios/adversarial.py`, minimizing
cost-weighted goodput (`ScenarioResult.goodput_fraction` — the ML
Productivity Goodput fraction, arxiv 2502.06982) through the REAL
Reconciler via `twin.run_scenario`. The search is (1+λ): each
generation mutates the incumbent λ times, evaluates every candidate,
and adopts the generation's worst (lowest-goodput) point as the next
incumbent — monotone descent into the controller's weakest corner of
the space.

Determinism is the contract: every draw comes from one
`random.Random(seed)` consumed in a fixed order, every evaluation runs
in sim time (run_scenario is wall-clock-free), and `SearchResult
.to_dict()` is the byte-comparison surface — the reference package's
`bench_adversary.py` runs the search twice per artifact and asserts the
serialized records are identical. A fake `evaluate` can be injected
for unit-testing the search mechanics without paying for twin runs.

Budget = 1 + generations*population `run_scenario` evaluations; the
bench reads WVA_ADVERSARY_GENERATIONS / WVA_ADVERSARY_POPULATION /
WVA_ADVERSARY_SEED (docs/user-guide/configuration.md).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import get_logger, kv, resolve_device, resolve_dtype
from .scenarios.adversarial import (
    DURATION_S,
    PARAM_SPACE,
    quantize,
    quantized_params,
    scenario_from_params,
)

log = get_logger("wva.adversary")

DEFAULT_SEED = 14
DEFAULT_GENERATIONS = 3
DEFAULT_POPULATION = 8

# per-axis mutation: probability an axis moves, and the gaussian step's
# sigma as a fraction of the axis range (quantization then snaps it)
MUTATION_RATE = 0.35
MUTATION_SIGMA = 0.25

# An evaluator maps (params, scenario_name) -> goodput fraction. The
# default builds the grid point into a Scenario and runs the twin.
Evaluator = Callable[[dict, str], float]


@dataclass
class SearchResult:
    """The full audit trail of one search run: every evaluation in
    order, each generation's worst find, and the global worst. This is
    the byte-identity surface — same seed, same budget, same code must
    serialize to the same dict."""

    seed: int
    duration_s: float
    generations: int
    population: int
    evaluations: list[dict] = field(default_factory=list)
    generation_worst: list[dict] = field(default_factory=list)

    @property
    def worst(self) -> dict:
        return min(self.evaluations, key=lambda e: (e["goodput"],
                                                    e["index"]))

    @property
    def budget(self) -> int:
        return 1 + self.generations * self.population

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "duration_s": self.duration_s,
            "generations": self.generations,
            "population": self.population,
            "budget": self.budget,
            "evaluations": self.evaluations,
            "generation_worst": self.generation_worst,
            "worst": self.worst,
        }


def sample_params(rng: random.Random) -> dict[str, float]:
    """A uniform grid point: each axis drawn uniform in bounds, then
    snapped to its quantum."""
    return {s.name: quantize(s, rng.uniform(s.lo, s.hi))
            for s in PARAM_SPACE}


def mutate_params(params: dict, rng: random.Random) -> dict[str, float]:
    """A neighbor of `params`: each axis moves with MUTATION_RATE by a
    gaussian step scaled to its range, snapped to the grid. Guaranteed
    to differ from the input in at least one axis (a no-op candidate
    would waste a twin evaluation), with a bounded deterministic number
    of forcing attempts."""
    out = dict(params)
    changed = False
    for spec in PARAM_SPACE:
        if rng.random() >= MUTATION_RATE:
            continue
        moved = quantize(spec, out[spec.name]
                         + rng.gauss(0.0, (spec.hi - spec.lo)
                                     * MUTATION_SIGMA))
        changed = changed or moved != out[spec.name]
        out[spec.name] = moved
    attempts = 0
    while not changed and attempts < 8:
        attempts += 1
        spec = PARAM_SPACE[rng.randrange(len(PARAM_SPACE))]
        direction = 1.0 if rng.random() < 0.5 else -1.0
        moved = quantize(spec, out[spec.name] + direction * spec.quantum)
        changed = moved != out[spec.name]
        out[spec.name] = moved
    return out


def search(seed: int = DEFAULT_SEED,
           generations: int = DEFAULT_GENERATIONS,
           population: int = DEFAULT_POPULATION,
           duration_s: float = DURATION_S,
           evaluate: Optional[Evaluator] = None,
           operator_extra: Optional[dict] = None,
           *, device=None, dtype=None) -> SearchResult:
    """Run the (1+λ) descent and return its full audit trail.
    `operator_extra` overlays every evaluated scenario's operator CM —
    how the bench scores the SAME search trajectory's worst point under
    a hardened controller config. The default `evaluate` runs the twin
    on `device` in `dtype` (the card and float32 unless asked; without
    CUDA, `device=None` raises before the first evaluation)."""
    if evaluate is None:
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)

        def evaluate(params: dict, name: str) -> float:
            from .twin import run_scenario
            scenario = scenario_from_params(
                params, name=name, seed=seed, duration_s=duration_s,
                operator_extra=operator_extra)
            return run_scenario(scenario, device=device,
                                dtype=dtype).goodput_fraction

    rng = random.Random(seed)
    result = SearchResult(seed=seed, duration_s=duration_s,
                          generations=generations, population=population)

    def run_one(params: dict, index: int, generation: int) -> float:
        goodput = evaluate(params, f"adv-{seed}-{index}")
        result.evaluations.append({
            "index": index,
            "generation": generation,
            "params": quantized_params(params),
            "goodput": round(goodput, 6),
        })
        return goodput

    incumbent = sample_params(rng)
    incumbent_goodput = run_one(incumbent, 0, 0)
    index = 1
    for gen in range(1, generations + 1):
        worst_params, worst_goodput = incumbent, incumbent_goodput
        for _ in range(population):
            candidate = mutate_params(incumbent, rng)
            goodput = run_one(candidate, index, gen)
            if goodput < worst_goodput:
                worst_params, worst_goodput = candidate, goodput
            index += 1
        result.generation_worst.append({
            "generation": gen,
            "params": quantized_params(worst_params),
            "goodput": round(worst_goodput, 6),
        })
        log.info("adversary generation complete",
                 extra=kv(generation=gen, worst=round(worst_goodput, 6)))
        incumbent, incumbent_goodput = worst_params, worst_goodput
    return result
