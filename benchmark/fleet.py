"""The fleet and its loads, with numpy alone.

A frozen copy of the cluster description of `tests/reconcile_cluster.py`
(the slice shapes, the per-model profile draws around the Llama-3.1-8B
fit, the load draws, the two service classes), so that neither the
harness nor the reference depends on code a later change could edit.
The reference imports this module; nothing here imports the program.

VA i serves model `m{i % models}` in namespace `ns{i % namespaces}`,
carries the first `profiles` slice shapes of SHAPES, is labelled with
shape `i % profiles` and sits in the Premium class when i is even.

A configuration is one fixed fleet: the profiles and loads are drawn
from fixed streams, whatever the run's seed, so every run of a cell
sizes the same lanes and every seed does the same work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# (slice name, chip generation, chips, cost, relative speed): the first
# eight default slice shapes at their catalog prices
SHAPES = (
    ("v5e-1", "v5e", 1, 20.0, 1.0),
    ("v5e-4", "v5e", 4, 80.0, 0.55),
    ("v5e-8", "v5e", 8, 160.0, 0.4),
    ("v5e-16", "v5e", 16, 320.0, 0.3),
    ("v5p-4", "v5p", 4, 340.0, 0.35),
    ("v5p-8", "v5p", 8, 680.0, 0.25),
    ("v6e-1", "v6e", 1, 55.0, 0.65),
    ("v6e-4", "v6e", 4, 220.0, 0.35),
)

# the Llama-3.1-8B fit the profiles are drawn around
ALPHA, BETA, GAMMA, DELTA = 6.973, 0.027, 5.2, 0.1
MAX_BATCHES = (64, 128, 256)


@dataclass(frozen=True)
class Fleet:
    """One deployment as its configuration file states it."""

    variants: int
    namespaces: int
    models: int
    profiles: int
    percentile: float
    classes: tuple          # ((name, priority, slo_itl, slo_ttft, held_at_p), ...)

    @classmethod
    def from_config(cls, cfg: dict) -> "Fleet":
        d = cfg["deployment"]
        classes = tuple((c["name"], int(c["priority"]), float(c["slo_itl_ms"]),
                         float(c["slo_ttft_ms"]), bool(c["percentile"]))
                        for c in d["service_classes"])
        return cls(variants=int(d["variants"]),
                   namespaces=int(d["namespaces"]),
                   models=int(d["models"]), profiles=int(d["profiles"]),
                   percentile=float(d["ttft_percentile"]),
                   classes=classes)

    # -- the fleet's shape -------------------------------------------------

    def va_key(self, i: int) -> tuple[str, str]:
        return f"v{i:05d}", f"ns{i % self.namespaces}"

    def full_name(self, i: int) -> str:
        name, ns = self.va_key(i)
        return f"{name}:{ns}"

    def model_of(self, i: int) -> str:
        return f"m{i % self.models}"

    def group_of(self, i: int) -> tuple[str, str]:
        return self.model_of(i), self.va_key(i)[1]

    def slice_of(self, i: int) -> str:
        return SHAPES[i % self.profiles][0]

    def class_of(self, i: int) -> tuple:
        """The VA's service class: the first class when i is even."""
        return self.classes[i % 2]

    def groups(self) -> list[tuple[str, str]]:
        """The (model, namespace) groups, in first-seen VA order."""
        seen: dict = {}
        for i in range(self.variants):
            seen.setdefault(self.group_of(i), None)
        return list(seen)

    def profiles_by_model(self) -> dict:
        """model -> [(slice, alpha, beta, gamma, delta, max_batch)]."""
        rng = np.random.default_rng([0, 0])
        out = {}
        for m in range(self.models):
            u = rng.uniform(0.8, 1.25, 4)
            rows = []
            for name, _gen, _chips, _cost, speed in SHAPES[:self.profiles]:
                f = speed * float(rng.uniform(0.95, 1.05))
                rows.append((name, ALPHA * float(u[0]) * f,
                             BETA * float(u[1]) * f, GAMMA * float(u[2]) * f,
                             DELTA * float(u[3]) * f,
                             int(rng.choice(MAX_BATCHES))))
            out[f"m{m}"] = rows
        return out

    def base_loads(self) -> dict:
        """(model, namespace) -> the scraped values: req/s, mean prompt and
        generation tokens, mean TTFT and ITL in seconds."""
        rng = np.random.default_rng([0, 1])
        by_model = []
        for _m in range(self.models):
            by_model.append({
                "rps": float(rng.uniform(0.5, 40.0)),
                "prompt": float(rng.choice([128.0, 256.0, 512.0])),
                "gen": float(rng.choice([128.0, 256.0])),
                "ttft": float(rng.uniform(0.05, 0.4)),
                "itl": float(rng.uniform(0.008, 0.03)),
            })
        return {key: dict(by_model[int(key[0][1:])]) for key in self.groups()}

    def service_class_yaml(self) -> dict:
        """The service-classes ConfigMap's data: one key per class, each
        listing every model (the first class held at the percentile)."""
        models = [f"m{m}" for m in range(self.models)]
        out = {}
        for name, priority, itl, ttft, held in self.classes:
            pct = (f"    slo-ttft-percentile: {self.percentile}\n"
                   if held else "")
            out[name.lower()] = (
                f"name: {name}\npriority: {priority}\ndata:\n" + "".join(
                    f"  - model: {m}\n    slo-tpot: {itl:g}\n"
                    f"    slo-ttft: {ttft:g}\n{pct}" for m in models))
        return out

