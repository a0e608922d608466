"""Polled traffic: before each cycle, a share of the (model, namespace)
groups take a new arrival rate, their base rate times a factor drawn
uniformly from [low, high] (the law of `tests/reconcile_cluster.py
churn`, drawn against the base rate so the load stays stationary over a
window). Token means and latencies keep their base values.

The draws come from one fixed stream, whatever the run's seed: every
run of a cell sends the same changes (the window loops hand every
generator the seed, for mixes that draw from it; this one does not).

Parameters: share (of the groups, at least one), low, high, and
interval_s, the poll interval the controller's clock advances per cycle.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, params: dict, fleet, base: dict, seed: int):
        self.share = float(params["share"])
        self.low, self.high = float(params["low"]), float(params["high"])
        self.base = base
        self.groups = fleet.groups()
        self.rng = np.random.default_rng([0, 2])

    def step(self, loads: dict) -> list:
        """Rescale this cycle's groups in `loads`; returns their keys."""
        n_all = len(self.groups)
        n = max(1, int(round(self.share * n_all)))
        chosen = (range(n_all) if n >= n_all else
                  sorted(int(k) for k in self.rng.choice(
                      n_all, size=n, replace=False)))
        factors = self.rng.uniform(self.low, self.high, n_all)
        picked = []
        for k in chosen:
            g = self.groups[k]
            loads[g]["rps"] = self.base[g]["rps"] * float(factors[k])
            picked.append(g)
        return picked
