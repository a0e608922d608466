"""Pushed traffic: an open-loop schedule of Prometheus remote-write
requests, each carrying new loads for `models_per_push` (model,
namespace) groups, half from each service class.

The schedule is Poisson at `rate_per_s`, conditioned on its count: a
window of T seconds holds round(rate x T) pushes at uniform random
times. A pushed group's arrival rate climbs a sawtooth in log space:
each push multiplies it by a factor from [low, high] (at least 10%, so
every push leaves the group's epsilon bucket), and past `ceiling` times
its base rate it wraps down by ceiling^2. Token means and latencies keep
their base values. `warmup` pushes, drawn the same way, precede the
window.

Everything is drawn from one fixed stream, whatever the run's seed:
every run of a cell sends the same pushes at the same times (the window
loops hand every generator the seed, for mixes that draw from it; this
one does not).
"""

from __future__ import annotations

import math

import numpy as np


class Traffic:
    def __init__(self, params: dict, fleet, base: dict, seed: int):
        self.rate = float(params["rate_per_s"])
        self.per_push = int(params["models_per_push"])
        self.low, self.high = float(params["low"]), float(params["high"])
        self.wrap = math.log(float(params["ceiling"]))
        self.warmup = int(params["warmup"])
        self.base = base
        # a group's class is that of the first VA serving it (the class
        # is the VA index's parity)
        first: dict = {}
        for i in range(fleet.variants):
            first.setdefault(fleet.group_of(i), i)
        groups = fleet.groups()
        self.classes = [[g for g in groups if first[g] % 2 == c]
                        for c in (0, 1)]
        self.level = {g: 0.0 for g in groups}
        self.rng = np.random.default_rng([0, 3])

    def push(self) -> list:
        """One push's [(group, rps)]; advances the groups' sawtooth."""
        out = []
        for c, members in enumerate(self.classes):
            n = (self.per_push + 1 - c) // 2
            for j in self.rng.choice(len(members), size=min(n, len(members)),
                                     replace=False):
                g = members[int(j)]
                lv = self.level[g] + math.log(
                    float(self.rng.uniform(self.low, self.high)))
                if lv > self.wrap:
                    lv -= 2.0 * self.wrap
                self.level[g] = lv
                out.append((g, self.base[g]["rps"] * math.exp(lv)))
        return out

    def warmup_pushes(self) -> list:
        return [self.push() for _ in range(self.warmup)]

    def schedule(self, seconds: float) -> list:
        """[(seconds after the window opens, [(group, rps)])], in order."""
        n = int(round(self.rate * seconds))
        times = sorted(float(t) for t in self.rng.uniform(0.0, seconds, n))
        return [(t, self.push()) for t in times]
