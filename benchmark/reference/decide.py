"""What the controller has to publish, worked out again from the fleet
and the loads the harness handed it.

The path a scraped or pushed load takes before it is sized, as the
controller documents it: the arrival rate in req/min (req/s x 60), kept
on the VariantAutoscaling's status as a two-decimal string, snapped to
relative-epsilon log buckets (`WVA_SOLVE_EPSILON`, 0.02 by default),
token means the same and rounded to whole tokens. Every VA is pinned to
the slice shape of its accelerator label (the reference controller's
keep-accelerator rule), so its one candidate lane is sized and its
replica count is ceil(demand / max rate per replica), at least one.

A float32 program and this float64 reference agree on a lane's rate
only to within rounding, so a replica count is judged against the range
the lane's limit allows: the program's count must lie in
[ceil(d / (r (1 + tau))), ceil(d / (r (1 - tau)))] for r the reference's
rate, tau the lane limit, and d one of the two readings of the demand
(snapped before or after the two-decimal status string).

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fleet import Fleet
from .sizing import Lanes, size_blocks

DEFAULT_EPSILON = 0.02


def quantize(value: float, epsilon: float) -> float:
    """Snap a positive value to its relative-epsilon log bucket."""
    if epsilon <= 0 or value <= 0 or not math.isfinite(value):
        return value
    step = math.log1p(epsilon)
    return math.exp(round(math.log(value) / step) * step)


def on_status(value: float) -> float:
    """A value as the VA's status keeps it: a two-decimal string."""
    return float(f"{value:.2f}")


def tokens(value: float, epsilon: float) -> int:
    return int(round(quantize(int(on_status(value)), epsilon)))


def demands(rpm: float, epsilon: float) -> tuple[float, ...]:
    """The demand in req/s under both orders of snapping and status
    rounding (a pushed value is snapped at the door as well)."""
    return tuple(sorted({quantize(on_status(rpm), epsilon) / 60.0,
                         quantize(on_status(quantize(rpm, epsilon)),
                                  epsilon) / 60.0}))


class Reference:
    """The fleet's lanes sized once (a lane's rate depends on its profile
    and tokens, which the traffic leaves alone), and the decisions for any
    loads."""

    def __init__(self, fleet: Fleet, base_loads: dict, device,
                 dtype=torch.float64, epsilon: float = DEFAULT_EPSILON):
        self.fleet = fleet
        self.eps = epsilon
        prof = fleet.profiles_by_model()
        lane_of: dict = {}
        rows = []
        self.va_lane = []
        for i in range(fleet.variants):
            model, ns = fleet.group_of(i)
            slc = fleet.slice_of(i)
            load = base_loads[(model, ns)]
            cls = fleet.class_of(i)
            key = (model, slc, tokens(load["prompt"], epsilon),
                   tokens(load["gen"], epsilon), cls[0])
            if key not in lane_of:
                row = next(r for r in prof[model] if r[0] == slc)
                lane_of[key] = len(rows)
                rows.append((row[1], row[2], row[3], row[4], key[2], key[3],
                             row[5], cls[3], cls[2], cls[4]))
            self.va_lane.append(lane_of[key])
        a = np.asarray(rows, dtype=np.float64)

        def f(col):
            return torch.as_tensor(a[:, col], dtype=torch.float64,
                                   device=device)

        self.lanes = Lanes(
            alpha=f(0), beta=f(1), gamma=f(2), delta=f(3), in_tok=f(4),
            out_tok=f(5), n_max=f(6).to(torch.int64), slo_ttft=f(7),
            slo_itl=f(8), tail=f(9) > 0, pct=fleet.percentile)
        self.sized = size_blocks(self.lanes.to(dtype))
        self.rate = self.sized.rate.double().cpu().numpy()
        self.feasible = self.sized.feasible.cpu().numpy()

    def row_index(self) -> dict:
        """A kernel row's inputs as the card holds them (float32 profile,
        tokens and target; N; whether it searches TTFT) -> the trips the
        reference's search of that row ran."""
        ln = self.lanes
        cols = [ln.alpha, ln.beta, ln.gamma, ln.delta, ln.in_tok, ln.out_tok]
        base = torch.stack(cols, dim=1).cpu().numpy()
        t_ttft = torch.where(ln.tail, torch.full_like(ln.slo_ttft,
                                                     1.0 - ln.pct),
                             ln.slo_ttft).cpu().numpy()
        t_itl = ln.slo_itl.cpu().numpy()
        n = ln.n_max.cpu().numpy()
        trips = (self.sized.trips_ttft.cpu().numpy(),
                 self.sized.trips_itl.cpu().numpy())
        out = {}
        for lane in range(len(ln)):
            for is_ttft, target, tr in ((1, t_ttft, trips[0]),
                                        (0, t_itl, trips[1])):
                row = np.append(base[lane], target[lane]).astype(np.float32)
                out[(row.tobytes(), int(n[lane]), is_ttft)] = int(tr[lane])
        return out

    def va_rate(self, i: int) -> tuple[float, bool]:
        lane = self.va_lane[i]
        return float(self.rate[lane]), bool(self.feasible[lane])

    def replicas_range(self, i: int, rpm: float, tau: float):
        """(lowest, highest) admissible replica count of VA i at `rpm`,
        or None where the reference finds no feasible allocation."""
        r, ok = self.va_rate(i)
        if not ok or not r > 0:
            return None
        if rpm <= 0:
            return (1, 1)
        lo, hi = math.inf, 0
        for d in demands(rpm, self.eps):
            lo = min(lo, max(math.ceil(d / (r * (1.0 + tau))), 1))
            hi = max(hi, max(math.ceil(d / (r * (1.0 - tau))), 1))
        return (lo, hi)

    def replicas(self, i: int, rpm: float) -> int:
        """The reference's own count (its own rate, exact arithmetic)."""
        rng = self.replicas_range(i, rpm, 0.0)
        return 0 if rng is None else rng[0]
