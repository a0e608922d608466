"""bench_torch_goodput: the fleet goodput scoreboard of the port's
digital twin, with every reconcile cycle on the card.

The counterpart of bench_goodput.py. It runs every scenario of the port's
`emulator.scenarios.SCENARIOS` (six production-shaped fleet stresses:
diurnal multi-region wave, flash crowd, pool maintenance drain, spot
reclamation wave, a Prometheus outage during a load spike, cost skew
across chip generations; 600-720 s of simulated time each) through the
port's `emulator.twin.run_scenario`: the real Reconciler in simulated
time, its sizing on `--device` in `--dtype`, scored with the goodput
meter (SLO-attained demand-seconds served per chip-cost-second
provisioned, with the badput split into under-provisioned,
over-provisioned, degradation-held and actuation-lagged).

    python3 bench_torch_goodput.py [--device cuda|cpu] [--dtype float32|float64]
        [--out PATH]

`WVA_GOODPUT_SCENARIOS=<comma list>` runs a subset, as in the JAX script.
Prints ONE JSON line, the record: bench_goodput.py's keys (per-scenario
dicts of the same shape), where it ran (the card's name and power limit,
the dtype, the engine backend) and each scenario's B1/B2 launches and
sizing readbacks per reconcile cycle. Everything in the record is seeded
simulated time, so it holds no wall clock: the walls go to stderr. The
record is written to PATH only with `--out`, never to a BENCH_*.json or
under tests/fixtures/. Runs on `cuda` in float32 unless asked; raises
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from bench_torch_collect import (
    cycle_launches,
    emit,
    launch_summary,
    refuse_output,
)
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.emulator.scenarios import SCENARIOS
from workload_variant_autoscaler_tpu_torch.emulator.twin import run_scenario


def scenario_names() -> list[str]:
    """WVA_GOODPUT_SCENARIOS's subset, or every scenario; raises
    SystemExit on an unknown name."""
    wanted = [s.strip() for s in
              (os.environ.get("WVA_GOODPUT_SCENARIOS") or "").split(",")
              if s.strip()]
    names = wanted or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown}; "
                         f"known: {sorted(SCENARIOS)}")
    return names


def run_one(name: str, *, device=None, dtype=None) -> tuple[dict, dict,
                                                             float]:
    """One scenario: (its score dict, its launches per reconcile cycle,
    wall seconds)."""
    with cycle_launches() as rows:
        t0 = time.perf_counter()
        result = run_scenario(SCENARIOS[name], device=device, dtype=dtype)
        wall = time.perf_counter() - t0
    return result.to_dict(), launch_summary(rows), wall


def compose(per_scenario: dict) -> dict:
    """bench_goodput.py's record of the per-scenario dicts: the headline
    is the useful share of every chip-cost-second provisioned across the
    scenarios run."""
    total_cost = sum(s["cost_dollar_seconds"] for s in per_scenario.values())
    useful = sum(s["goodput_fraction"] * s["cost_dollar_seconds"]
                 for s in per_scenario.values())
    return {
        "metric": "fleet_goodput_fraction",
        "bench": "goodput",
        "value": round(useful / total_cost, 4) if total_cost else 0.0,
        "unit": "useful-cost-fraction",
        "scenario_count": len(per_scenario),
        "scenarios": per_scenario,
    }


def run(names=None, *, device=None, dtype=None) -> tuple[dict, dict]:
    """(the record, wall seconds per scenario) of `names` (default: every
    scenario)."""
    place = where(device, dtype)
    scores, launches, walls = {}, {}, {}
    for name in names or list(SCENARIOS):
        scores[name], launches[name], walls[name] = run_one(
            name, device=device, dtype=dtype)
    return {**compose(scores), **place, "kernel_launches": launches}, walls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_torch_goodput.py")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64"))
    parser.add_argument("--out", default=None)
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    record, walls = run(scenario_names(), device=opts.device,
                        dtype=getattr(torch, opts.dtype))
    print(f"wall_s: {json.dumps(walls)}", file=sys.stderr)
    return emit(record, opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
