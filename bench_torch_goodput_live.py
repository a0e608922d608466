"""bench_torch_goodput_live: the twin's goodput meter against the online
meter of the running controller, with every reconcile cycle on the card.

The counterpart of bench_goodput_live.py. The meter (obs/goodput.py)
promises that the digital twin and the running controller score a fleet
with the same arithmetic. This runs scenarios of the port's
`emulator.scenarios.SCENARIOS` through the port's
`emulator.twin.run_scenario` with a SECOND GoodputMeter on the embedded
Reconciler's live feed (`online_meter=`: `attach_goodput_meter(
self_tick=False)`, the wiring a WVA_GOODPUT_LIVE controller runs every
cycle), then requires the two meters to hold

- identical per-tick ledger rings (every tick's cost, demand,
  SLO-attained demand and bucket split),
- identical variant sets, and
- identical per-variant accounting (cost, demand, SLO demand and the
  badput buckets).

Both meters do the same host arithmetic on the same inputs, so this is
exact equality on the card in float32 too, never a tolerance: any drift
raises, naming the first differing tick.

    python3 bench_torch_goodput_live.py [--device cuda|cpu]
        [--dtype float32|float64] [--smoke] [--out PATH]

`--smoke` runs one abbreviated flash-crowd pass (300 s of simulated
time); the full run covers every scenario, or WVA_GOODPUT_SCENARIOS's
subset. Prints ONE JSON line (the equivalence lines, where it ran, and
each scenario's B1/B2 launches and sizing readbacks per reconcile
cycle); writes it to PATH only with `--out`. Runs on `cuda` in float32
unless asked; raises without CUDA.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from bench_torch_collect import (
    cycle_launches,
    emit,
    launch_summary,
    refuse_output,
)
from bench_torch_goodput import scenario_names
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
    SCENARIOS,
    abbreviated,
)
from workload_variant_autoscaler_tpu_torch.emulator.twin import run_scenario
from workload_variant_autoscaler_tpu_torch.obs.goodput import GoodputMeter

SMOKE_DURATION_S = 300.0
# the keys of this script's records that time a run on the host's clock
WALL_KEYS = frozenset({"wall_s"})


def assert_equivalent(twin: GoodputMeter, online: GoodputMeter) -> int:
    """Compare the two meters exactly; returns the tick count, raises
    AssertionError naming the first divergence otherwise."""
    twin_ticks = twin.ledger()
    online_ticks = online.ledger()
    if len(twin_ticks) != len(online_ticks):
        raise AssertionError(f"tick ring lengths differ: twin "
                             f"{len(twin_ticks)} vs online "
                             f"{len(online_ticks)}")
    for i, (a, b) in enumerate(zip(twin_ticks, online_ticks)):
        if a != b:
            raise AssertionError(f"tick {i} (t={a['t']}) differs: {a} vs {b}")
    twin_keys = sorted(led.key for led in twin.variants())
    online_keys = sorted(led.key for led in online.variants())
    if twin_keys != online_keys:
        raise AssertionError(f"variant sets differ: {twin_keys} vs "
                             f"{online_keys}")
    for led in twin.variants():
        other = online.variant(led.key)
        mine = (led.cost_s, led.demand_s, led.slo_demand_s, led.buckets)
        theirs = (other.cost_s, other.demand_s, other.slo_demand_s,
                  other.buckets)
        if mine != theirs:
            raise AssertionError(f"variant {led.key} ledgers differ: "
                                 f"{mine} vs {theirs}")
    return len(twin_ticks)


def run_one(name: str, scenario, *, device=None, dtype=None) -> dict:
    """One scenario with the online meter attached; raises unless the two
    meters are equal."""
    online = GoodputMeter(window_s=scenario.duration_s)
    with cycle_launches() as rows:
        t0 = time.perf_counter()
        result = run_scenario(scenario, online_meter=online, device=device,
                              dtype=dtype)
        wall_s = time.perf_counter() - t0
    ticks = assert_equivalent(result.meter, online)
    summary = online.summary()
    return {
        "scenario": name,
        "ticks": ticks,
        "variants": summary["variants"],
        "goodput_fraction": round(summary["goodput_fraction"], 4),
        "wall_s": wall_s,
        "kernel_launches": launch_summary(rows),
    }


def run(smoke: bool = False, names=None, *, device=None, dtype=None) -> dict:
    place = where(device, dtype)
    if smoke:
        scenario = abbreviated(SCENARIOS["flash-crowd"], SMOKE_DURATION_S)
        line = run_one("flash-crowd", scenario, device=device, dtype=dtype)
        return dict(line, bench="goodput-live-smoke", equivalent=True,
                    duration_s=SMOKE_DURATION_S, **place)
    lines = [run_one(name, SCENARIOS[name], device=device, dtype=dtype)
             for name in names or list(SCENARIOS)]
    return {"bench": "goodput-live", "equivalent": True, **place,
            "scenarios": lines}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_torch_goodput_live.py")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64"))
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--out", default=None)
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    out = run(opts.smoke, None if opts.smoke else scenario_names(),
              device=opts.device, dtype=getattr(torch, opts.dtype))
    for line in out.get("scenarios", ()):
        print(f"twin==online OK: {line['scenario']} ticks={line['ticks']}",
              file=sys.stderr)
    return emit(out, opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
