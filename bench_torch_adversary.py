"""bench_torch_adversary: the adversarial scenario search of the port,
with every evaluation's reconcile cycles on the card.

The counterpart of bench_adversary.py. It runs the seeded (1+lambda)
perturb-and-select search (the port's `emulator.adversary.search`) over
the typed scenario-parameter space (`emulator.scenarios.adversarial`),
minimizing cost-weighted goodput through the real Reconciler in the
port's twin (`emulator.twin.run_scenario`), then:

- runs the SAME search again and requires the two audit trails to be
  byte-identical (an invariant: it raises);
- requires the evaluation count to equal the budget (1 + generations x
  population; an invariant);
- scores the worst find under the hardened controller config (the
  WVA_DEGRADED_SCALEUP_FREEZE shed-window guardrail and the
  WVA_TTFT_BACKPRESSURE observed-latency floor), and promotes each
  generation's worst find with its hardened goodput and a regression
  floor FLOOR_MARGIN below it;
- reports two results as met or not met: the search's worst goodput is
  strictly below the hand-written library's minimum, and the hardened
  config beats the unhardened one on the worst find. Both rest on the
  run's own decisions (float32 on the card unless asked).

The hand-library minimum is the port's: `--hand PATH` reads a
`bench_torch_goodput.py --out` record; without it the goodput scoreboard
runs in this process first, on the same device and dtype.

    python3 bench_torch_adversary.py [--device cuda|cpu]
        [--dtype float32|float64] [--seed 14] [--generations 3]
        [--population 8] [--hand PATH] [--smoke] [--out PATH]
        [--archive-out PATH]

`--smoke` runs 1 generation x 2 candidates at 120 s of simulated time,
only the search and its budget check. Prints ONE JSON line (the record:
bench_adversary.py's keys, where it ran, the B1/B2 launches and sizing
readbacks per reconcile cycle of the search); wall clock goes to stderr.
It writes the record only to `--out` and the promoted archive only to
`--archive-out`, and refuses a BENCH_*.json or a path under
tests/fixtures/ for either (the JAX package's committed records and
archive). Runs on `cuda` in float32 unless asked; raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import bench_torch_goodput
from bench_torch_collect import (
    cycle_launches,
    emit,
    launch_summary,
    refuse_output,
)
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.emulator.adversary import (
    DEFAULT_GENERATIONS,
    DEFAULT_POPULATION,
    DEFAULT_SEED,
    search,
)
from workload_variant_autoscaler_tpu_torch.emulator.scenarios.adversarial import (
    ARCHIVE_VERSION,
    DURATION_S,
    scenario_from_params,
)
from workload_variant_autoscaler_tpu_torch.emulator.twin import run_scenario

# the shipped hardening pair (controller/reconciler.py): the degraded-
# evidence scale-up freeze and the observed-TTFT backpressure floor at
# x2 growth
HARDENED_OPERATOR = {
    "WVA_DEGRADED_SCALEUP_FREEZE": "1",
    "WVA_TTFT_BACKPRESSURE": "2",
}

# promoted regression floors sit this far below the measured goodput:
# the floor guards intent ("never meaningfully worse"), not bit-equality
FLOOR_MARGIN = 0.05

SMOKE_GENERATIONS = 1
SMOKE_POPULATION = 2
SMOKE_DURATION_S = 120.0
# the keys of this script's records that time a run on the host's clock
WALL_KEYS = frozenset({"wall_s"})


def run_search(seed: int, generations: int, population: int,
               duration_s: float, *, device=None, dtype=None) -> dict:
    """One search's audit trail (SearchResult.to_dict), its launches per
    reconcile cycle and its wall seconds; raises unless it ran exactly
    its budget of evaluations."""
    with cycle_launches() as rows:
        t0 = time.perf_counter()
        result = search(seed=seed, generations=generations,
                        population=population, duration_s=duration_s,
                        device=device, dtype=dtype)
        wall = time.perf_counter() - t0
    if len(result.evaluations) != result.budget:
        raise AssertionError(f"the search ran {len(result.evaluations)} "
                             f"evaluations, its budget is {result.budget}")
    return {"result": result.to_dict(), "kernel_launches":
            launch_summary(rows), "wall_s": wall}


def hardened_goodput(params: dict, name: str, seed: int, duration_s: float,
                     *, device=None, dtype=None) -> float:
    return run_scenario(scenario_from_params(
        params, name=name, seed=seed, duration_s=duration_s,
        operator_extra=HARDENED_OPERATOR),
        device=device, dtype=dtype).goodput_fraction


def promote(result: dict, seed: int, duration_s: float, *, device=None,
            dtype=None) -> list[dict]:
    """Each generation's worst find, deduplicated by parameter point,
    scored under the hardened config and stamped with its regression
    floor. The promoted scenario carries the HARDENED operator overlay:
    the floor pins the guardrail's behavior, not the vulnerability."""
    promoted = []
    seen: set[str] = set()
    for entry in result["generation_worst"]:
        point = json.dumps(entry["params"], sort_keys=True)
        if point in seen:
            continue
        seen.add(point)
        name = f"adv-r14-g{entry['generation']}"
        hardened = hardened_goodput(entry["params"], name, seed, duration_s,
                                    device=device, dtype=dtype)
        promoted.append({
            "name": name,
            "seed": seed,
            "duration_s": duration_s,
            "params": entry["params"],
            "unhardened_goodput": entry["goodput"],
            "hardened_goodput": round(hardened, 6),
            "floor": max(0.0, round(hardened - FLOOR_MARGIN, 6)),
            "operator": dict(HARDENED_OPERATOR),
        })
    return promoted


def hand_library_min(record: dict) -> float:
    """The lowest per-scenario goodput of a bench_torch_goodput record."""
    return min(s["goodput_fraction"] for s in record["scenarios"].values())


def smoke_record(first: dict, place: dict) -> dict:
    """bench_adversary.py's record keys of one search, with where it ran
    and its launches."""
    result = first["result"]
    return {
        "metric": "adversarial_worst_goodput",
        "bench": "adversary",
        "value": result["worst"]["goodput"],
        "unit": "useful-cost-fraction",
        "seed": result["seed"],
        "generations": result["generations"],
        "population": result["population"],
        "duration_s": result["duration_s"],
        "budget": result["budget"],
        "worst": result["worst"],
        **place,
        "kernel_launches": first["kernel_launches"],
    }


def finish(first: dict, second: dict, hand_min: float, place: dict, *,
           device=None, dtype=None) -> dict:
    """The full record of a search and its same-seed rerun (each a
    `run_search` result, from this process or another): raises unless
    the two are byte-identical; then the hardened run, the promotion and
    the two results, met or not met."""
    deterministic = (json.dumps(first["result"], sort_keys=True)
                     == json.dumps(second["result"], sort_keys=True))
    if not deterministic:
        raise AssertionError("same-seed rerun diverged: the search is not "
                             "deterministic")
    result = first["result"]
    seed, duration_s = result["seed"], result["duration_s"]
    worst = result["worst"]
    hardened = round(hardened_goodput(
        worst["params"], "adv-worst-hardened", seed, duration_s,
        device=device, dtype=dtype), 6)
    record = smoke_record(first, place)
    record.update({
        "deterministic": deterministic,
        "hand_library_min": round(hand_min, 6),
        "unhardened_goodput": worst["goodput"],
        "hardened_goodput": hardened,
        "hardened_operator": dict(HARDENED_OPERATOR),
        "promoted": promote(result, seed, duration_s, device=device,
                            dtype=dtype),
        "generation_worst": result["generation_worst"],
        "evaluations": result["evaluations"],
        "results": [
            {"result": "worst below the hand library's minimum",
             "value": worst["goodput"], "limit": round(hand_min, 6),
             "met": "met" if worst["goodput"] < hand_min else "not met"},
            {"result": "hardened beats unhardened on the worst find",
             "value": hardened, "limit": worst["goodput"],
             "met": "met" if hardened > worst["goodput"] else "not met"}],
    })
    return record


def archive(record: dict) -> dict:
    """The promoted scenarios in the archive format the port's
    `scenarios_from_archive` reads."""
    return {
        "version": ARCHIVE_VERSION,
        "seed": record["seed"],
        "scenarios": [
            {"name": p["name"], "seed": p["seed"],
             "duration_s": p["duration_s"], "params": p["params"],
             "floor": p["floor"], "operator": p["operator"]}
            for p in record["promoted"]],
    }


def run(seed: int = DEFAULT_SEED, generations: int = DEFAULT_GENERATIONS,
        population: int = DEFAULT_POPULATION, duration_s: float = DURATION_S,
        hand_min: float | None = None, *, device=None,
        dtype=None) -> tuple[dict, dict]:
    """The whole bench in this process: (the record, wall seconds)."""
    place = where(device, dtype)
    on = {"device": device, "dtype": dtype}
    walls = {}
    if hand_min is None:
        t0 = time.perf_counter()
        hand_min = hand_library_min(bench_torch_goodput.run(**on)[0])
        walls["hand_library"] = time.perf_counter() - t0
    first = run_search(seed, generations, population, duration_s, **on)
    second = run_search(seed, generations, population, duration_s, **on)
    walls.update(search=first["wall_s"], rerun=second["wall_s"])
    t0 = time.perf_counter()
    record = finish(first, second, hand_min, place, **on)
    walls["hardened_and_promote"] = time.perf_counter() - t0
    return record, walls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_torch_adversary.py")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64"))
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--generations", type=int, default=None)
    parser.add_argument("--population", type=int, default=None)
    parser.add_argument("--hand", default=None)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--archive-out", default=None)
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    refuse_output(parser, opts.archive_out)
    on = {"device": opts.device, "dtype": getattr(torch, opts.dtype)}
    generations = opts.generations or (
        SMOKE_GENERATIONS if opts.smoke else DEFAULT_GENERATIONS)
    population = opts.population or (
        SMOKE_POPULATION if opts.smoke else DEFAULT_POPULATION)
    if opts.smoke:
        place = where(**on)
        first = run_search(opts.seed, generations, population,
                           SMOKE_DURATION_S, **on)
        print(f"wall_s: search={first['wall_s']}", file=sys.stderr)
        return emit(smoke_record(first, place), opts.out)
    hand_min = None
    if opts.hand:
        with open(opts.hand, encoding="utf-8") as f:
            hand_min = hand_library_min(json.load(f))
    record, walls = run(opts.seed, generations, population, DURATION_S,
                        hand_min, **on)
    print(f"wall_s: {json.dumps(walls)}", file=sys.stderr)
    if opts.archive_out:
        with open(opts.archive_out, "w", encoding="utf-8") as f:
            json.dump(archive(record), f, indent=1)
            f.write("\n")
    return emit(record, opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
