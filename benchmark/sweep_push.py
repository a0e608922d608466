"""The push rate sweep: the push cell's window at several fixed push
rates, each in a fresh process, on the card. A rate is sustained when
every push is published and the backlog does not grow: the reaction
time does not climb through the window (the median of the last quarter
of pushes within 1.25 times that of the first quarter). The lowest rate
at which a run's backlog grows is the capacity; the push cell's traffic
file holds four fifths of it.

    python3 benchmark/sweep_push.py --rates 11.2,14,11.2,14 --seconds 51 --seed 7
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

PROBE = """
import json, statistics, sys
sys.path.insert(0, {root!r})
from benchmark.loops import push
from benchmark import harness
seen = {{}}
orig = harness.percentile
def keep(values, q):
    seen["react"] = list(values)
    return orig(values, q)
harness.percentile = keep
from benchmark.run import run_cell
res, _ = run_cell({cell!r}, {seed}, {seconds}, False,
                  traffic={{"rate_per_s": {rate}}})
r = seen["react"]
q = max(len(r) // 4, 1)
print(json.dumps({{"rate": {rate}, "pushes": res["attempted"],
                  "failed": res["failed"], "correct": res["correct"],
                  "p50": orig(r, 0.50), "p95": orig(r, 0.95),
                  "first_q_median": statistics.median(r[:q]),
                  "last_q_median": statistics.median(r[-q:])}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="va512-push")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    root = os.path.dirname(HERE)
    for rate in [float(x) for x in args.rates.split(",")]:
        code = PROBE.format(root=root, cell=args.cell, seed=args.seed,
                            seconds=args.seconds, rate=rate)
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        line = (out.stdout.strip().splitlines() or [""])[-1]
        try:
            row = json.loads(line)
            row["sustained"] = (row["failed"] == 0 and row["last_q_median"]
                                <= 1.25 * row["first_q_median"])
        except json.JSONDecodeError:
            row = {"rate": rate, "error": out.stderr[-2000:]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
