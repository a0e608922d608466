"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (`configs/`), its traffic mix
(`traffic/`, which names the generator and the window's loop,
`loops/`) and, in a `--trace 1` run, the readers of its per-layer
metrics (`layers/`). Each configuration is one fixed fleet, and
`--seed` goes to the traffic mix's generator; the mixes here draw from
fixed streams, so every seed runs the same work. The program under test
is the PyTorch and CUDA package `workload_variant_autoscaler_tpu_torch`, on the card; the run
refuses to start without one. After the window the program's outputs are
judged against the plain reference (`reference/`), and every number
compared is printed beside its limit, last on standard error and last in
the result line.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and `checks`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "workload_variant_autoscaler_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", faults=None, t_start=None,
             deployment=None, traffic=None):
    """One run of cell `name`: (the result object, the check lines). The
    CLI calls it on the card; tests call it with device="cpu" and a
    smaller `deployment` (keys of the configuration's deployment), the
    push rate sweep with other `traffic` parameters."""
    from benchmark import harness, spec

    cell = spec.resolve(name)
    cell.config["deployment"].update(deployment or {})
    cell.traffic["params"].update(traffic or {})
    harness.apply_env(cell)
    ctx = harness.Context(
        cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, t_start=T_START if t_start is None else t_start,
        generator=importlib.import_module(
            f"benchmark.traffic.{cell.traffic['generator']}"),
        faults=dict(faults or {}))
    loop = importlib.import_module(
        f"benchmark.loops.{cell.traffic['mode']}")
    out = loop.run(ctx)
    dev = dict(out["device"])
    metrics = {}
    result = {}
    if trace:
        rec = out["records"]
        for m in cell.per_layer:
            reader = spec.load_module(cell.reader_paths[m["name"]],
                                      f"layer_{m['name'].replace('.', '_')}")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        tr = rec["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    else:
        values = dict(out["metrics"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    checks = out["checks"]
    head = {"correct": checks.correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    head.update(result)
    head["checks"] = checks.as_dict()
    return head, list(out.get("notes", ())) + checks.lines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"refused: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"refused: the process holds {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
