"""The control: the reference put in the program's place, computed in the
nearest precision below the configuration's (bfloat16 for float32), and
judged by the harness's own comparison. It has to come out not correct.

    python3 benchmark/control.py --workload va512-shift --seeds 11,12,13 --seconds 20

The control replaces the bisection kernels (`ops/bisect_kernel.bisect`,
B1 and B2): every row a launch would search is searched by the
reference's bisection (`reference/sizing.py search_rows`) on the same
inputs, in the control's dtype, and the rest of the program runs as it
is. Each seed is one run of the cell at its own size through
`run.run_cell`, with the cell's own window, traffic and judge; one JSON
line per seed gives `correct` and every number beside its limit. The
benchmark's own runs never load this module.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.reference.sizing import search_rows  # noqa: E402
from benchmark.roofline import (F_ALPHA, F_SLO, F_TARGET, F_X0,  # noqa: E402
                                I_DONE, I_NMAX, I_TTFT)

KERNEL = "workload_variant_autoscaler_tpu_torch.ops.bisect_kernel"
FUSED = "workload_variant_autoscaler_tpu_torch.ops.fused"


def reference_bisect(dtype):
    """A stand-in for `bisect_kernel.bisect`: the reference's search of
    every row in `dtype`; rows the program resolved before the search
    (`done`, padding among them) keep their start value, as the kernel
    leaves them."""
    def make(_orig):
        def bisect(fcols, icols, clm, k_max, tail_pct=None):
            f = fcols.to(dtype)
            cols = [f[:, F_ALPHA + j] for j in range(6)]
            x = search_rows(
                *cols, n_max=icols[:, I_NMAX], target=f[:, F_TARGET],
                is_ttft=icols[:, I_TTFT] > 0,
                slo_ttft=None if tail_pct is None else f[:, F_SLO],
                pct=tail_pct)
            done = icols[:, I_DONE] > 0
            return torch.where(done, fcols[:, F_X0], x.to(fcols.dtype))
        return bisect
    return make


def through_kernel_path(orig):
    """The sizing stage on the kernels' path whatever the device, so that
    a run on the CPU (the tests') reaches `bisect_kernel.bisect` too."""
    def size_stage(q, targets, k_max, ttft_percentile=None,
                   backend="kernel"):
        return orig(q, targets, k_max, ttft_percentile, "kernel")
    return size_stage


def faults(dtype=torch.bfloat16, device: str = "cuda") -> dict:
    """The control as `run_cell` takes a planted fault."""
    out = {(KERNEL, "bisect"): reference_bisect(dtype)}
    if device == "cpu":
        out[(FUSED, "size_stage")] = through_kernel_path
    return out


def main() -> int:
    from benchmark.run import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("refused: the control runs on a CUDA card", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        res, _lines = run_cell(args.workload, int(s), args.seconds, False,
                               faults=faults(getattr(torch, args.dtype)),
                               t_start=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "dtype": args.dtype, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
