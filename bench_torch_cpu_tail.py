"""bench_torch_cpu_tail: the port's two host backends on the
percentile-tail sizing path, adjacent in time.

The counterpart of tools/cpu_tail_bench.py. It settles whether the
port's CPU default backend (`controller/translate.py engine_backend`:
"native", the C++ batch library of ops/native.py, whenever it builds)
stands for PyTorch on the host, as it did for JAX's CPU backend: it times
the native tail sizing (`size_batch_native(..., ttft_percentile=0.95)`,
one FFI call) against the port's PyTorch trip loop on the CPU
(`ops.batched.size_batch_tail`, float64) at 8 / 64 / 512 / 4096
candidates of bench_torch.py's generator, best of 3 per point, the two
backends adjacent in time so the host's load cancels in the ratio. It
also holds the two backends' sizings of each size against each other:
the same feasibility, and TTFT/ITL rates within RATE_RTOL.

This measures the host CPU by design (the backends it compares are the
host's); the record names the CPU model. It needs no card.

    python3 bench_torch_cpu_tail.py [--out PATH] [sizes ...]

Prints ONE JSON line; writes it to PATH only with `--out` (never to a
BENCH_*.json or under tests/fixtures/). Exits 1 when the measurement
does not justify the native default on this host.
"""

from __future__ import annotations

import argparse
import platform
import time

import numpy as np
import torch

from bench_torch import TAIL_PCT, best_of, build_candidates, card_inputs
from bench_torch_collect import emit, refuse_output
from workload_variant_autoscaler_tpu_torch.ops import native
from workload_variant_autoscaler_tpu_torch.ops.batched import size_batch_tail

SIZES = (8, 64, 512, 4096)
# the two backends bisect to the same tolerance from different
# arithmetic (C++ doubles against PyTorch's float64 trip loop)
RATE_RTOL = 1e-6
# each timed window's length: long enough that the timer and the host's
# jitter are small beside it
WINDOW_S = 0.5


def cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo), else platform's."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def native_tail(c):
    occ = (np.asarray(c["max_batch"]) * 11).astype(np.int64)
    return native.size_batch_native(
        c["alpha"], c["beta"], c["gamma"], c["delta"], c["in_tokens"],
        c["out_tokens"], c["max_batch"], occ, c["ttft"], c["itl"],
        np.zeros(len(c["alpha"])), ttft_percentile=TAIL_PCT)


def sizings_agree(c, q, slo, k) -> dict:
    """The two backends' sizings of one candidate set: feasibility equal,
    and the worst relative difference of their TTFT and ITL rates."""
    out, feasible = native_tail(c)
    r = size_batch_tail(q, slo, k, ttft_percentile=TAIL_PCT)
    ok = r.feasible.numpy()
    rates = np.stack([r.lam_ttft.numpy(), r.lam_itl.numpy()], 1) * 1000.0
    worst = float(np.max(np.abs(out[:, :2] - rates)
                         / np.maximum(np.abs(out[:, :2]), 1e-300)))
    return {"feasible_equal": bool(np.array_equal(feasible, ok)),
            "rate_max_rel_diff": worst,
            "equal": bool(np.array_equal(feasible, ok)) and worst <= RATE_RTOL}


def measure(b: int, window_s: float = WINDOW_S) -> dict:
    """Both backends at b candidates: each timed window repeats one
    backend's call as often as its first call says fits in `window_s`."""
    c = build_candidates(b)
    q, slo, k = card_inputs(c, "cpu", torch.float64)

    def native_call():
        native_tail(c)

    def batched_call():
        size_batch_tail(q, slo, k, ttft_percentile=TAIL_PCT)

    def rates(call) -> tuple[list[float], int]:
        t0 = time.perf_counter()
        call()
        iters = max(1, round(window_s / (time.perf_counter() - t0)))

        def once() -> float:
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            return b * iters / (time.perf_counter() - t0)

        return best_of(once), iters

    agree = sizings_agree(c, q, slo, k)
    nat_runs, nat_iters = rates(native_call)
    bat_runs, bat_iters = rates(batched_call)
    nat, bat = max(nat_runs), max(bat_runs)
    return {
        "native_tail_per_s": nat,
        "native_runs": nat_runs,
        "native_iters": nat_iters,
        "batched_cpu_tail_per_s": bat,
        "batched_runs": bat_runs,
        "batched_iters": bat_iters,
        "native_over_batched": nat / bat,
        "sizings": agree,
    }


def run(sizes=SIZES, window_s: float = WINDOW_S) -> dict:
    if not native.available():
        raise RuntimeError("the native queueing library cannot be built; "
                           "nothing to settle")
    out = {str(b): measure(b, window_s) for b in sizes}
    wins = all(row["native_over_batched"] > 1.0 for row in out.values())
    return {
        "metric": "cpu_tail_path_backend_settle",
        "device": "cpu",
        "host_cpu": cpu_model(),
        "torch_threads": torch.get_num_threads(),
        "measures": "the host CPU by design: both backends run on the host",
        "protocol": f"best-of-3 timed windows of ~{window_s} s per backend "
                    "per size, adjacent in time on the same host; "
                    "percentile-tail "
                    f"sizing (ttft_percentile={TAIL_PCT}) over bench_torch.py's "
                    "candidate generator; native = the C++ batch library "
                    "(ops/native.py), batched_cpu = ops.batched."
                    "size_batch_tail in float64 on the CPU",
        "sizes": out,
        "sizings_equal": all(r["sizings"]["equal"] for r in out.values()),
        "native_wins": wins,
        "decision": (
            "native stays the port's CPU default: it wins at every "
            "measured size when both backends run adjacent in time"
            if wins else
            "the measurement does not justify the native default on this "
            "host: re-examine controller/translate.engine_backend"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_torch_cpu_tail.py")
    parser.add_argument("--out", default=None)
    parser.add_argument("sizes", nargs="*", type=int)
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    record = run(tuple(opts.sizes) or SIZES)
    fails = [] if record["sizings_equal"] else ["the backends' sizings differ"]
    if not record["native_wins"]:
        fails.append("native does not win at every size")
    return emit(record, opts.out, fails)


if __name__ == "__main__":
    raise SystemExit(main())
