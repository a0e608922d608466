"""Time the port's bisection kernel against other versions of its source,
on one NVIDIA GPU.

    python3 bench_torch_bisect.py [--max-batch 512] [--queues 2048]
        [--baseline OTHER.cu ...]

It builds `csrc/bisect_kernel.cu` of the checkout (through ops/_build.py)
and each baseline, another version of that source with the same four
`wva_bisect_{mean,tail}_{f32,f64}` launchers, into `build/torch_kernels/`.
It makes `queues` queues of one max_batch from a seed (profiles drawn
around the Llama-3.1-8B fit, the premium class's targets: TTFT 500 ms,
at p95 in the tail form, and ITL 24 ms), so every row has the same state
count, 11 x max_batch. For each form and dtype it holds every build
against the plain PyTorch version (float32 rtol 1e-3 mean, 2e-3 tail;
float64 1e-9), then times one launch of each with CUDA events, in turns
(A B .. B A), and prints the median of each. The mean form takes the
2 x queues TTFT and ITL rows, the tail form the queues TTFT rows. Exits
non-zero when CUDA is absent, when a build disagrees with the plain
version or when the checkout's launch fails (a baseline that cannot take
the rows is reported and left out).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import ptxas_summary

SEED = 0
REPS = 15
RTOL = {("mean", torch.float32): 1e-3, ("tail", torch.float32): 2e-3,
        ("mean", torch.float64): 1e-9, ("tail", torch.float64): 1e-9}
TAIL_PCT = 0.95


def load(source: Path):
    """ctypes handle of one version of the kernel source, built with the
    package's nvcc flags (printing its registers and spills)."""
    from workload_variant_autoscaler_tpu_torch.ops import _build

    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libbench_bisect_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                                str(out), str(source)], check=True,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        for kernel, line in ptxas_summary(built.stdout):
            print(f"  nvcc {source}: {kernel}: {line}", flush=True)
    lib = ctypes.CDLL(str(out))
    for form in ("mean", "tail"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"wva_bisect_{form}_{dt}")
            fn.argtypes, fn.restype = _build._BISECT, ctypes.c_int
    return lib


def queues(n: int, max_batch: int, dtype, device):
    from workload_variant_autoscaler_tpu_torch.ops import batched as tb

    rng = np.random.default_rng(SEED)
    u = rng.uniform(0.8, 1.25, (4, n))
    q = tb.make_queue_batch(6.973 * u[0], 0.027 * u[1], 5.2 * u[2],
                            0.1 * u[3], rng.choice([128.0, 256.0, 512.0], n),
                            rng.choice([128.0, 256.0], n),
                            np.full(n, max_batch), dtype=dtype, device=device)
    full = torch.full((n,), 1.0, dtype=dtype, device=device)
    t = tb.SLOTargets(500.0 * full, 24.0 * full, 0.0 * full)
    return q, t, tb.k_max_bucket(tb.k_max_for([max_batch]))


def launch_args(form: str, dtype, n: int, max_batch: int, device="cuda"):
    from workload_variant_autoscaler_tpu_torch.ops import batched as tb
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    q, t, k = queues(n, max_batch, dtype, device)
    if form == "mean":
        prob, _ = tb._sizing_problem(q, t, k)
        fcols, icols = bk.columns(prob, slice(0, 2 * n))
        return fcols, icols, bk._full_clm(q, k), k, None
    prob, _ = tb._tail_problem(q, t, k, TAIL_PCT)
    fcols, icols = bk.columns(prob, slice(0, n), slo=t.ttft,
                              mun=tb._full_batch_mu(q))
    return fcols, icols, bk._full_clm(q, k), k, TAIL_PCT


def call(lib, form, args):
    """One launch of a build's launcher on the current stream."""
    from workload_variant_autoscaler_tpu_torch.ops.batched import (
        bisection_trips)

    fcols, icols, clm, k, pct = args
    fn = getattr(lib, f"wva_bisect_{form}_"
                      f"{'f64' if clm.dtype == torch.float64 else 'f32'}")
    out = torch.empty(fcols.shape[0], dtype=clm.dtype, device=clm.device)
    err = fn(fcols.data_ptr(), icols.data_ptr(), clm.data_ptr(),
             out.data_ptr(), fcols.shape[0], clm.shape[0], k,
             bisection_trips(clm.dtype), 0.0 if pct is None else pct,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def event_ms(fn) -> list[float]:
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--queues", type=int, default=2048)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_bisect: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from workload_variant_autoscaler_tpu_torch.ops import _build
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    builds = {"checkout": _build.SOURCES["bisect_kernel"].relative_to(
        Path.cwd()), **{
        str(p): p for p in a.baseline}}
    libs = {name: load(src) for name, src in builds.items()}
    print(f"card {card}; max_batch {a.max_batch}; {a.queues} queues",
          flush=True)
    results = []
    for dtype in (torch.float32, torch.float64):
        for form in ("mean", "tail"):
            args = launch_args(form, dtype, a.queues, a.max_batch)
            ref = bk.bisect_plain(*args)
            rtol = RTOL[form, dtype]
            takes = {}
            for name, lib in libs.items():
                try:
                    got = call(lib, form, args)
                except RuntimeError as e:
                    if name == "checkout":
                        raise
                    # a baseline whose shared memory cannot hold the rows
                    print(f"  {form} {str(dtype)[6:]} {name}: {e}")
                    continue
                err = float(((got - ref).abs() / ref.abs()).max())
                if not err <= rtol:
                    raise AssertionError(f"{name} {form} {dtype}: max rel "
                                         f"err {err:.3e} over rtol {rtol:g}")
                takes[name] = lib
            samples = {name: [] for name in takes}
            for name in list(takes) + list(reversed(takes)):
                call(takes[name], form, args)
                samples[name] += event_ms(
                    lambda lib=takes[name]: call(lib, form, args))
            for name in takes:
                ms = statistics.median(samples[name])
                results.append({"form": form, "dtype": str(dtype)[6:],
                                "rows": args[0].shape[0], "k_max": args[3],
                                "build": name, "ms": ms})
                print(f"  {form} {str(dtype)[6:]} rows={args[0].shape[0]} "
                      f"k_max={args[3]} {name}: {ms:.4f} ms", flush=True)
    print(json.dumps({"card": card, "max_batch": a.max_batch,
                      "queues": a.queues, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
