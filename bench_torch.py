"""Candidate-sizing throughput of the PyTorch port on one NVIDIA GPU.

The counterpart of bench.py's measurements. The autoscaler's hot path is
SLO-sizing every (variant, slice-shape) candidate each reconcile cycle.
The reference runs this as a sequential per-candidate scalar loop; the
port sizes all B candidates in one call of the CUDA bisection kernels
(`ops/bisect_kernel.py`: B1, the mean form, over the 2B stacked TTFT/ITL
rows; B2, the tail form, on the TTFT rows at p95 with B1 on the ITL
rows).

    python3 bench_torch.py [--device cuda|cpu] [--candidates 4096]
        [--max-seconds 900]

Stages, in order:
- the kernel route's candidate sizings per second at B = 4096 (512
  variants x 8 slice shapes), mean and p95 forms: one warm-up call, then
  the best of 5 runs of 100 calls, each run ended by
  `torch.cuda.synchronize()`;
- the native C++ batch (`ops/native.py size_batch_native`, one FFI call
  of all B candidates, best of 3) and the sequential baseline: one sizing per candidate
  through `NativeQueueAnalyzer`, the closest stand-in for the
  reference's compiled per-candidate loop, on the card's host;
- the end-to-end stage: `System.calculate` with backend="kernel" against
  backend="batched" on the device, a 64-server fleet split into a p95
  class and a mean class (so every cycle runs both kernel forms), p50,
  min and mean ms over 20 cycles after a warm-up, and whether the two
  backends' allocations (replicas, TTFT and ITL to 4 decimals) agree.

vs_baseline = the kernel's mean-form rate / the sequential rate. Every
rate is the device's own and the record names the device (the card's
name and power limit as nvidia-smi gives them). It runs in float32 on
`cuda` unless `--device cpu` is asked, and raises without CUDA. `--max-seconds` bounds
the whole run: a stage that starts past it raises. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SERVERS_E2E = 64
CYCLES_E2E = 20
TAIL_PCT = 0.95


def build_candidates(b: int, seed: int = 0):
    """B plausible (model x slice) perf profiles around the Llama-3.1-8B
    fit (alpha=6.973, beta=0.027, gamma=5.2, delta=0.1)."""
    rng = np.random.default_rng(seed)
    return {
        "alpha": rng.uniform(4.0, 8.0, b),
        "beta": rng.uniform(0.01, 0.05, b),
        "gamma": rng.uniform(2.0, 6.0, b),
        "delta": rng.uniform(0.05, 0.15, b),
        "in_tokens": np.full(b, 128.0),
        "out_tokens": np.full(b, 128.0),
        "max_batch": np.full(b, 64, dtype=np.int64),
        "ttft": np.full(b, 500.0),
        "itl": np.full(b, 24.0),
    }


def best_of(once, n: int = 3) -> list[float]:
    """The best-of-n protocol every stage uses: n timed passes, ALL raw
    rates returned so the record carries the variance."""
    return [once() for _ in range(n)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_inputs(c, device=None, dtype=None):
    """(queues, targets, k_max) of the candidates on `device`."""
    from workload_variant_autoscaler_tpu_torch.ops.batched import (
        SLOTargets,
        k_max_for,
        make_queue_batch,
    )
    from workload_variant_autoscaler_tpu_torch.utils.device import (
        resolve_device,
        resolve_dtype,
    )

    dev, dt = resolve_device(device), resolve_dtype(dtype)
    q = make_queue_batch(
        c["alpha"], c["beta"], c["gamma"], c["delta"],
        c["in_tokens"], c["out_tokens"], c["max_batch"],
        dtype=dt, device=dev)
    targets = SLOTargets(
        ttft=torch.as_tensor(c["ttft"], dtype=dt, device=dev),
        itl=torch.as_tensor(c["itl"], dtype=dt, device=dev),
        tps=torch.zeros(len(c["alpha"]), dtype=dt, device=dev),
    )
    return q, targets, k_max_for(c["max_batch"])


def bench_card(c, iters: int = 100, n_runs: int = 5, *, device=None,
               dtype=None):
    """(mean rate, its runs, tail rate, its runs) in candidate sizings
    per second through the kernel route on `device`."""
    from workload_variant_autoscaler_tpu_torch.ops.bisect_kernel import (
        size_batch_kernel,
        size_batch_tail_kernel,
    )

    q, targets, k_max = card_inputs(c, device, dtype)
    dev = q.alpha.device
    b = len(c["alpha"])

    def timed(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(dev)
        return b * iters / (time.perf_counter() - t0)

    def mean():
        return size_batch_kernel(q, targets, k_max)

    def tail():
        return size_batch_tail_kernel(q, targets, k_max,
                                      ttft_percentile=TAIL_PCT)

    mean()
    _sync(dev)
    runs = best_of(lambda: timed(mean), n=n_runs)
    tail()
    _sync(dev)
    tail_runs = best_of(lambda: timed(tail), n=n_runs)
    return max(runs), runs, max(tail_runs), tail_runs


def bench_native_batch(c, iters: int = 1, n: int = 3
                       ) -> tuple[list[float], list[float]]:
    """(mean_rates, tail_rates), the best-of-n raw rates each, of the
    native C++ batch kernel on the host. Raises when the library cannot
    be built."""
    from workload_variant_autoscaler_tpu_torch.ops import native

    if not native.available():
        raise RuntimeError("the native queueing library cannot be built")
    # occupancy = N * (1 + MAX_QUEUE_TO_BATCH_RATIO) — the same state
    # space every production path solves
    occ = (np.asarray(c["max_batch"]) * 11).astype(np.int64)
    tps = np.zeros(len(c["alpha"]))
    b = len(c["alpha"])

    def once(**kw) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            native.size_batch_native(
                c["alpha"], c["beta"], c["gamma"], c["delta"],
                c["in_tokens"], c["out_tokens"], c["max_batch"],
                occ, c["ttft"], c["itl"], tps, **kw)
        return b * iters / (time.perf_counter() - t0)

    return (best_of(once, n=n),
            best_of(lambda: once(ttft_percentile=TAIL_PCT), n=n))


def sequential_sizings(c) -> list:
    """One sequential sizing per candidate through the native C++
    analyzer (the reference architecture's per-candidate loop)."""
    from workload_variant_autoscaler_tpu_torch.ops import native
    from workload_variant_autoscaler_tpu_torch.ops.analyzer import (
        QueueConfig,
        RequestSize,
        ServiceParms,
        TargetPerf,
    )

    if not native.available():
        raise RuntimeError("the native queueing library cannot be built")
    out = []
    for i in range(len(c["alpha"])):
        qa = native.NativeQueueAnalyzer(
            QueueConfig(
                max_batch_size=int(c["max_batch"][i]),
                max_queue_size=int(c["max_batch"][i]) * 10,
                parms=ServiceParms(
                    alpha=float(c["alpha"][i]), beta=float(c["beta"][i]),
                    gamma=float(c["gamma"][i]), delta=float(c["delta"][i]),
                ),
            ),
            RequestSize(avg_input_tokens=int(c["in_tokens"][i]),
                        avg_output_tokens=int(c["out_tokens"][i])),
        )
        out.append(qa.size(TargetPerf(ttft=float(c["ttft"][i]),
                                      itl=float(c["itl"][i]))))
    return out


def bench_sequential(c) -> float:
    """The sequential baseline's rate (best of 3), candidates/s."""
    b = len(c["alpha"])

    def once() -> float:
        t0 = time.perf_counter()
        sequential_sizings(c)
        return b / (time.perf_counter() - t0)

    return max(best_of(once))


def e2e_system(n_servers: int = SERVERS_E2E, *, device=None, dtype=None):
    """The end-to-end stage's System: n_servers models on two slice
    shapes, half in a p95-TTFT class and half in a mean class, so every
    calculate runs both kernel forms."""
    from workload_variant_autoscaler_tpu_torch.models.spec import (
        AcceleratorSpec,
        AllocationData,
        ModelSliceProfile,
        ModelTarget,
        ServerLoadSpec,
        ServerSpec,
        ServiceClassSpec,
        SystemSpec,
        with_load,
    )
    from workload_variant_autoscaler_tpu_torch.models.system import System

    spec = SystemSpec(
        accelerators=[
            AcceleratorSpec(name="v5e-4", chip="v5e", chips=4, cost=80.0),
            AcceleratorSpec(name="v5e-8", chip="v5e", chips=8, cost=160.0),
        ],
        service_classes=[
            ServiceClassSpec(name="premium", priority=1, model_targets=tuple(
                ModelTarget(model=f"m{i}", slo_itl=24.0, slo_ttft=500.0,
                            slo_ttft_percentile=TAIL_PCT)
                for i in range(n_servers))),
            ServiceClassSpec(name="freemium", priority=10, model_targets=tuple(
                ModelTarget(model=f"m{i}", slo_itl=40.0, slo_ttft=2000.0)
                for i in range(n_servers))),
        ],
        capacity={"v5e": 4096},
    )
    for i in range(n_servers):
        for acc in ("v5e-4", "v5e-8"):
            spec.profiles.append(ModelSliceProfile(
                model=f"m{i}", accelerator=acc,
                alpha=4.0 + (i % 16) * 0.25, beta=0.02 + (i % 8) * 0.004,
                gamma=3.0 + (i % 4), delta=0.08 + (i % 5) * 0.01,
                max_batch_size=64))
        spec.servers.append(ServerSpec(
            name=f"srv-{i}", model=f"m{i}",
            service_class="premium" if i % 2 == 0 else "freemium",
            current_alloc=with_load(
                AllocationData(accelerator="v5e-4", num_replicas=1),
                ServerLoadSpec(arrival_rate=30.0 + i, avg_in_tokens=128,
                               avg_out_tokens=128)),
        ))
    sysm = System(device=device, dtype=dtype)
    sysm.set_from_spec(spec)
    return sysm


def allocations(sysm) -> dict:
    """The stage's parity view: per server and slice, (replicas, TTFT,
    ITL), the latencies rounded to 4 decimals."""
    return {
        name: {acc: (a.num_replicas, round(a.ttft, 4), round(a.itl, 4))
               for acc, a in srv.all_allocations.items()}
        for name, srv in sysm.servers.items()
    }


def e2e_stage(n_servers: int = SERVERS_E2E, n_cycles: int = CYCLES_E2E, *,
              device=None, dtype=None) -> dict:
    """System.calculate per backend ("batched" then "kernel") on one
    System: a warm-up call, then n_cycles timed calls, each synchronized
    with the card; the two backends' allocations must agree."""
    sysm = e2e_system(n_servers, device=device, dtype=dtype)
    res = {"n_servers": n_servers, "n_candidates": n_servers * 2}
    parity = {}
    for backend in ("batched", "kernel"):
        sysm.calculate(backend=backend)
        _sync(sysm.device)
        lats = []
        for _ in range(n_cycles):
            t0 = time.perf_counter()
            sysm.calculate(backend=backend)
            _sync(sysm.device)
            lats.append((time.perf_counter() - t0) * 1000.0)
        lats.sort()
        res[backend] = {
            "p50_ms": round(lats[len(lats) // 2], 2),
            "min_ms": round(lats[0], 2),
            "mean_ms": round(sum(lats) / len(lats), 2),
            "cycles": len(lats),
        }
        parity[backend] = allocations(sysm)
    res["backends_agree"] = parity["batched"] == parity["kernel"]
    return res


def _compose(card: dict, sequential_rate: float, native_batch, e2e: dict,
             device: str, dtype: torch.dtype) -> dict:
    mean_runs, tail_runs = native_batch
    return {
        "metric": "candidate_sizings_per_sec",
        "value": round(card["rate"], 1),
        "unit": "candidates/s",
        "vs_baseline": round(card["rate"] / sequential_rate, 2),
        "device": device,
        "dtype": str(dtype).removeprefix("torch."),
        "candidates": card["candidates"],
        "runs": [round(r, 1) for r in card["runs"]],
        # percentile (p95 TTFT) sizing at the same fleet scale
        "tail_sizings_per_sec": round(card["tail_rate"], 1),
        "tail_runs": [round(r, 1) for r in card["tail_runs"]],
        "sequential_rate": round(sequential_rate, 1),
        "native_batch": {"rate": round(max(mean_runs), 1),
                         "runs": [round(r, 1) for r in mean_runs],
                         "tail_rate": round(max(tail_runs), 1),
                         "tail_runs": [round(r, 1) for r in tail_runs]},
        "e2e": e2e,
    }


def run(candidates: int = 4096, max_seconds: float = 900.0, *,
        device=None, dtype=None) -> dict:
    """Every stage in order; raises when a stage starts past
    `max_seconds` or fails."""
    from workload_variant_autoscaler_tpu_torch.utils.device import (
        device_name,
        resolve_device,
        resolve_dtype,
    )

    dev, dt = resolve_device(device), resolve_dtype(dtype)
    label = device_name(dev)
    t0 = time.monotonic()

    def check(stage: str) -> None:
        spent = time.monotonic() - t0
        if spent > max_seconds:
            raise TimeoutError(f"bench_torch: {spent:.0f} s spent before the "
                               f"{stage} stage (--max-seconds {max_seconds})")

    c = build_candidates(candidates)
    rate, runs, tail_rate, tail_runs = bench_card(c, device=dev, dtype=dt)
    card = {"rate": rate, "runs": runs, "tail_rate": tail_rate,
            "tail_runs": tail_runs, "candidates": candidates}
    check("native batch")
    native_batch = bench_native_batch(c)
    check("sequential")
    sequential_rate = bench_sequential(c)
    check("end-to-end")
    e2e = e2e_stage(device=dev, dtype=dt)
    return _compose(card, sequential_rate, native_batch, e2e, label, dt)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="candidate sizings per second of the port's kernels")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--candidates", type=int, default=4096)
    parser.add_argument("--max-seconds", type=float, default=900.0)
    args = parser.parse_args(argv)
    rec = run(args.candidates, args.max_seconds, device=args.device)
    print(json.dumps(rec))
    return 0 if rec["e2e"]["backends_agree"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
