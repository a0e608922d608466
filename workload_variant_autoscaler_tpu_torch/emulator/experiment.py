"""Offline emulator experiments: parameter estimation + rate sweeps.

Equivalent of the reference's offline batch runner
(the Go reference's tools/vllm-emulator/experiment.py), re-purposed for the
TPU profile workflow: run the discrete-event engine (a) closed-loop at
fixed concurrency to measure ITL/TTFT vs batch size and fit the linear
decode/prefill models (alpha/beta/gamma/delta — the procedure from the
reference's parameter-estimation tutorial, docs/tutorials/
parameter-estimation.md:254-265), and (b) open-loop at swept arrival
rates to chart latency vs load for validating the queueing model.

CLI: python -m workload_variant_autoscaler_tpu_torch.emulator.experiment
     [--mode fit|sweep] [--batches 1,2,4,...] [--rates 1,2,5,...] ...
Prints one JSON document.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass

from .engine import Fleet, MetricsSink, Request, Simulation, SliceModelConfig
from .loadgen import PoissonLoadGenerator, TokenDistribution


class StatsSink(MetricsSink):
    """Collects per-request TTFT/e2e and per-token intervals."""

    def __init__(self):
        self.ttfts_ms: list[float] = []
        self.token_dts_ms: list[float] = []
        self.e2es_ms: list[float] = []
        self.finished = 0

    def on_first_token(self, req: Request) -> None:
        self.ttfts_ms.append(req.ttft_ms)

    def on_token(self, dt_ms: float) -> None:
        self.token_dts_ms.append(dt_ms)

    def on_finish(self, req: Request) -> None:
        self.finished += 1
        self.e2es_ms.append(req.e2e_ms)


def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(int(len(xs) * q), len(xs) - 1)]


def fit_linear(xs, ys) -> tuple[float, float]:
    """Least-squares y = a + b*x (the tutorial's two-point fit generalized
    to all sampled batch sizes)."""
    n = len(xs)
    if n == 0:
        return 0.0, 0.0
    if n == 1:
        return ys[0], 0.0
    mx, my = _mean(xs), _mean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0:
        return my, 0.0
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - b * mx, b


@dataclass
class FixedBatchResult:
    batch: int
    itl_ms: float
    ttft_ms: float
    throughput_rps: float
    out_tokens_per_s: float


def run_fixed_batch(
    config: SliceModelConfig,
    batch: int,
    in_tokens: int = 128,
    out_tokens: int = 128,
    rounds: int = 20,
) -> FixedBatchResult:
    """Closed loop at a fixed concurrency: keep exactly `batch` requests in
    flight on one replica until `rounds * batch` requests finish. The mean
    token interval converges to decode_ms(batch), TTFT to queue+prefill —
    the measurements the reference tutorial feeds its linear fits."""
    sink = StatsSink()
    fleet = Fleet(config, sink, replicas=1)
    sim = Simulation(fleet, seed=7)
    ids = itertools.count()
    target_finished = rounds * batch

    def submit_one(now_ms: float) -> None:
        sim.submit(Request(req_id=next(ids), in_tokens=in_tokens,
                           out_tokens=out_tokens, arrival_ms=now_ms))

    for _ in range(batch):
        submit_one(0.0)

    # refill on every finish so concurrency stays pinned at `batch`
    base_on_finish = sink.on_finish

    def on_finish_refill(req: Request) -> None:
        base_on_finish(req)
        if sink.finished + len(fleet.replicas[0].running) < target_finished:
            submit_one(sim.now_ms)

    sink.on_finish = on_finish_refill  # type: ignore[method-assign]

    horizon = 0.0
    while sink.finished < target_finished:
        horizon += 60_000.0
        sim.run_until(horizon)
        if horizon > 3_600_000.0 * 24:  # safety: a day of sim time
            break

    elapsed_s = max(sim.now_ms / 1000.0, 1e-9)
    return FixedBatchResult(
        batch=batch,
        itl_ms=_mean(sink.token_dts_ms),
        ttft_ms=_mean(sink.ttfts_ms),
        throughput_rps=sink.finished / elapsed_s,
        out_tokens_per_s=len(sink.token_dts_ms) / elapsed_s,
    )


def fit_profile(
    config: SliceModelConfig,
    batches: list[int] | None = None,
    in_tokens: int = 128,
    out_tokens: int = 128,
) -> dict:
    """Measure ITL/TTFT across batch sizes and fit the four profile
    parameters. Ground truth for the emulator is the config itself, so the
    fit doubles as an engine-consistency check (fit ~= configured values)."""
    batches = batches or [1, 2, 4, 8, 16, 32, 64]
    batches = [b for b in batches if b <= config.max_batch_size]
    results = [run_fixed_batch(config, b, in_tokens, out_tokens) for b in batches]

    alpha, beta = fit_linear([r.batch for r in results],
                             [r.itl_ms for r in results])
    # prefill model: gamma + delta * in_tokens * batch; TTFT at fixed
    # concurrency ~ wait + prefill. Fit against in_tokens*batch.
    gamma, delta = fit_linear([r.batch * in_tokens for r in results],
                              [r.ttft_ms for r in results])
    return {
        "mode": "fit",
        "slice": config.slice_name,
        "model": config.model_name,
        "in_tokens": in_tokens,
        "out_tokens": out_tokens,
        "samples": [vars(r) for r in results],
        "fitted": {"alpha": alpha, "beta": beta, "gamma": gamma, "delta": delta},
        "configured": {"alpha": config.alpha, "beta": config.beta,
                       "gamma": config.gamma, "delta": config.delta},
    }


def rate_sweep(
    config: SliceModelConfig,
    rates_rps: list[float] | None = None,
    replicas: int = 1,
    duration_s: float = 300.0,
    in_tokens: int = 128,
    out_tokens: int = 128,
    seed: int = 11,
) -> dict:
    """Open-loop Poisson sweep: latency percentiles vs offered rate, the
    curve the M/M/1/K state-dependent model predicts (validation data for
    the analyzer)."""
    rates_rps = rates_rps or [1.0, 2.0, 5.0, 10.0, 15.0, 20.0]
    points = []
    for rate in rates_rps:
        sink = StatsSink()
        fleet = Fleet(config, sink, replicas=replicas)
        sim = Simulation(fleet, seed=seed)
        gen = PoissonLoadGenerator(
            sim, schedule=[(duration_s, rate * 60.0)],
            tokens=TokenDistribution(in_tokens, out_tokens, "deterministic"),
            seed=seed,
        )
        gen.start()
        sim.run_until(duration_s * 1000.0 + 120_000.0)  # drain 2 min
        points.append({
            "rate_rps": rate,
            "generated": gen.generated,
            "finished": sink.finished,
            "ttft_mean_ms": _mean(sink.ttfts_ms),
            "ttft_p95_ms": _percentile(sink.ttfts_ms, 0.95),
            "itl_mean_ms": _mean(sink.token_dts_ms),
            "itl_p95_ms": _percentile(sink.token_dts_ms, 0.95),
            "e2e_p95_ms": _percentile(sink.e2es_ms, 0.95),
        })
    return {
        "mode": "sweep",
        "slice": config.slice_name,
        "model": config.model_name,
        "replicas": replicas,
        "points": points,
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="offline emulator experiments")
    parser.add_argument("--mode", choices=["fit", "sweep"], default="fit")
    parser.add_argument("--alpha", type=float, default=6.973)
    parser.add_argument("--beta", type=float, default=0.027)
    parser.add_argument("--gamma", type=float, default=5.2)
    parser.add_argument("--delta", type=float, default=0.1)
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--slice", dest="slice_name", default="v5e-1")
    parser.add_argument("--model", default="meta/llama-3.1-8b")
    parser.add_argument("--in-tokens", type=int, default=128)
    parser.add_argument("--out-tokens", type=int, default=128)
    parser.add_argument("--batches", default="",
                        help="comma-separated batch sizes (fit mode)")
    parser.add_argument("--rates", default="",
                        help="comma-separated req/s rates (sweep mode)")
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--duration", type=float, default=300.0,
                        help="seconds of sim time per sweep point")
    args = parser.parse_args(argv)

    config = SliceModelConfig(
        model_name=args.model, slice_name=args.slice_name,
        alpha=args.alpha, beta=args.beta, gamma=args.gamma, delta=args.delta,
        max_batch_size=args.max_batch,
        hbm_gb=16.0, model_size_gb=8.0, kv_mb_per_token=0.25,
    )
    if args.mode == "fit":
        batches = [int(b) for b in args.batches.split(",") if b] or None
        out = fit_profile(config, batches, args.in_tokens, args.out_tokens)
    else:
        rates = [float(r) for r in args.rates.split(",") if r] or None
        out = rate_sweep(config, rates, args.replicas, args.duration,
                         args.in_tokens, args.out_tokens)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    main()
