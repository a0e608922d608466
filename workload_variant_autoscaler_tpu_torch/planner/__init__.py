"""Offline capacity planner: what-if sizing across slice shapes.

Operator tooling on top of the math kernel (no cluster needed): given a
model's per-slice profiles, an SLO, and an expected load, compute for
every slice shape the max SLO-holding rate per replica, the replica count
for the load, and the cost — the table an operator consults before
choosing `acceleratorType` or offering shapes in a VariantAutoscaling.

    python -m workload_variant_autoscaler_tpu_torch.planner \
        --profiles profiles.yaml --slo-ttft 500 --slo-itl 24 \
        --rate 50 --in-tokens 128 --out-tokens 128

profiles.yaml: a list of entries
    - acc: v5e-1
      cost: 20.0            # cents/hr per slice unit
      alpha: 6.973
      beta: 0.027
      gamma: 5.2
      delta: 0.1
      maxBatch: 64
      accCount: 1           # slice units per replica (optional)

The same analysis backs the controller's per-cycle sizing; this module
simply exposes it ahead of time. With `--ttft-percentile` the tail-form
sizing runs through the CUDA kernels (`ops/bisect_kernel.py`) on the card
unless `WVA_PLATFORM=cpu`; the mean form is the host's QueueAnalyzer.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..models.allocation import replica_demand
from ..ops.analyzer import (
    InfeasibleTargetError,
    QueueAnalyzer,
    QueueConfig,
    RequestSize,
    ServiceParms,
    TargetPerf,
)
from ..ops.batched import SLOTargets, k_max_for, make_queue_batch
from ..ops.fused import size_stage
from ..ops.queueing import MAX_QUEUE_TO_BATCH_RATIO
from ..utils import get_logger, kv
from ..utils.device import (
    PLATFORM_ENV,
    platform_device,
    readback,
    resolve_device,
    resolve_dtype,
)


@dataclass(frozen=True)
class SliceOption:
    """One candidate slice shape with its fitted profile."""

    acc: str
    cost: float            # cents/hr per slice unit
    alpha: float
    beta: float
    gamma: float
    delta: float
    max_batch: int
    acc_count: int = 1


@dataclass
class PlanRow:
    acc: str
    feasible: bool
    reason: str = ""
    max_rate_per_replica: float = 0.0   # req/sec holding the SLO
    replicas: int = 0
    cost_per_hour: float = 0.0          # cents/hr for the fleet
    cost_per_million_tokens: float = 0.0  # cents per 1M output tokens
    itl_ms: float = 0.0                 # at the planned per-replica rate
    ttft_ms: float = 0.0
    utilization: float = 0.0            # rho at the planned rate


def _tail_rates(
    options: list[SliceOption], target: TargetPerf,
    in_tokens: int, out_tokens: int, percentile: float,
    device: torch.device, dtype: torch.dtype,
) -> list[float | None]:
    """Per-option (by position — acc names may repeat across candidate
    fits) max SLO-holding rate (req/sec) with the TTFT target at
    `percentile` of the distribution — None = infeasible. One sizing of
    the options on `device` through the kernels (the tail form on the
    TTFT rows, the mean form on the ITL rows) and one readback. Options
    with no batch slot, which the sizing cannot index and the host
    analyzer refuses (so `plan` never reads their rate), are left out."""
    rates: list[float | None] = [None] * len(options)
    idx = [i for i, o in enumerate(options) if o.max_batch > 0]
    if not idx:
        return rates
    sized_opts = [options[i] for i in idx]
    q = make_queue_batch(
        [o.alpha for o in sized_opts], [o.beta for o in sized_opts],
        [o.gamma for o in sized_opts], [o.delta for o in sized_opts],
        np.full(len(idx), float(in_tokens)),
        np.full(len(idx), float(out_tokens)),
        [o.max_batch for o in sized_opts], dtype=dtype, device=device,
    )

    def full(v: float) -> torch.Tensor:
        return torch.full((len(idx),), v, dtype=dtype, device=device)

    sized = size_stage(
        q, SLOTargets(ttft=full(target.ttft), itl=full(target.itl),
                      tps=full(target.tps)),
        k_max_for([o.max_batch for o in sized_opts]),
        ttft_percentile=percentile, backend="kernel",
    )
    packed = readback(torch.stack([sized.feasible.to(dtype),
                                   sized.throughput]))
    for j, i in enumerate(idx):
        rate = float(packed[1, j]) * 1000.0  # req/sec
        if packed[0, j] > 0 and rate > 0:
            rates[i] = rate
    return rates


def plan(
    options: list[SliceOption],
    target: TargetPerf,
    rate_rps: float,
    in_tokens: int,
    out_tokens: int,
    ttft_percentile: float | None = None,
    *,
    device=None,
    dtype=None,
) -> list[PlanRow]:
    """Size every slice option for the load; feasible rows sorted by fleet
    cost (cheapest first), infeasible rows last. With ttft_percentile,
    the TTFT SLO is held at that percentile of the distribution (what
    WVA_TTFT_PERCENTILE / slo-ttft-percentile would do in-cluster),
    sized on `device` (default `cuda`; raises without CUDA unless
    `device="cpu"`). The mean form runs QueueAnalyzer on the host."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    tail = (_tail_rates(options, target, in_tokens, out_tokens,
                        ttft_percentile, dev, dt)
            if ttft_percentile is not None and options else [])
    rows: list[PlanRow] = []
    for idx, opt in enumerate(options):
        try:
            analyzer = QueueAnalyzer(
                QueueConfig(
                    max_batch_size=opt.max_batch,
                    max_queue_size=opt.max_batch * MAX_QUEUE_TO_BATCH_RATIO,
                    parms=ServiceParms(opt.alpha, opt.beta, opt.gamma, opt.delta),
                ),
                RequestSize(in_tokens, out_tokens),
            )
            sized = analyzer.size(target)
        except InfeasibleTargetError as e:
            rows.append(PlanRow(acc=opt.acc, feasible=False, reason=str(e)))
            continue
        except ValueError as e:
            rows.append(PlanRow(acc=opt.acc, feasible=False,
                                reason=f"invalid profile: {e}"))
            continue

        rate_star = sized.metrics.throughput  # req/sec per replica
        if ttft_percentile is not None:
            tail_rate = tail[idx]
            if tail_rate is None:
                rows.append(PlanRow(
                    acc=opt.acc, feasible=False,
                    reason=f"p{ttft_percentile * 100:.0f} TTFT target "
                           "infeasible on this slice"))
                continue
            rate_star = min(rate_star, tail_rate)
        # demand exactly as the controller computes it (a TPS SLO overrides
        # the observed rate, models/allocation.py replica_demand)
        demand_rps = replica_demand(rate_rps * 60.0, target.tps, out_tokens)
        replicas = max(math.ceil(demand_rps / rate_star), 1) if demand_rps > 0 else 1
        per_replica = demand_rps / replicas if demand_rps > 0 else 0.0
        at_rate = analyzer.analyze(per_replica) if per_replica > 0 else sized.metrics
        fleet_cost = opt.cost * opt.acc_count * replicas
        tokens_per_hour = demand_rps * out_tokens * 3600.0
        rows.append(PlanRow(
            acc=opt.acc,
            feasible=True,
            max_rate_per_replica=rate_star,
            replicas=replicas,
            cost_per_hour=fleet_cost,
            cost_per_million_tokens=(
                fleet_cost / (tokens_per_hour / 1e6) if tokens_per_hour > 0 else 0.0
            ),
            itl_ms=at_rate.avg_token_time,
            ttft_ms=at_rate.avg_wait_time + at_rate.avg_prefill_time,
            utilization=at_rate.rho,
        ))
    feasible = sorted((r for r in rows if r.feasible),
                      key=lambda r: (r.cost_per_hour, r.acc))
    return feasible + [r for r in rows if not r.feasible]


def load_options(path: str) -> list[SliceOption]:
    import yaml

    with open(path) as f:
        docs = yaml.safe_load(f)
    if not isinstance(docs, list):
        raise ValueError("profiles file must be a YAML list")
    out = []
    for i, d in enumerate(docs):
        if not isinstance(d, dict):
            raise ValueError(f"profiles entry {i} must be a mapping, got {type(d).__name__}")
        try:
            out.append(SliceOption(
                acc=str(d["acc"]),
                cost=float(d["cost"]),
                alpha=float(d["alpha"]),
                beta=float(d["beta"]),
                gamma=float(d["gamma"]),
                delta=float(d["delta"]),
                max_batch=int(d.get("maxBatch", d.get("maxBatchSize", 0))),
                acc_count=int(d.get("accCount", 1)),
            ))
        except KeyError as e:
            raise ValueError(f"profiles entry {i} ({d.get('acc', '?')}) "
                             f"missing required key {e}") from e
        except (TypeError, ValueError) as e:
            raise ValueError(f"profiles entry {i} ({d.get('acc', '?')}) "
                             f"invalid: {e}") from e
    return out


def format_table(rows: list[PlanRow]) -> str:
    header = (f"{'slice':<10} {'repl':>4} {'rate*/repl':>10} {'c/hr':>8} "
              f"{'c/Mtok':>8} {'itl ms':>7} {'ttft ms':>8} {'rho':>5}")
    lines = [header, "-" * len(header)]
    for r in rows:
        if not r.feasible:
            lines.append(f"{r.acc:<10} {'—':>4}  infeasible: {r.reason[:60]}")
            continue
        lines.append(
            f"{r.acc:<10} {r.replicas:>4} {r.max_rate_per_replica:>10.2f} "
            f"{r.cost_per_hour:>8.1f} {r.cost_per_million_tokens:>8.2f} "
            f"{r.itl_ms:>7.2f} {r.ttft_ms:>8.1f} {r.utilization:>5.2f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    def nonneg(s: str) -> float:
        v = float(s)
        if v < 0:
            raise argparse.ArgumentTypeError(f"must be >= 0, got {s}")
        return v

    parser = argparse.ArgumentParser(description="offline TPU capacity planner")
    parser.add_argument("--profiles", required=True,
                        help="YAML list of slice profile entries")
    parser.add_argument("--rate", type=nonneg, required=True,
                        help="expected arrival rate, req/sec")
    parser.add_argument("--in-tokens", type=int, default=128)
    parser.add_argument("--out-tokens", type=int, default=128)
    parser.add_argument("--slo-ttft", type=float, default=0.0, help="msec; 0 disables")
    parser.add_argument("--slo-itl", type=float, default=0.0, help="msec; 0 disables")
    parser.add_argument("--slo-tps", type=float, default=0.0, help="tokens/sec; 0 disables")
    parser.add_argument("--ttft-percentile", type=float, default=None,
                        help="hold --slo-ttft at this percentile of the "
                             "TTFT distribution, e.g. 0.95 (default: mean)")
    parser.add_argument("--json", action="store_true", help="JSON instead of a table")
    args = parser.parse_args(argv)

    if args.ttft_percentile is not None and not 0.5 < args.ttft_percentile < 1.0:
        parser.error("--ttft-percentile must be in (0.5, 1)")
    # the tail form's sizing runs on the card unless WVA_PLATFORM=cpu
    platform, device = platform_device("the planner")
    if device is None:
        get_logger("wva.planner").error(
            f"unsupported {PLATFORM_ENV}; expected one of cuda, gpu, "
            "ambient (the card) or cpu", extra=kv(value=platform))
        return 1
    rows = plan(
        load_options(args.profiles),
        TargetPerf(ttft=args.slo_ttft, itl=args.slo_itl, tps=args.slo_tps),
        args.rate, args.in_tokens, args.out_tokens,
        ttft_percentile=args.ttft_percentile, device=device,
    )
    if args.json:
        print(json.dumps([asdict(r) for r in rows], indent=2))
    else:
        print(format_table(rows))
    return 0
