"""The decision for one sizing group: size -> replica count -> re-analyze
-> value, on the device, with one packed [N_ROWS, B] result.

Counterpart of the reference package's `ops/fused.py decide_batch`. The
epilogue inputs (aggregate demand, the min-replica floor, the per-replica
cost rate) ride the batch as `EpilogueBatch` lanes, the replica
arithmetic is a handful of [B] ops between the sizing and the
re-analysis, and the caller reads back exactly one packed tensor. The
sizing stage is the CUDA kernels (`backend="kernel"`, plain versions on
the CPU) or the PyTorch trip loop (`backend="batched"`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .batched import (
    QueueBatch,
    SizingResult,
    SLOTargets,
    _analyze_core,
    size_batch,
    size_batch_tail,
)
from .bisect_kernel import size_batch_kernel, size_batch_tail_kernel

# rows of the packed result, in readback order
ROW_FEASIBLE = 0      # 1.0 where an allocation materializes
ROW_REPLICAS = 1      # replica count (exact small integer)
ROW_COST = 2          # cost_rate * replicas
ROW_ITL = 3           # per-replica avg token time at the final rate
ROW_TTFT = 4          # per-replica wait + prefill at the final rate
ROW_RHO = 5           # per-replica utilisation at the final rate
ROW_RATE_STAR = 6     # max stable rate per replica, req/sec
N_ROWS = 7

BACKENDS = ("kernel", "batched")


class EpilogueBatch(NamedTuple):
    """Per-candidate epilogue inputs (all [B])."""

    demand: torch.Tensor        # aggregate req/sec to provision for
    min_replicas: torch.Tensor  # int32 floor from the server spec
    cost_rate: torch.Tensor     # $ per replica (acc.cost * num_instances)


def make_epilogue_batch(demand, min_replicas, cost_rate, dtype, device,
                        pad_to: int | None = None) -> EpilogueBatch:
    """Epilogue rows on `device`, padded with benign zeros (a zero-demand
    padded lane sizes to zero replicas)."""
    demand = np.atleast_1d(np.asarray(demand, dtype=np.float64))
    pad = 0 if pad_to is None else pad_to - demand.shape[0]

    def f(x, dt):
        return torch.as_tensor(np.pad(np.atleast_1d(np.asarray(x)), (0, pad)),
                               dtype=dt, device=device)

    return EpilogueBatch(
        demand=f(demand, dtype),
        min_replicas=f(min_replicas, torch.int32),
        cost_rate=f(cost_rate, dtype),
    )


def _epilogue(q: QueueBatch, sized, epi: EpilogueBatch,
              k_max: int) -> torch.Tensor:
    """Replica count + per-replica re-analysis + cost: ceil(demand /
    rate*) clamped to the min-replica floor, the re-analysis at
    demand/replicas, feasibility = sized-feasible AND replicas > 0 AND
    the re-analysis rate is valid."""
    dtype = q.alpha.dtype
    rate_star = sized.throughput * 1000.0            # req/sec per replica
    demand = epi.demand.to(dtype)
    sizable = sized.feasible & (rate_star > 0)
    n = torch.ceil(demand / torch.where(rate_star > 0, rate_star, 1.0))
    n = torch.maximum(n, epi.min_replicas.to(dtype))
    n = torch.where(sizable & (demand > 0), n, 0.0)
    per_replica = torch.where(n > 0, demand / torch.where(n > 0, n, 1.0), 0.0)
    per = _analyze_core(q, per_replica, k_max)
    ok = sizable & (n > 0) & per["valid_rate"]
    cost = epi.cost_rate.to(dtype) * n
    return torch.stack([
        ok.to(dtype),
        n,
        cost,
        per["avg_token_time"],
        per["ttft"],
        per["rho"],
        rate_star,
    ])


def size_stage(q: QueueBatch, targets: SLOTargets, k_max: int,
               ttft_percentile: float | None = None,
               backend: str = "kernel") -> SizingResult:
    """The sizing of one group (mean form, or tail form at
    ttft_percentile) through `backend`; shared by decide_batch and the
    staged path (models/system.py)."""
    if backend == "kernel":
        if ttft_percentile is not None:
            return size_batch_tail_kernel(q, targets, k_max,
                                          ttft_percentile=ttft_percentile)
        return size_batch_kernel(q, targets, k_max)
    if backend == "batched":
        if ttft_percentile is not None:
            return size_batch_tail(q, targets, k_max,
                                   ttft_percentile=ttft_percentile)
        return size_batch(q, targets, k_max)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def decide_batch(q: QueueBatch, targets: SLOTargets, epi: EpilogueBatch,
                 k_max: int, ttft_percentile: float | None = None,
                 backend: str = "kernel") -> torch.Tensor:
    """The packed [N_ROWS, B] decision of one sizing group."""
    sized = size_stage(q, targets, k_max, ttft_percentile, backend)
    return _epilogue(q, sized, epi, k_max)
