"""Perf-model drift watchdog: observed latency vs the model's prediction.

The controller's whole sizing chain rests on the CR's fitted alpha/beta/
gamma/delta being a faithful model of the serving stack. The reference
scrapes the observed averages (collector.go:158-278) but only copies them
to status — it never checks them against its own queueing model, so a
stale or misfitted profile silently mis-sizes the fleet forever. Here
every reconcile predicts the mean ITL/TTFT at the variant's CURRENT
allocation and observed load (the exact operating point the scrape
measured) and compares; persistent disagreement raises a
PerfModelAccurate=False condition pointing at the profile, and the ratio
is exported as inferno_model_drift_ratio for dashboards/alerts.

The reconcile cycle judges its whole pass at once: `operating_point`
takes each VA through predict_latency's early exits, and
`predict_latency_batch` analyses every surviving point in one float64
`ops/batched.py analyze_batch` call on the cycle's device, with one
readback. `predict_latency` is the scalar reference the batch is held
to: the same readings within 1e-9 relative, and a lane's bits do not
depend on the batch around it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..models.allocation import effective_batch_size
from ..models.spec import SystemSpec, resolve_for_context
from ..ops.analyzer import (
    QueueAnalyzer,
    QueueConfig,
    RequestSize,
    ServiceParms,
)
from ..ops.batched import (
    analyze_batch,
    k_max_bucket,
    k_max_for,
    make_queue_batch,
)
from ..ops.queueing import MAX_QUEUE_TO_BATCH_RATIO
from ..utils.device import readback

# Above this fraction of the per-replica max stable rate the queue is at
# (or past) the edge of its stability region: observed latencies diverge
# there even under a PERFECT model, so drift is not judged.
STABLE_REGION_FRACTION = 0.98


@dataclass(frozen=True)
class DriftReading:
    """observed/predicted ratios (None when that metric is unobservable)
    plus the predictions themselves for the condition message."""

    itl_ratio: float | None
    ttft_ratio: float | None
    predicted_itl_ms: float
    predicted_ttft_ms: float


def abs_log(ratio: float) -> float:
    import math

    return abs(math.log(ratio))


class OperatingPoint(NamedTuple):
    """One VA's judgeable operating point: the profile resolved at the
    observed context, the batch bound N, the request size, the
    per-replica arrival rate (req/sec) and the observed ITL/TTFT (msec)."""

    alpha: float
    beta: float
    gamma: float
    delta: float
    max_batch: int
    in_tokens: int
    out_tokens: int
    rate: float
    itl_ms: float
    ttft_ms: float


def profile_index(profiles) -> dict:
    """model -> accelerator -> the first profile listed for the pair,
    built once a pass. Nested, so that a pass over P profiles holds one
    dict a model, not P key tuples for the garbage collector to count."""
    index: dict = {}
    for p in profiles:
        by_acc = index.get(p.model)
        if by_acc is None:
            by_acc = index[p.model] = {}
        by_acc.setdefault(p.accelerator, p)
    return index


def operating_point(
    profiles: dict, model: str, acc_name: str, load,
    current_replicas: int, server_max_batch: int = 0,
    stale: bool = False,
) -> OperatingPoint | None:
    """The point to analyse, from a `profile_index`; None for no
    replicas, no traffic, no output tokens, a missing profile or an
    invalid queue configuration, for a load that is a last-known-good
    cache entry (stale=True: cached averages describe an EARLIER
    allocation's operating point, so judging the profile on them would
    strike it for the outage, not for drift), and where nothing was
    observed (cold start / quiet-window fallback carried arrivals but no
    latency aggregates: no evidence to judge the model on, for OR
    against)."""
    if stale:
        return None
    if current_replicas <= 0 or load.arrival_rate_rpm <= 0:
        return None
    out_tokens = int(load.avg_output_tokens)
    if out_tokens < 1:
        return None
    by_acc = profiles.get(model)
    profile = by_acc.get(acc_name) if by_acc is not None else None
    if profile is None:
        return None
    profile = resolve_for_context(profile, load.avg_input_tokens)
    n_eff = effective_batch_size(profile, server_max_batch, out_tokens)
    try:
        in_tokens = int(load.avg_input_tokens)
    except ValueError:
        return None
    # what QueueConfig.validate and RequestSize.validate refuse
    if n_eff <= 0 or in_tokens < 0:
        return None
    rate = load.arrival_rate_rpm / 60.0 / current_replicas
    if rate <= 0 or not (load.avg_itl_ms > 0 or load.avg_ttft_ms > 0):
        return None
    return OperatingPoint(
        alpha=profile.alpha, beta=profile.beta, gamma=profile.gamma,
        delta=profile.delta, max_batch=n_eff, in_tokens=in_tokens,
        out_tokens=out_tokens, rate=rate, itl_ms=load.avg_itl_ms,
        ttft_ms=load.avg_ttft_ms)


def _reading(point: OperatingPoint, max_rate: float, predicted_itl: float,
             wait: float, prefill: float) -> DriftReading | None:
    """One lane's reading from its analysis: None past the stable region
    or where no ratio can be formed."""
    if point.rate > max_rate * STABLE_REGION_FRACTION:
        return None
    predicted_ttft = wait + prefill
    itl_ratio = (point.itl_ms / predicted_itl
                 if predicted_itl > 0 and point.itl_ms > 0 else None)
    ttft_ratio = (point.ttft_ms / predicted_ttft
                  if predicted_ttft > 0 and point.ttft_ms > 0 else None)
    if itl_ratio is None and ttft_ratio is None:
        return None
    return DriftReading(
        itl_ratio=itl_ratio,
        ttft_ratio=ttft_ratio,
        predicted_itl_ms=predicted_itl,
        predicted_ttft_ms=predicted_ttft,
    )


def predict_latency(
    system_spec: SystemSpec, model: str, acc_name: str, load,
    current_replicas: int, server_max_batch: int = 0,
    stale: bool = False,
) -> DriftReading | None:
    """Model-predicted mean ITL/TTFT (msec) at the current allocation and
    RAW observed load (no demand headroom — prediction must match what
    the scrape measured, not what the engine sizes for), solved as one
    scalar QueueAnalyzer on the host. None when the operating point is
    unpredictable (`operating_point`) or outside the stable region
    (saturation legitimately blows observed latency past any
    steady-state prediction). The tests hold predict_latency_batch to
    it."""
    point = operating_point(
        profile_index(system_spec.profiles), model, acc_name, load,
        current_replicas, server_max_batch=server_max_batch, stale=stale)
    if point is None:
        return None
    qa = QueueAnalyzer(
        QueueConfig(
            max_batch_size=point.max_batch,
            max_queue_size=point.max_batch * MAX_QUEUE_TO_BATCH_RATIO,
            parms=ServiceParms(alpha=point.alpha, beta=point.beta,
                               gamma=point.gamma, delta=point.delta),
        ),
        RequestSize(avg_input_tokens=point.in_tokens,
                    avg_output_tokens=point.out_tokens),
    )
    if point.rate > qa.max_rate * STABLE_REGION_FRACTION:
        return None
    m = qa.analyze(point.rate)
    return _reading(point, qa.max_rate, m.avg_token_time, m.avg_wait_time,
                    m.avg_prefill_time)


def predict_latency_batch(points: list[OperatingPoint],
                          device) -> Iterator[DriftReading | None]:
    """predict_latency for every point at once: one float64
    analyze_batch on `device` (the grid width from the lanes' largest
    state bound, bucketed so that it repeats between passes) and one
    packed readback, both done by the call; the readings, in the points'
    order, are made as the iterator is read, so a pass holds no list of
    them. A lane past the stable region reads None, as in the scalar
    path."""
    if not points:
        return iter(())
    (alpha, beta, gamma, delta, max_batch, in_tokens, out_tokens, rate,
     _itl, _ttft) = np.array(points, dtype=np.float64).T
    q = make_queue_batch(alpha, beta, gamma, delta, in_tokens, out_tokens,
                         max_batch, dtype=torch.float64, device=device)
    m = analyze_batch(q, rate, k_max_bucket(k_max_for(max_batch)))
    packed = readback(torch.stack([m["max_rate"], m["avg_token_time"],
                                   m["avg_wait_time"],
                                   m["avg_prefill_time"]]),
                      direction="d2h-drift")
    return map(_reading, points, *(row.tolist() for row in packed))


def within_tolerance(reading: DriftReading, tolerance: float) -> bool:
    """True when every observable ratio is inside [1/(1+tol), 1+tol] —
    symmetric in log space, so an overestimating profile is flagged as
    readily as an underestimating one."""
    bound = abs_log(1.0 + tolerance)
    for r in (reading.itl_ratio, reading.ttft_ratio):
        if r is None:
            continue
        if r <= 0 or abs_log(r) > bound:
            return False
    return True
