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
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.allocation import effective_batch_size
from ..models.spec import SystemSpec, resolve_for_context
from ..ops.analyzer import (
    QueueAnalyzer,
    QueueConfig,
    RequestSize,
    ServiceParms,
)
from ..ops.queueing import MAX_QUEUE_TO_BATCH_RATIO

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


def predict_latency(
    system_spec: SystemSpec, model: str, acc_name: str, load,
    current_replicas: int, server_max_batch: int = 0,
    stale: bool = False,
) -> DriftReading | None:
    """Model-predicted mean ITL/TTFT (msec) at the current allocation and
    RAW observed load (no demand headroom — prediction must match what
    the scrape measured, not what the engine sizes for). None when the
    operating point is unpredictable: no replicas, no traffic, missing
    profile, or outside the stable region (saturation legitimately blows
    observed latency past any steady-state prediction) — or when the
    load is a last-known-good cache entry (stale=True): cached averages
    describe an EARLIER allocation's operating point, so judging the
    profile on them would strike it for the outage, not for drift."""
    if stale:
        return None
    if current_replicas <= 0 or load.arrival_rate_rpm <= 0:
        return None
    out_tokens = int(load.avg_output_tokens)
    if out_tokens < 1:
        return None
    profile = next(
        (p for p in system_spec.profiles
         if p.model == model and p.accelerator == acc_name),
        None,
    )
    if profile is None:
        return None
    profile = resolve_for_context(profile, load.avg_input_tokens)
    n_eff = effective_batch_size(profile, server_max_batch, out_tokens)
    try:
        qa = QueueAnalyzer(
            QueueConfig(
                max_batch_size=n_eff,
                max_queue_size=n_eff * MAX_QUEUE_TO_BATCH_RATIO,
                parms=ServiceParms(alpha=profile.alpha, beta=profile.beta,
                                   gamma=profile.gamma, delta=profile.delta),
            ),
            RequestSize(avg_input_tokens=int(load.avg_input_tokens),
                        avg_output_tokens=out_tokens),
        )
    except ValueError:
        return None
    per_replica_rps = load.arrival_rate_rpm / 60.0 / current_replicas
    if per_replica_rps <= 0 or \
            per_replica_rps > qa.max_rate * STABLE_REGION_FRACTION:
        return None
    try:
        m = qa.analyze(per_replica_rps)
    except ValueError:
        return None
    predicted_itl = m.avg_token_time
    predicted_ttft = m.avg_wait_time + m.avg_prefill_time
    itl_ratio = (load.avg_itl_ms / predicted_itl
                 if predicted_itl > 0 and load.avg_itl_ms > 0 else None)
    ttft_ratio = (load.avg_ttft_ms / predicted_ttft
                  if predicted_ttft > 0 and load.avg_ttft_ms > 0 else None)
    if itl_ratio is None and ttft_ratio is None:
        # nothing observed (cold start / quiet-window fallback carried
        # arrivals but no latency aggregates): there is no evidence to
        # judge the model on, for OR against
        return None
    return DriftReading(
        itl_ratio=itl_ratio,
        ttft_ratio=ttft_ratio,
        predicted_itl_ms=predicted_itl,
        predicted_ttft_ms=predicted_ttft,
    )


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
