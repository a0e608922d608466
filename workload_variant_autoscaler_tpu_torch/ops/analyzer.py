"""Queue analyzer: evaluate and SLO-size an inference-server queue.

Instance-scoped equivalent of the reference analyzer
(the Go reference's pkg/analyzer/queueanalyzer.go). Service times follow the
fitted linear models

    prefill(n) = gamma + delta * in_tokens * n        (msec)
    decode(n)  = alpha + beta  * n                    (msec)

and the state-dependent service rate with n requests in service is

    serv_rate[n] = n / (prefill(n) + (out_tokens - 1) * decode(n))

(reference queueanalyzer.go:99-131). `analyze` evaluates metrics at a given
request rate; `size` inverts the model, binary-searching the max rate that
meets TTFT/ITL targets and applying the 10% stability margin for TPS
(queueanalyzer.go:185-255).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .queueing import (
    EPSILON,
    STABILITY_SAFETY_FRACTION,
    QueueStats,
    state_dependent_probabilities,
    state_dependent_solve,
)
from .search import BELOW_REGION, binary_search


class InfeasibleTargetError(ValueError):
    """SLO target cannot be met at any stable rate (target below the
    bounded region, reference queueanalyzer.go:208-215)."""


@dataclass(frozen=True)
class ServiceParms:
    alpha: float  # decode base (msec)
    beta: float   # decode slope (msec per unit batch)
    gamma: float  # prefill base (msec)
    delta: float  # prefill slope (msec per token per unit batch)


@dataclass(frozen=True)
class RequestSize:
    avg_input_tokens: int
    avg_output_tokens: int

    def validate(self) -> None:
        if self.avg_input_tokens < 0 or self.avg_output_tokens < 1:
            raise ValueError(f"invalid request size {self}")


@dataclass(frozen=True)
class QueueConfig:
    max_batch_size: int
    max_queue_size: int
    parms: ServiceParms

    def validate(self) -> None:
        if self.max_batch_size <= 0 or self.max_queue_size < 0:
            raise ValueError(f"invalid queue configuration {self}")


@dataclass(frozen=True)
class TargetPerf:
    ttft: float = 0.0  # msec; 0 disables
    itl: float = 0.0   # msec; 0 disables
    tps: float = 0.0   # tokens/sec; 0 disables

    def validate(self) -> None:
        if self.ttft < 0 or self.itl < 0 or self.tps < 0:
            raise ValueError(f"invalid target {self}")


@dataclass(frozen=True)
class AnalysisMetrics:
    """Rates per second, times in msec (reference queueanalyzer.go:60-69)."""

    throughput: float        # req/sec
    avg_resp_time: float     # msec
    avg_wait_time: float     # msec
    avg_num_in_serv: float
    avg_prefill_time: float  # msec
    avg_token_time: float    # msec (ITL)
    max_rate: float          # req/sec
    rho: float


@dataclass(frozen=True)
class SizeResult:
    rate_ttft: float        # req/sec
    rate_itl: float         # req/sec
    rate_tps: float         # req/sec
    metrics: AnalysisMetrics
    achieved: TargetPerf


def prefill_time(parms: ServiceParms, avg_input_tokens: int, batch_size: float) -> float:
    """Zero when there is nothing to prefill (reference queueanalyzer.go:257-262)."""
    if avg_input_tokens == 0:
        return 0.0
    return parms.gamma + parms.delta * avg_input_tokens * batch_size


def decode_time(parms: ServiceParms, batch_size: float) -> float:
    return parms.alpha + parms.beta * batch_size


def service_rates(config: QueueConfig, size: RequestSize) -> np.ndarray:
    """serv_rate[n-1] for n = 1..max_batch (reference queueanalyzer.go:103-113)."""
    n = np.arange(1, config.max_batch_size + 1, dtype=np.float64)
    pre = np.where(
        size.avg_input_tokens == 0,
        0.0,
        config.parms.gamma + config.parms.delta * size.avg_input_tokens * n,
    )
    num_decode = size.avg_output_tokens - 1
    if size.avg_input_tokens == 0 and size.avg_output_tokens == 1:
        num_decode = 1  # decode-only single-token special case
    dec = num_decode * (config.parms.alpha + config.parms.beta * n)
    return n / (pre + dec)


def effective_concurrency(
    avg_service_time: float, parms: ServiceParms, size: RequestSize, max_batch_size: int
) -> float:
    """Invert prefill(n) + (out-1)*decode(n) = S for n, clamped to [0, N]
    (reference queueanalyzer.go:296-302). A degenerate zero denominator
    (out_tokens == 1 and in_tokens == 0) maps to the batch bound.
    """
    tokens = float(size.avg_output_tokens - 1)
    numerator = avg_service_time - (parms.gamma + parms.alpha * tokens)
    denominator = parms.delta * size.avg_input_tokens + parms.beta * tokens
    if denominator == 0.0:
        return float(max_batch_size) if numerator > 0 else 0.0
    return min(max(numerator / denominator, 0.0), float(max_batch_size))


class QueueAnalyzer:
    """Evaluate/size one inference-server queue. All state is per-instance;
    safe for concurrent use (unlike reference globals, queueanalyzer.go:176-179).
    """

    def __init__(self, config: QueueConfig, size: RequestSize):
        config.validate()
        size.validate()
        self.config = config
        self.request_size = size
        self.serv_rate = service_rates(config, size)
        self.occupancy = config.max_queue_size + config.max_batch_size
        # Stable rate range, req/msec (reference queueanalyzer.go:116-119).
        self.lambda_min = float(self.serv_rate[0]) * EPSILON
        self.lambda_max = float(self.serv_rate[-1]) * (1.0 - EPSILON)

    # rate range in req/sec, as surfaced in metrics
    @property
    def max_rate(self) -> float:
        return self.lambda_max * 1000.0

    @property
    def min_rate(self) -> float:
        return self.lambda_min * 1000.0

    def _solve(self, lam: float) -> QueueStats:
        return state_dependent_solve(lam, self.serv_rate, self.occupancy)

    def _ttft_at(self, lam: float) -> float:
        stats = self._solve(lam)
        conc = effective_concurrency(
            stats.avg_serv_time, self.config.parms, self.request_size, self.config.max_batch_size
        )
        return stats.avg_wait_time + prefill_time(
            self.config.parms, self.request_size.avg_input_tokens, conc
        )

    def _ttft_tail_at(self, lam: float, slo_ttft: float,
                      percentile: float) -> float:
        """P(TTFT exceeds slo_ttft) at rate lam, for percentile sizing —
        the scalar twin of ops/batched.py `_tail_problem` /
        native/wva_queueing.cpp `ttft_tail_at`: prefill at the PERCENTILE
        of the occupancy distribution plus the PASTA/Erlang queueing-wait
        tail. For integer k the Erlang survival is the partial Poisson
        sum Q(k, x) = e^-x sum_{i<k} x^i/i!, built from one cumsum of
        per-step log increments (every operand O(log K) — the same
        precision argument as batched.wait_tail_probability)."""
        K = self.occupancy
        N = self.config.max_batch_size
        p = state_dependent_probabilities(lam, self.serv_rate, K)

        # occupancy percentile -> prefill budget
        nq = int(np.sum(np.cumsum(p) < percentile))
        bq = min(nq, N)
        prefill_q = prefill_time(
            self.config.parms, self.request_size.avg_input_tokens, bq)
        if prefill_q >= slo_ttft:
            return 1.0
        threshold = slo_ttft - prefill_q

        den = float(np.sum(p[:K]))  # accepted arrivals (state K blocked)
        if den <= 0.0 or K <= N:
            return 0.0

        x = float(self.serv_rate[-1]) * threshold  # full-batch departures
        if x <= 0.0:
            return float(np.sum(p[N:K])) / den     # Q(k, 0) = 1
        ks = np.arange(1, K - N + 1, dtype=np.float64)  # k for states N..K-1
        log_terms = -x + np.concatenate(
            [[0.0], np.cumsum(np.log(x) - np.log(ks[:-1]))])
        q_cum = np.minimum(np.cumsum(np.exp(log_terms)), 1.0)  # Q(k, x)
        num = float(np.dot(p[N:K], q_cum))
        return num / den

    def _itl_at(self, lam: float) -> float:
        stats = self._solve(lam)
        conc = effective_concurrency(
            stats.avg_serv_time, self.config.parms, self.request_size, self.config.max_batch_size
        )
        return decode_time(self.config.parms, conc)

    def analyze(self, request_rate: float) -> AnalysisMetrics:
        """Metrics at a request rate in req/sec (reference queueanalyzer.go:134-174)."""
        if request_rate <= 0:
            raise ValueError(f"invalid request rate {request_rate}")
        if request_rate > self.max_rate:
            raise ValueError(f"rate={request_rate} above max allowed rate={self.max_rate}")

        stats = self._solve(request_rate / 1000.0)
        conc = effective_concurrency(
            stats.avg_serv_time, self.config.parms, self.request_size, self.config.max_batch_size
        )
        pre = prefill_time(self.config.parms, self.request_size.avg_input_tokens, conc)
        tok = decode_time(self.config.parms, conc)
        rho = min(max(stats.avg_num_in_servers / self.config.max_batch_size, 0.0), 1.0)
        return AnalysisMetrics(
            throughput=stats.throughput * 1000.0,
            avg_resp_time=stats.avg_resp_time,
            avg_wait_time=stats.avg_wait_time,
            avg_num_in_serv=stats.avg_num_in_servers,
            avg_prefill_time=pre,
            avg_token_time=tok,
            max_rate=self.max_rate,
            rho=rho,
        )

    def size(self, target: TargetPerf,
             ttft_percentile: Optional[float] = None) -> SizeResult:
        """Max request rates meeting each target, and metrics at the binding
        one (reference queueanalyzer.go:185-255). Raises
        InfeasibleTargetError when a target is below the achievable region.

        ttft_percentile: hold the TTFT SLO at this percentile of the TTFT
        distribution instead of its mean — max lam such that
        P(TTFT > slo_ttft) <= 1 - percentile (the scalar twin of
        ops/batched.size_batch_tail / native wva_size_tail; the search is
        forced increasing because the tail probability can be ~0 at both
        boundaries).
        """
        target.validate()
        if ttft_percentile is not None and not 0.0 < ttft_percentile < 1.0:
            raise ValueError(f"invalid ttft_percentile {ttft_percentile}")
        lam_min, lam_max = self.lambda_min, self.lambda_max

        lam_ttft = lam_max
        if target.ttft > 0:
            if ttft_percentile is not None:
                res = binary_search(
                    lam_min, lam_max, 1.0 - ttft_percentile,
                    lambda lam: self._ttft_tail_at(
                        lam, target.ttft, ttft_percentile),
                    increasing=True,
                )
            else:
                res = binary_search(lam_min, lam_max, target.ttft,
                                    self._ttft_at)
            if res.indicator == BELOW_REGION:
                if ttft_percentile is not None:
                    # diagnose in the quantity actually searched: citing
                    # the MEAN region bound here could show a value below
                    # the SLO and look self-contradictory
                    raise InfeasibleTargetError(
                        f"p{ttft_percentile * 100:g} TTFT target "
                        f"{target.ttft} infeasible: P(TTFT > slo) at the "
                        f"minimum rate is "
                        f"{self._ttft_tail_at(lam_min, target.ttft, ttft_percentile):.4f}"
                        f" > {1.0 - ttft_percentile:.4f}"
                    )
                raise InfeasibleTargetError(
                    f"TTFT target {target.ttft} below bounded region "
                    f"[{self._ttft_at(lam_min)}, ...]"
                )
            lam_ttft = res.x_star

        lam_itl = lam_max
        if target.itl > 0:
            res = binary_search(lam_min, lam_max, target.itl, self._itl_at)
            if res.indicator == BELOW_REGION:
                raise InfeasibleTargetError(
                    f"ITL target {target.itl} below bounded region "
                    f"[{self._itl_at(lam_min)}, ...]"
                )
            lam_itl = res.x_star

        lam_tps = lam_max
        if target.tps > 0:
            lam_tps = lam_max * (1.0 - STABILITY_SAFETY_FRACTION)

        lam = min(lam_ttft, lam_itl, lam_tps)
        metrics = self.analyze(lam * 1000.0)
        achieved = TargetPerf(
            ttft=metrics.avg_wait_time + metrics.avg_prefill_time,
            itl=metrics.avg_token_time,
            tps=metrics.throughput * self.request_size.avg_output_tokens,
        )
        return SizeResult(
            rate_ttft=lam_ttft * 1000.0,
            rate_itl=lam_itl * 1000.0,
            rate_tps=lam_tps * 1000.0,
            metrics=metrics,
            achieved=achieved,
        )
