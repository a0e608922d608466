"""State-dependent M/M/1 queue with finite occupancy, numpy float64.

This is the analytical heart of the autoscaler: a single-server Markovian
queue whose service rate depends on the number of requests in service
(continuous batching), truncated at an occupancy bound K. Semantics mirror
the reference models (the Go reference's pkg/analyzer/mm1kmodel.go,
mm1modelstatedependent.go) but the probability recursion is computed in
log-space: log p[n] = n*log(lambda) - sum_{k<n} log(mu_k), normalised with
logsumexp. That removes the reference's overflow-rescaling loop
(mm1modelstatedependent.go:78-104) and is the same formulation the batched
TPU kernel uses, so the two paths agree to float rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Small disturbance used to bound the stable rate range
# (reference queueanalyzer.go:8).
EPSILON = 1e-3

# Fraction below the max service throughput used for TPS sizing
# (reference queueanalyzer.go:11).
STABILITY_SAFETY_FRACTION = 0.1

# Maximum queue occupancy as a multiple of the max batch size — the single
# source of truth for the K = N * (1 + ratio) bound used by both kernel
# backends and the domain model (reference pkg/config/defaults.go:18).
MAX_QUEUE_TO_BATCH_RATIO = 10


@dataclass(frozen=True)
class QueueStats:
    """Steady-state statistics of the queue at a given arrival rate.

    Rates are per millisecond, times in milliseconds (matching the
    reference's internal units, queueanalyzer.go:134-174).
    """

    lam: float                 # arrival rate (req/msec)
    rho: float                 # utilisation: 1 - p[0]
    throughput: float          # effective departure rate lam*(1-p[K]) (req/msec)
    avg_num_in_system: float   # E[N]
    avg_num_in_servers: float  # E[min(N, num_service_states)]
    avg_resp_time: float       # T = E[N]/X (msec)
    avg_serv_time: float       # S = E[Nserv]/X (msec)
    avg_wait_time: float       # W = max(T - S, 0) (msec)
    avg_queue_length: float    # X * W
    probabilities: np.ndarray  # state probabilities p[0..K]


def state_dependent_probabilities(lam: float, serv_rate: np.ndarray, K: int) -> np.ndarray:
    """Steady-state distribution p[0..K] for state-dependent service rates.

    serv_rate[i] is the total service rate with i+1 requests in service;
    states beyond len(serv_rate) keep the last rate (reference
    mm1modelstatedependent.go:74-86). Computed in log-space.
    """
    serv_rate = np.asarray(serv_rate, dtype=np.float64)
    num = serv_rate.shape[0]
    # mu[n] is the service rate governing the n -> n+1 balance, n = 0..K-1
    idx = np.minimum(np.arange(K), num - 1)
    mu = serv_rate[idx]
    if lam <= 0.0:
        p = np.zeros(K + 1)
        p[0] = 1.0
        return p
    log_ratio = np.log(lam) - np.log(mu)
    logp = np.concatenate([[0.0], np.cumsum(log_ratio)])
    logp -= logp.max()
    p = np.exp(logp)
    return p / p.sum()


def state_dependent_solve(lam: float, serv_rate: np.ndarray, K: int) -> QueueStats:
    """Solve the queue and derive statistics (reference
    mm1modelstatedependent.go:38-67).
    """
    serv_rate = np.asarray(serv_rate, dtype=np.float64)
    num = serv_rate.shape[0]
    p = state_dependent_probabilities(lam, serv_rate, K)
    n = np.arange(K + 1, dtype=np.float64)

    avg_num_in_system = float(np.dot(n, p))
    # E[number in service]: occupancy capped at `num` concurrent slots
    # (reference mm1modelstatedependent.go:45-57).
    m = min(num, K)
    avg_num_in_servers = float(np.dot(n[: m + 1], p[: m + 1]) + (1.0 - p[: m + 1].sum()) * num)

    throughput = lam * (1.0 - float(p[K]))
    if throughput > 0.0:
        avg_resp_time = avg_num_in_system / throughput
        avg_serv_time = avg_num_in_servers / throughput
    else:
        avg_resp_time = 0.0
        avg_serv_time = 0.0
    avg_wait_time = max(avg_resp_time - avg_serv_time, 0.0)
    avg_queue_length = throughput * avg_wait_time
    rho = 1.0 - float(p[0])

    return QueueStats(
        lam=lam,
        rho=rho,
        throughput=throughput,
        avg_num_in_system=avg_num_in_system,
        avg_num_in_servers=avg_num_in_servers,
        avg_resp_time=avg_resp_time,
        avg_serv_time=avg_serv_time,
        avg_wait_time=avg_wait_time,
        avg_queue_length=avg_queue_length,
        probabilities=p,
    )


def mm1k_closed_form(lam: float, mu: float, K: int) -> QueueStats:
    """Classic M/M/1/K closed form, used to validate the state-dependent
    solver (with constant serv_rate the two must agree). Reference:
    mm1kmodel.go:51-95.
    """
    rho = 1.0 if lam == mu else lam / mu
    if rho == 1.0:
        p = np.full(K + 1, 1.0 / (K + 1))
    else:
        p0 = (1.0 - rho) / (1.0 - rho ** (K + 1))
        p = p0 * rho ** np.arange(K + 1, dtype=np.float64)
    n = np.arange(K + 1, dtype=np.float64)
    avg_num_in_system = float(np.dot(n, p))
    throughput = lam * (1.0 - float(p[K]))
    avg_resp_time = avg_num_in_system / throughput if throughput > 0 else 0.0
    avg_serv_time = 1.0 / mu
    avg_wait_time = max(avg_resp_time - avg_serv_time, 0.0)
    return QueueStats(
        lam=lam,
        rho=rho,
        throughput=throughput,
        avg_num_in_system=avg_num_in_system,
        avg_num_in_servers=throughput * avg_serv_time,
        avg_resp_time=avg_resp_time,
        avg_serv_time=avg_serv_time,
        avg_wait_time=avg_wait_time,
        avg_queue_length=throughput * avg_wait_time,
        probabilities=p,
    )
