"""Allocation: a feasible (slice shape, replicas, batch) assignment.

Counterpart of the reference package's `models/allocation.py` (the Go
reference's pkg/core/allocation.go). `create_allocation` builds an
SLO-feasible allocation for one server on one slice shape on the host
(the scalar backend, `System.calculate(backend="scalar")`, and the
per-candidate specification); the device backends size every candidate
of a group in one decision instead.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ..ops.analyzer import (
    InfeasibleTargetError,
    QueueAnalyzer,
    QueueConfig,
    RequestSize,
    ServiceParms,
    TargetPerf,
)
from .spec import (
    ACCEL_PENALTY_FACTOR,
    MAX_QUEUE_TO_BATCH_RATIO,
    AllocationData,
    ModelSliceProfile,
    ServerLoadSpec,
    resolve_for_context,
)

if TYPE_CHECKING:
    from .system import System


def _analyzer_class():
    """The scalar path's analyzer: the native host library whenever it
    builds (ops/native.py, exact parity with the numpy analyzer), since
    this path is per-candidate host work where it always wins; only an
    explicit WVA_NATIVE_KERNEL=false keeps the numpy analyzer."""
    if os.environ.get("WVA_NATIVE_KERNEL", "").strip().lower() not in (
            "0", "false"):
        from ..ops import native

        if native.available():
            return native.NativeQueueAnalyzer
    return QueueAnalyzer


@dataclass
class Allocation:
    accelerator: str = ""
    num_replicas: int = 0
    batch_size: int = 0
    cost: float = 0.0
    value: float = 0.0
    itl: float = 0.0   # expected avg token decode time (msec)
    ttft: float = 0.0  # expected avg queueing + prefill time (msec)
    rho: float = 0.0
    max_arrv_rate_per_replica: float = 0.0  # req/msec

    @property
    def max_rpm(self) -> float:
        """Max sustainable request rate per replica, req/min."""
        return self.max_arrv_rate_per_replica * 1000.0 * 60.0

    def saturated(self, total_rate_rpm: float) -> bool:
        return total_rate_rpm > self.num_replicas * self.max_rpm

    def transition_penalty(self, other: "Allocation") -> float:
        """Cost of moving this allocation to `other`: free if identical,
        cost delta on a pure rescale, plus a switching surcharge of
        ACCEL_PENALTY_FACTOR*(cost_a+cost_b) when the slice shape
        changes."""
        if self.accelerator == other.accelerator:
            if self.num_replicas == other.num_replicas:
                return 0.0
            return other.cost - self.cost
        return ACCEL_PENALTY_FACTOR * (self.cost + other.cost) + (other.cost - self.cost)

    def clone(self) -> "Allocation":
        return Allocation(**self.__dict__)

    def to_data(self, load: ServerLoadSpec | None = None) -> AllocationData:
        return AllocationData(
            accelerator=self.accelerator,
            num_replicas=self.num_replicas,
            max_batch=self.batch_size,
            cost=self.cost,
            itl_average=self.itl,
            ttft_average=self.ttft,
            load=load or ServerLoadSpec(),
        )

    @classmethod
    def from_data(cls, data: AllocationData) -> "Allocation":
        return cls(
            accelerator=data.accelerator,
            num_replicas=data.num_replicas,
            batch_size=data.max_batch,
            cost=data.cost,
            itl=data.itl_average,
            ttft=data.ttft_average,
        )


@dataclass(frozen=True)
class AllocationDiff:
    """Orchestration delta between old and new allocations."""

    old_accelerator: str = "none"
    new_accelerator: str = "none"
    old_num_replicas: int = 0
    new_num_replicas: int = 0
    cost_diff: float = 0.0


def allocation_diff(a: Optional[Allocation], b: Optional[Allocation]) -> Optional[AllocationDiff]:
    if a is None and b is None:
        return None
    return AllocationDiff(
        old_accelerator=a.accelerator if a else "none",
        new_accelerator=b.accelerator if b else "none",
        old_num_replicas=a.num_replicas if a else 0,
        new_num_replicas=b.num_replicas if b else 0,
        cost_diff=(b.cost if b else 0.0) - (a.cost if a else 0.0),
    )


def effective_batch_size(profile: ModelSliceProfile, server_max_batch: int, out_tokens: int) -> int:
    """Max batch N: the server override, or the profile's max batch scaled
    by token length (longer requests shrink the usable batch). A profile
    without an at_tokens anchor uses its batch bound verbatim."""
    if server_max_batch > 0:
        return server_max_batch
    if profile.at_tokens <= 0:
        return max(profile.max_batch_size, 1)
    return max(profile.max_batch_size * profile.at_tokens // max(out_tokens, 1), 1)


def replica_demand(arrival_rate_rpm: float, slo_tps: float, out_tokens: int) -> float:
    """Aggregate rate to provision for, req/sec: the observed arrival rate,
    or the TPS target translated to request rate when one is set."""
    if slo_tps > 0:
        return slo_tps / max(out_tokens, 1)
    return arrival_rate_rpm / 60.0


def zero_load_allocation(
    system: "System", server_name: str, acc_name: str
) -> Optional[Allocation]:
    """Allocation when there is no traffic: min replicas at the profile's
    batch bound."""
    server = system.server(server_name)
    acc = system.accelerator(acc_name)
    if server is None or acc is None:
        return None
    model = system.model(server.model_name)
    profile = model.profile(acc_name) if model else None
    if profile is None:
        return None
    # resolve at the observed context so the published batch bound and
    # max rate stay consistent with the sized paths
    profile = resolve_for_context(
        profile, server.load.avg_in_tokens if server.load else 0
    )

    if server.min_num_replicas == 0:
        # scale to zero: keep the slice name so the emitted series retains
        # its accelerator_type label across the 0-replica phase
        return Allocation(accelerator=acc_name)

    max_batch = server.max_batch_size or profile.max_batch_size
    num_replicas = server.min_num_replicas
    cost = acc.cost * model.num_instances(acc_name) * num_replicas

    decode = profile.alpha + profile.beta
    max_decode = profile.alpha + profile.beta * max_batch
    prefill = profile.gamma + profile.delta
    max_serv = prefill + max_decode
    alloc = Allocation(
        accelerator=acc_name,
        num_replicas=num_replicas,
        batch_size=max_batch,
        cost=cost,
        itl=decode,
        ttft=prefill,
        rho=0.0,
        max_arrv_rate_per_replica=max_batch / max_serv,
    )
    alloc.value = alloc.cost
    return alloc


def create_allocation(system: "System", server_name: str, acc_name: str,
                      ttft_percentile: Optional[float] = None) -> Optional[Allocation]:
    """Scalar-path allocation construction (the Go reference's
    allocation.go:27-163).

    Returns None when the candidate is infeasible: missing profile/target,
    invalid load, or SLO below the achievable region.

    ttft_percentile: the GLOBAL percentile knob; the service class's own
    slo-ttft-percentile overrides it (the effective-percentile rule of
    System's sizing groups).
    """
    acc = system.accelerator(acc_name)
    server = system.server(server_name)
    if acc is None or server is None:
        return None
    load = server.load
    if load is None or load.arrival_rate < 0 or load.avg_in_tokens < 0 or load.avg_out_tokens < 0:
        return None
    model = system.model(server.model_name)
    if model is None:
        return None
    profile = model.profile(acc_name)
    if profile is None:
        return None
    # long context is a profile dimension: pick the coefficients fitted at
    # the observed average prompt length
    profile = resolve_for_context(profile, load.avg_in_tokens)
    svc = system.service_class(server.service_class_name)
    if svc is None:
        return None
    target = svc.target(server.model_name)
    if target is None:
        return None

    if load.arrival_rate == 0 or load.avg_out_tokens == 0:
        return zero_load_allocation(system, server_name, acc_name)

    out_tokens = load.avg_out_tokens
    n = effective_batch_size(profile, server.max_batch_size, out_tokens)

    try:
        analyzer = _analyzer_class()(
            QueueConfig(
                max_batch_size=n,
                max_queue_size=n * MAX_QUEUE_TO_BATCH_RATIO,
                parms=ServiceParms(
                    alpha=profile.alpha, beta=profile.beta,
                    gamma=profile.gamma, delta=profile.delta,
                ),
            ),
            RequestSize(avg_input_tokens=load.avg_in_tokens, avg_output_tokens=out_tokens),
        )
        effective_pct = target.slo_ttft_percentile or ttft_percentile
        sized = analyzer.size(
            TargetPerf(ttft=target.slo_ttft, itl=target.slo_itl, tps=target.slo_tps),
            ttft_percentile=effective_pct or None,
        )
    except (ValueError, InfeasibleTargetError):
        return None

    rate_star = sized.metrics.throughput  # req/sec per replica at the SLO
    total_rate = replica_demand(load.arrival_rate, target.slo_tps, out_tokens)
    num_replicas = max(math.ceil(total_rate / rate_star), server.min_num_replicas)

    cost = acc.cost * model.num_instances(acc_name) * num_replicas

    try:
        per_replica = analyzer.analyze(total_rate / num_replicas)
    except ValueError:
        return None

    alloc = Allocation(
        accelerator=acc_name,
        num_replicas=num_replicas,
        batch_size=n,
        cost=cost,
        itl=per_replica.avg_token_time,
        ttft=per_replica.avg_wait_time + per_replica.avg_prefill_time,
        rho=per_replica.rho,
        max_arrv_rate_per_replica=rate_star / 1000.0,
    )
    alloc.value = alloc.cost
    return alloc


def scale_allocation(
    system: "System", alloc: Allocation, server_name: str,
    ttft_percentile: Optional[float] = None,
) -> tuple[Optional[Allocation], int]:
    """Recompute this server's allocation on the same slice shape; returns
    (new allocation, replica delta). The Go reference's
    allocation.go:166-189, with its nil-deref on an infeasible recompute
    fixed. The global ttft_percentile knob is threaded through, or a
    percentile-sized allocation would be recomputed on the laxer mean."""
    new = create_allocation(system, server_name, alloc.accelerator,
                            ttft_percentile=ttft_percentile)
    if new is None:
        return None, 0
    return new, new.num_replicas - alloc.num_replicas


def reallocate(
    system: "System", server_name: str,
    ttft_percentile: Optional[float] = None,
) -> tuple[Optional[Allocation], str]:
    """Pick the min-value allocation across all slice shapes (the Go
    reference's allocation.go:191-207)."""
    best: Optional[Allocation] = None
    for acc_name in system.accelerators:
        alloc = create_allocation(system, server_name, acc_name,
                                  ttft_percentile=ttft_percentile)
        if alloc is not None and (best is None or alloc.value < best.value):
            best = alloc
    if best is None:
        return None, ""
    return best, best.accelerator
