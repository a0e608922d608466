"""Data shapes for the autoscaling system (the engine's wire format).

TPU-shaped equivalent of the reference's config specs
(the Go reference's pkg/config/types.go). The accelerator model is a *slice
shape* — a pod slice of a TPU generation — rather than a GPU SKU:
capacity is counted in chips per generation and an allocation consumes
num_replicas * slices_per_replica * chips_per_slice chips (the reference's
replicas x accCount x multiplicity, pkg/core/system.go:296).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace as dc_replace

from ..ops.queueing import MAX_QUEUE_TO_BATCH_RATIO  # noqa: WVL002 — re-exported (models/__init__.py)

# ---------------------------------------------------------------------------
# Engine constants (reference pkg/config/defaults.go)
# ---------------------------------------------------------------------------

SLO_PERCENTILE = 0.95
SLO_MARGIN = -math.log(1 - SLO_PERCENTILE)
ACCEL_PENALTY_FACTOR = 0.1

DEFAULT_SERVICE_CLASS_NAME = "Free"
DEFAULT_LOW_PRIORITY = 100
DEFAULT_HIGH_PRIORITY = 1
DEFAULT_SERVICE_CLASS_PRIORITY = DEFAULT_LOW_PRIORITY


class SaturationPolicy(enum.Enum):
    """Best-effort allocation policy once capacity saturates
    (reference pkg/config/config.go:4-41)."""

    NONE = "None"
    PRIORITY_EXHAUSTIVE = "PriorityExhaustive"
    PRIORITY_ROUND_ROBIN = "PriorityRoundRobin"
    ROUND_ROBIN = "RoundRobin"

    @classmethod
    def parse(cls, s: str) -> "SaturationPolicy":
        for p in cls:
            if p.value == s:
                return p
        return cls.NONE


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PowerSpec:
    """Piecewise-linear power curve per chip (Watts)."""

    idle: float = 0.0
    full: float = 0.0
    mid_power: float = 0.0
    mid_util: float = 0.0


@dataclass(frozen=True)
class AcceleratorSpec:
    """A TPU slice shape offered to the optimizer, e.g. v5e-8 (2x4).

    `chip` names the capacity pool (chips of one generation are fungible
    within a node pool); `chips` is the slice's chip count — the unit an
    allocation multiplies into capacity. `cost` is cents/hr for the whole
    slice unit.
    """

    name: str
    chip: str
    chips: int = 1
    topology: str = ""
    multi_host: bool = False
    mem_gb: float = 0.0
    power: PowerSpec = field(default_factory=PowerSpec)
    cost: float = 0.0


@dataclass(frozen=True)
class ContextBucket:
    """Profile anchor at one average context length: long context is a
    profile *dimension*, not a runtime mechanism — KV growth shows up as
    larger decode/prefill coefficients and a smaller feasible batch at the
    measured context (SURVEY.md section 5 long-context mapping)."""

    context_tokens: int        # avg prompt length this anchor was fit at
    alpha: float
    beta: float
    gamma: float
    delta: float
    max_batch_size: int = 0    # 0: inherit the profile's base bound


@dataclass(frozen=True)
class ModelSliceProfile:
    """Fitted perf of (model x slice shape): decode itl = alpha + beta*b,
    prefill ttft = gamma + delta*tokens*b (msec), plus batch capacity.

    `slices_per_replica` is the number of slice units one model instance
    occupies (reference accCount, pkg/core/model.go:45-54); for multi-host
    serving a replica may span several slice units.

    `context_buckets`, when non-empty, fully describe the context-length
    dependence: the engine linearly interpolates alpha/beta/gamma/delta
    between anchors at the observed average prompt length and takes the
    batch bound from the anchor at-or-above it (see resolve_for_context).
    """

    model: str
    accelerator: str           # slice shape name
    alpha: float
    beta: float
    gamma: float
    delta: float
    max_batch_size: int
    at_tokens: int = 0         # token count at which max_batch_size holds
    slices_per_replica: int = 1
    context_buckets: tuple[ContextBucket, ...] = ()


def resolve_for_context(
    profile: ModelSliceProfile, context_tokens: float
) -> ModelSliceProfile:
    """Effective profile at an observed average prompt length.

    Without buckets this is the identity. With buckets: clamp to the
    anchor range, linearly interpolate the four coefficients between the
    surrounding anchors, and take the batch bound from the anchor at or
    above the context (the conservative side: longer context = less KV
    headroom). The resolved profile carries no further context dependence
    (buckets dropped, at_tokens cleared so the bucket's batch bound is
    used verbatim)."""
    buckets = sorted(profile.context_buckets, key=lambda b: b.context_tokens)
    if not buckets:
        return profile
    c = max(float(context_tokens), 0.0)

    def batch_of(b: ContextBucket) -> int:
        return b.max_batch_size or profile.max_batch_size

    if c <= buckets[0].context_tokens:
        lo = hi = buckets[0]
        w = 0.0
    elif c >= buckets[-1].context_tokens:
        lo = hi = buckets[-1]
        w = 0.0
    else:
        for lo, hi in zip(buckets, buckets[1:]):
            if lo.context_tokens <= c <= hi.context_tokens:
                break
        w = (c - lo.context_tokens) / (hi.context_tokens - lo.context_tokens)

    lerp = lambda a, b: a + (b - a) * w
    return dc_replace(
        profile,
        alpha=lerp(lo.alpha, hi.alpha),
        beta=lerp(lo.beta, hi.beta),
        gamma=lerp(lo.gamma, hi.gamma),
        delta=lerp(lo.delta, hi.delta),
        max_batch_size=batch_of(hi),
        at_tokens=0,
        context_buckets=(),
    )


@dataclass(frozen=True)
class ModelTarget:
    model: str
    slo_itl: float = 0.0   # msec
    slo_ttft: float = 0.0  # msec (queueing + prefill)
    slo_tps: float = 0.0   # tokens/sec
    # Hold slo_ttft at this PERCENTILE of the TTFT distribution instead of
    # its mean (ops.batched.size_batch_tail); 0 = mean sizing, or the
    # global WVA_TTFT_PERCENTILE when that is set. Lets a Premium class
    # buy a p95 guarantee while Freemium sizes on the mean.
    slo_ttft_percentile: float = 0.0


@dataclass(frozen=True)
class ServiceClassSpec:
    name: str
    priority: int = DEFAULT_SERVICE_CLASS_PRIORITY
    model_targets: tuple[ModelTarget, ...] = ()


@dataclass(frozen=True)
class ServerLoadSpec:
    arrival_rate: float = 0.0   # req/min
    avg_in_tokens: int = 0
    avg_out_tokens: int = 0


@dataclass(frozen=True)
class AllocationData:
    """Serializable allocation (reference pkg/config/types.go:118-131)."""

    accelerator: str = ""
    num_replicas: int = 0
    max_batch: int = 0
    cost: float = 0.0
    itl_average: float = 0.0
    ttft_average: float = 0.0
    load: ServerLoadSpec = field(default_factory=ServerLoadSpec)


@dataclass(frozen=True)
class ServerSpec:
    """A variant server: one (service class, model) deployment."""

    name: str
    service_class: str = ""
    model: str = ""
    keep_accelerator: bool = False
    min_num_replicas: int = 0
    max_batch_size: int = 0  # 0 = derive from profile
    current_alloc: AllocationData = field(default_factory=AllocationData)
    desired_alloc: AllocationData = field(default_factory=AllocationData)


@dataclass(frozen=True)
class OptimizerSpec:
    unlimited: bool = True
    delayed_best_effort: bool = False
    saturation_policy: str = SaturationPolicy.NONE.value


@dataclass
class SystemSpec:
    """Everything the engine needs for one optimization cycle."""

    accelerators: list[AcceleratorSpec] = field(default_factory=list)
    profiles: list[ModelSliceProfile] = field(default_factory=list)
    service_classes: list[ServiceClassSpec] = field(default_factory=list)
    servers: list[ServerSpec] = field(default_factory=list)
    capacity: dict[str, int] = field(default_factory=dict)  # chip -> chip count
    optimizer: OptimizerSpec = field(default_factory=OptimizerSpec)


@dataclass(frozen=True)
class AllocationSolution:
    """Solver output: server name -> allocation data."""

    allocations: dict[str, AllocationData] = field(default_factory=dict)


def with_load(data: AllocationData, load: ServerLoadSpec) -> AllocationData:
    return dc_replace(data, load=load)


def spec_from_reference(d: dict) -> SystemSpec:
    """This package's SystemSpec from `dataclasses.asdict` of the
    reference package's SystemSpec: the whole fleet state carried across
    field for field, so both packages can be given the same fleet."""
    def accelerator(a: dict) -> AcceleratorSpec:
        return AcceleratorSpec(**{**a, "power": PowerSpec(**a["power"])})

    def profile(p: dict) -> ModelSliceProfile:
        return ModelSliceProfile(**{**p, "context_buckets": tuple(
            ContextBucket(**b) for b in p.get("context_buckets", ()))})

    def service_class(c: dict) -> ServiceClassSpec:
        return ServiceClassSpec(**{**c, "model_targets": tuple(
            ModelTarget(**t) for t in c.get("model_targets", ()))})

    def alloc(a: dict) -> AllocationData:
        return AllocationData(**{**a, "load": ServerLoadSpec(**a["load"])})

    def server(s: dict) -> ServerSpec:
        return ServerSpec(**{**s, "current_alloc": alloc(s["current_alloc"]),
                             "desired_alloc": alloc(s["desired_alloc"])})

    return SystemSpec(
        accelerators=[accelerator(a) for a in d.get("accelerators", ())],
        profiles=[profile(p) for p in d.get("profiles", ())],
        service_classes=[service_class(c)
                         for c in d.get("service_classes", ())],
        servers=[server(s) for s in d.get("servers", ())],
        capacity=dict(d.get("capacity", {})),
        optimizer=OptimizerSpec(**d.get("optimizer", {})),
    )
