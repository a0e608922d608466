"""VariantAutoscaling custom resource types + status conditions.

Python equivalent of the reference CRD
(the Go reference's api/v1alpha1/variantautoscaling_types.go). The spec
references per-slice-shape perf profiles (acceleratorType v5e-1 / v5e-16 /
...); numeric status fields are strings, matching the reference's CRD
validation patterns (variantautoscaling_types.go:96-135), so the same
manifests round-trip.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Optional


def to_rfc3339(ts: float) -> str:
    """Float epoch -> RFC3339 (the CRD declares timestamps as
    format: date-time strings)."""
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def from_rfc3339(v: Any) -> float:
    """Accept RFC3339 strings, numeric epochs, or empty values."""
    if v in (None, ""):
        return 0.0
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).replace("Z", "+00:00")
    return datetime.fromisoformat(s).timestamp()

GROUP = "llmd.ai"
VERSION = "v1alpha1"
KIND = "VariantAutoscaling"
PLURAL = "variantautoscalings"

# Label carrying the variant's current slice shape
# (reference variantautoscaling_controller.go:250).
ACCELERATOR_LABEL = "inference.optimization/acceleratorName"

# Condition types + reasons (reference variantautoscaling_types.go:194-222).
TYPE_METRICS_AVAILABLE = "MetricsAvailable"
TYPE_OPTIMIZATION_READY = "OptimizationReady"
TYPE_PERF_MODEL_ACCURATE = "PerfModelAccurate"

REASON_METRICS_FOUND = "MetricsFound"
REASON_METRICS_MISSING = "MetricsMissing"
REASON_METRICS_STALE = "MetricsStale"
REASON_METRICS_INCOMPLETE = "MetricsIncomplete"
REASON_PROMETHEUS_ERROR = "PrometheusError"
REASON_OPTIMIZATION_SUCCEEDED = "OptimizationSucceeded"
REASON_OPTIMIZATION_FAILED = "OptimizationFailed"
REASON_MODEL_MATCHES = "ModelMatchesObservations"
REASON_PROFILE_DRIFT = "ProfileDrift"
REASON_METRICS_UNAVAILABLE = "MetricsUnavailable"


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    observed_generation: int = 0
    last_transition_time: float = 0.0

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "observedGeneration": self.observed_generation,
            "lastTransitionTime": to_rfc3339(self.last_transition_time),
        }


@dataclass
class ConfigMapKeyRef:
    name: str = ""
    key: str = ""


@dataclass
class PerfParms:
    """String-typed fitted parameters, parsed at reconcile time
    (reference variantautoscaling_types.go:41-50)."""

    decode_parms: dict[str, str] = field(default_factory=dict)   # alpha, beta
    prefill_parms: dict[str, str] = field(default_factory=dict)  # gamma, delta


@dataclass
class ContextProfile:
    """Perf parameters fitted at one average context length (long-context
    support: the engine interpolates between these anchors at the observed
    prompt length)."""

    at_context: int = 0    # avg prompt tokens this anchor was fit at
    perf_parms: PerfParms = field(default_factory=PerfParms)
    max_batch_size: int = 0


@dataclass
class AcceleratorProfile:
    acc: str = ""          # slice shape, e.g. v5e-8
    acc_count: int = 1     # slice units per replica
    perf_parms: PerfParms = field(default_factory=PerfParms)
    max_batch_size: int = 0
    context_profiles: list[ContextProfile] = field(default_factory=list)


@dataclass
class ModelProfile:
    accelerators: list[AcceleratorProfile] = field(default_factory=list)


@dataclass
class VariantAutoscalingSpec:
    model_id: str = ""
    slo_class_ref: ConfigMapKeyRef = field(default_factory=ConfigMapKeyRef)
    model_profile: ModelProfile = field(default_factory=ModelProfile)


@dataclass
class LoadProfile:
    arrival_rate: str = ""       # req/min
    avg_input_tokens: str = ""
    avg_output_tokens: str = ""


@dataclass
class Allocation:
    accelerator: str = ""
    num_replicas: int = 0
    max_batch: int = 0
    variant_cost: str = "0.00"
    itl_average: str = "0.00"
    ttft_average: str = "0.00"
    load: LoadProfile = field(default_factory=LoadProfile)


@dataclass
class OptimizedAlloc:
    last_run_time: float = 0.0
    accelerator: str = ""
    num_replicas: int = 0


@dataclass
class ActuationStatus:
    applied: bool = False


@dataclass
class VariantAutoscalingStatus:
    current_alloc: Allocation = field(default_factory=Allocation)
    desired_optimized_alloc: OptimizedAlloc = field(default_factory=OptimizedAlloc)
    actuation: ActuationStatus = field(default_factory=ActuationStatus)
    conditions: list[Condition] = field(default_factory=list)


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    generation: int = 1
    deletion_timestamp: Optional[float] = None
    owner_references: list[dict] = field(default_factory=list)
    resource_version: str = ""  # opaque; carried through for optimistic concurrency


@dataclass
class VariantAutoscaling:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: VariantAutoscalingSpec = field(default_factory=VariantAutoscalingSpec)
    status: VariantAutoscalingStatus = field(default_factory=VariantAutoscalingStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def is_active(self) -> bool:
        return self.metadata.deletion_timestamp is None

    def is_controlled_by(self, owner_uid: str) -> bool:
        return any(
            ref.get("uid") == owner_uid and ref.get("controller")
            for ref in self.metadata.owner_references
        )


def set_condition(
    va: VariantAutoscaling,
    cond_type: str,
    status: str,
    reason: str,
    message: str,
    now: Optional[float] = None,
) -> None:
    """Upsert a condition by type; the transition time only moves when the
    status actually changes (k8s meta.SetStatusCondition semantics,
    reference api/v1alpha1/conditions.go:9-19)."""
    ts = time.time() if now is None else now
    for cond in va.status.conditions:
        if cond.type == cond_type:
            if cond.status != status:
                cond.last_transition_time = ts
            cond.status = status
            cond.reason = reason
            cond.message = message
            cond.observed_generation = va.metadata.generation
            return
    va.status.conditions.append(
        Condition(
            type=cond_type, status=status, reason=reason, message=message,
            observed_generation=va.metadata.generation, last_transition_time=ts,
        )
    )


def remove_condition(va: VariantAutoscaling, cond_type: str) -> bool:
    """Drop a condition type from the status (meta.RemoveStatusCondition
    semantics); True when one was present. Used when the feature that
    maintains a condition is turned off — a stale verdict must not outlive
    its watchdog."""
    before = len(va.status.conditions)
    va.status.conditions = [
        c for c in va.status.conditions if c.type != cond_type
    ]
    return len(va.status.conditions) != before


def get_condition(va: VariantAutoscaling, cond_type: str) -> Optional[Condition]:
    for cond in va.status.conditions:
        if cond.type == cond_type:
            return cond
    return None


def is_condition_true(va: VariantAutoscaling, cond_type: str) -> bool:
    cond = get_condition(va, cond_type)
    return cond is not None and cond.status == "True"


def is_condition_false(va: VariantAutoscaling, cond_type: str) -> bool:
    cond = get_condition(va, cond_type)
    return cond is not None and cond.status == "False"


# ---------------------------------------------------------------------------
# (De)serialization to k8s-style dicts (REST wire format / YAML manifests)
# ---------------------------------------------------------------------------

def va_to_dict(va: VariantAutoscaling) -> dict[str, Any]:
    metadata: dict[str, Any] = {
        "name": va.metadata.name,
        "namespace": va.metadata.namespace,
        "labels": dict(va.metadata.labels),
        "generation": va.metadata.generation,
        "ownerReferences": list(va.metadata.owner_references),
    }
    if va.metadata.resource_version:
        # makes status PUTs conditional: the API server 409s on a stale
        # resourceVersion instead of silently overwriting a concurrent write
        metadata["resourceVersion"] = va.metadata.resource_version
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": KIND,
        "metadata": metadata,
        "spec": {
            "modelID": va.spec.model_id,
            "sloClassRef": {
                "name": va.spec.slo_class_ref.name,
                "key": va.spec.slo_class_ref.key,
            },
            "modelProfile": {
                "accelerators": [
                    {
                        "acc": ap.acc,
                        "accCount": ap.acc_count,
                        "perfParms": _perf_parms_to_dict(ap.perf_parms),
                        "maxBatchSize": ap.max_batch_size,
                        **(
                            {
                                "contextProfiles": [
                                    {
                                        "atContext": cp.at_context,
                                        "perfParms": _perf_parms_to_dict(cp.perf_parms),
                                        "maxBatchSize": cp.max_batch_size,
                                    }
                                    for cp in ap.context_profiles
                                ]
                            }
                            if ap.context_profiles else {}
                        ),
                    }
                    for ap in va.spec.model_profile.accelerators
                ],
            },
        },
        "status": {
            "currentAlloc": {
                "accelerator": va.status.current_alloc.accelerator,
                "numReplicas": va.status.current_alloc.num_replicas,
                "maxBatch": va.status.current_alloc.max_batch,
                "variantCost": va.status.current_alloc.variant_cost,
                "itlAverage": va.status.current_alloc.itl_average,
                "ttftAverage": va.status.current_alloc.ttft_average,
                "load": {
                    "arrivalRate": va.status.current_alloc.load.arrival_rate,
                    "avgInputTokens": va.status.current_alloc.load.avg_input_tokens,
                    "avgOutputTokens": va.status.current_alloc.load.avg_output_tokens,
                },
            },
            "desiredOptimizedAlloc": {
                "lastRunTime": to_rfc3339(va.status.desired_optimized_alloc.last_run_time),
                "accelerator": va.status.desired_optimized_alloc.accelerator,
                "numReplicas": va.status.desired_optimized_alloc.num_replicas,
            },
            "actuation": {"applied": va.status.actuation.applied},
            "conditions": [c.to_dict() for c in va.status.conditions],
        },
    }


def _perf_parms_to_dict(pp: PerfParms) -> dict[str, Any]:
    return {
        "decodeParms": dict(pp.decode_parms),
        "prefillParms": dict(pp.prefill_parms),
    }


def _perf_parms_from_dict(d: dict[str, Any]) -> PerfParms:
    return PerfParms(
        decode_parms=dict(d.get("decodeParms", {})),
        prefill_parms=dict(d.get("prefillParms", {})),
    )


def va_from_dict(obj: dict[str, Any]) -> VariantAutoscaling:
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    status = obj.get("status", {})
    profile = spec.get("modelProfile", {})
    cur = status.get("currentAlloc", {})
    des = status.get("desiredOptimizedAlloc", {})

    return VariantAutoscaling(
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels", {})),
            generation=meta.get("generation", 1),
            deletion_timestamp=(
                from_rfc3339(meta["deletionTimestamp"])
                if meta.get("deletionTimestamp") is not None else None
            ),
            owner_references=list(meta.get("ownerReferences", [])),
            resource_version=str(meta.get("resourceVersion", "") or ""),
        ),
        spec=VariantAutoscalingSpec(
            model_id=spec.get("modelID", ""),
            slo_class_ref=ConfigMapKeyRef(
                name=spec.get("sloClassRef", {}).get("name", ""),
                key=spec.get("sloClassRef", {}).get("key", ""),
            ),
            model_profile=ModelProfile(
                accelerators=[
                    AcceleratorProfile(
                        acc=ap.get("acc", ""),
                        acc_count=ap.get("accCount", 1),
                        perf_parms=_perf_parms_from_dict(ap.get("perfParms", {})),
                        max_batch_size=ap.get("maxBatchSize", 0),
                        context_profiles=[
                            ContextProfile(
                                at_context=cp.get("atContext", 0),
                                perf_parms=_perf_parms_from_dict(cp.get("perfParms", {})),
                                max_batch_size=cp.get("maxBatchSize", 0),
                            )
                            for cp in ap.get("contextProfiles", [])
                        ],
                    )
                    for ap in profile.get("accelerators", [])
                ],
            ),
        ),
        status=VariantAutoscalingStatus(
            current_alloc=Allocation(
                accelerator=cur.get("accelerator", ""),
                num_replicas=cur.get("numReplicas", 0),
                max_batch=cur.get("maxBatch", 0),
                variant_cost=cur.get("variantCost", "0.00"),
                itl_average=cur.get("itlAverage", "0.00"),
                ttft_average=cur.get("ttftAverage", "0.00"),
                load=LoadProfile(
                    arrival_rate=cur.get("load", {}).get("arrivalRate", ""),
                    avg_input_tokens=cur.get("load", {}).get("avgInputTokens", ""),
                    avg_output_tokens=cur.get("load", {}).get("avgOutputTokens", ""),
                ),
            ),
            desired_optimized_alloc=OptimizedAlloc(
                last_run_time=from_rfc3339(des.get("lastRunTime")),
                accelerator=des.get("accelerator", ""),
                num_replicas=des.get("numReplicas", 0),
            ),
            actuation=ActuationStatus(
                applied=status.get("actuation", {}).get("applied", False)
            ),
            conditions=[
                Condition(
                    type=c.get("type", ""),
                    status=c.get("status", ""),
                    reason=c.get("reason", ""),
                    message=c.get("message", ""),
                    observed_generation=c.get("observedGeneration", 0),
                    last_transition_time=from_rfc3339(c.get("lastTransitionTime")),
                )
                for c in status.get("conditions", [])
            ],
        ),
    )
